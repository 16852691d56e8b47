"""Offline template generation over a model folder (counterpart of
`linemod_tpu/pipeline/template_generator.py`).

Generates one TemplateBank per model file of the configured folder on the
given device and saves it under `out_dir` as `<model>.npz` (with its
`.json` sidecar). A bank that already exists is loaded instead, so an
interrupted run resumes where it stopped.
"""

from __future__ import annotations

import os
import sys
import time

from ..config import CameraParameters, TemplateSettings, files_in_directory, load_model_properties
from ..models.template_bank import TemplateBank, build_template_bank
from ..utils.mesh_io import load_mesh


class TemplateGenerator:
    def __init__(self, cam: CameraParameters, settings: TemplateSettings, out_dir: str, device):
        self.cam = cam
        self.settings = settings
        self.out_dir = out_dir
        self.device = device

    def bank_path(self, model_file: str) -> str:
        return os.path.join(self.out_dir, os.path.splitext(model_file)[0] + ".npz")

    def run(self, verbose: bool = True) -> list:
        """Generate (or load) the bank of every model in the folder, in the
        folder's sorted order."""
        os.makedirs(self.out_dir, exist_ok=True)
        models = files_in_directory(self.settings.model_folder, self.settings.model_file_ending)
        n_radii = len(self.settings.radii)
        banks = []
        for model_file in models:
            path = self.bank_path(model_file)
            if os.path.exists(path):
                if verbose:
                    print(f"[generate] {model_file}: bank exists, skipping")
                banks.append(TemplateBank.load(path))
                continue
            t0 = time.time()
            model_path = os.path.join(self.settings.model_folder, model_file)

            def progress(radius, count):
                if verbose:
                    done = (radius - self.settings.distance_start) // self.settings.distance_step + 1
                    pct = int(100 * done / n_radii)
                    bar = "=" * (pct // 2) + ">"
                    sys.stdout.write(
                        f"\r[{bar:<51}] {pct:3d}% {model_file} ({count} templates, "
                        f"{time.time() - t0:.0f}s)"
                    )
                    sys.stdout.flush()

            bank = build_template_bank(
                load_mesh(model_path), model_file, self.cam, self.settings,
                load_model_properties(model_path), self.device, progress=progress,
            )
            bank.save(path)
            if verbose:
                print(
                    f"\n[generate] {model_file}: {bank.num_templates} templates "
                    f"in {time.time() - t0:.1f}s -> {path}"
                )
            banks.append(bank)
        return banks
