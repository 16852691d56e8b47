"""The committed fixture the measurement entry points run on: the shipped
settings (`example/linemod_settings.yml`), the model and its properties,
the committed color and dual-modality banks, and the benchmark frame
(`example/benchmark/img0.png`, `depth0.png`) with its ground-truth pose.

A committed bank that is missing raises: the tools never generate one.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..config import CameraParameters, ModelProperties, TemplateSettings, load_model_properties, load_settings
from ..models.template_bank import TemplateBank
from ..pipeline.sensors import read_image

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLE = os.path.join(REPO, "example")
MODEL = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
COLOR_BANK = os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")
DUAL_BANK = os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")
IMG0 = os.path.join(EXAMPLE, "benchmark", "img0.png")
DEPTH0 = os.path.join(EXAMPLE, "benchmark", "depth0.png")
POSE0 = os.path.join(EXAMPLE, "benchmark", "pose0.yml")
# where the tools write: nothing at the root of the repo (gitignored)
OUT = os.path.join(REPO, "build", "bench")


def load_bank(path: str) -> TemplateBank:
    """A committed bank; raises FileNotFoundError naming it where it (or its
    json sidecar) is missing."""
    for p in (path, path + ".json"):
        if not os.path.exists(p):
            raise FileNotFoundError(f"committed bank file {p} is missing (the tools never generate a bank)")
    return TemplateBank.load(path)


@dataclasses.dataclass
class Fixture:
    cam: CameraParameters
    settings: TemplateSettings
    props: ModelProperties
    bank: TemplateBank
    color: np.ndarray  # [480, 640, 3] uint8 BGR
    depth: np.ndarray  # [480, 640] uint16 mm

    @property
    def dual_settings(self) -> TemplateSettings:
        return dataclasses.replace(self.settings, only_color_modality=False)

    @property
    def icp_settings(self) -> TemplateSettings:
        return dataclasses.replace(self.settings, use_icp=True)


def load_fixture() -> Fixture:
    """The shipped settings, the committed color bank and the benchmark
    frame read through pipeline/sensors.read_image (cv2.imread's modes)."""
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    return Fixture(
        cam=cam, settings=settings, props=load_model_properties(MODEL), bank=load_bank(COLOR_BANK),
        color=read_image(IMG0, "color"), depth=read_image(DEPTH0, "anydepth"),
    )
