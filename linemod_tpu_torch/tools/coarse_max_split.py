"""Where the masked-max kernel's time goes, on one NVIDIA GPU.

    python -m linemod_tpu_torch.tools.coarse_max_split

Builds `csrc/similarity.cu` three ways with nvcc (all at once): as it is,
with the feature loop cut out (only the stage: plane rectangles copied into
shared memory, chunk by chunk), and with the copies cut out (only the
shared-memory adds, on whatever the buffer holds). Times the three
`coarse_max` kernels at the fixture's coarse planes with the 96,300-template
bank (the fixture bank and make_synthetic_bank(94350, seed=7, bbox_wh=64),
96,512 padded), in turns, CUDA-event medians of 20, and prints them with the
card's name and power limit, the plan's staged bytes and the stage's rate.
The full kernel's result must equal coarse_max_plain's. Exits 1 without a
card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import load_model_properties, load_settings
from ..models.template_bank import TemplateBank, concat_banks, make_synthetic_bank
from ..ops import cuda_lib
from ..ops import similarity_cuda as sc
from ..ops.extract import downsample2
from ..ops.matching import _planes_3d
from ..pipeline.pose_detection import PoseDetection
from ..utils.png import read_png

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(cuda_lib.CSRC)), "example")
# (what is cut, the source line, its replacement)
CUTS = {
    "stage only": ("for (int b = fb[s]; b < fe[s]; b += kFlush) {",
                   "for (int b = fb[s]; b < fb[s]; b += kFlush) {"),
    "adds only": ("const int plane_rows = min(chunk_planes, n_planes - p0) * stage_rows;",
                  "const int plane_rows = 0;"),
}
REPS = 20


def build_variants() -> dict:
    """name -> ctypes library: the kernel as it is and with each cut."""
    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cut in {"whole": None, **CUTS}.items():
        text = src
        if cut is not None:
            if cut[0] not in text:
                raise RuntimeError(f"the kernel no longer has the line to cut for {name!r}")
            text = text.replace(cut[0], cut[1])
        base = os.path.join(out_dir, name.replace(" ", "_"))
        with open(base + ".cu", "w") as f:
            f.write(text)
        procs[name] = (base + ".so", subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", base + ".so", base + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
        lib = ctypes.CDLL(path)
        lib.coarse_max.argtypes = sc._SIGNATURES["coarse_max"]
        lib.coarse_max.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("coarse_max_split: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    bank, _ = concat_banks([
        TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")),
        make_synthetic_bank(94350, seed=7, bbox_wh=64, image_wh=(640, 480)),
    ])
    det = PoseDetection(bank, cam, settings, props, dev)
    st, plan = det.state, det.state.coarse_plan
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"))
    colorf = torch.from_numpy(det.recenter(np.ascontiguousarray(color))).to(dev).float()
    planes = _planes_3d(downsample2(colorf), st.cfg.t_coarse, st.max_cells_coarse)
    ch, cw = st.coarse_shape[:2]
    n, f = st.off3_coarse.shape[:2]

    def launch(name):
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        err = libs[name].coarse_max(
            planes.data_ptr(), planes.shape[1], planes.shape[2], plan.feat.data_ptr(),
            plan.starts.data_ptr(), st.lim_coarse.data_ptr(), n, f, ch, cw,
            sc._GEOMETRY(*plan.geometry), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        cuda_lib.check_launch(name, err)
        return out

    want = sc.coarse_max_plain(planes, st.off3_coarse, st.lim_coarse, ch, cw)
    if not torch.equal(launch("whole"), want):
        raise SystemExit("coarse_max_split: the whole kernel differs from coarse_max_plain")
    order = list(libs) + list(reversed(list(libs)))
    times = {name: [] for name in libs}
    for name in order:
        times[name].append(median_ms(lambda name=name: launch(name)))
    group, staged = plan.staged_bytes()
    # each staged row is read as 16-byte loads, which L2 serves as 32-byte sectors
    row_bytes = -(-16 * -(-plan.pitch // 4) // 32) * 32
    sectors = staged // (4 * plan.pitch) * row_bytes
    print(card)
    print(f"coarse_max at planes {tuple(planes.shape)} x {n} templates: {plan.chunks} chunks of "
          f"{plan.chunk_planes} planes, {group} B staged a group, {staged} B in all "
          f"({sectors} B of 32-byte sectors)")
    for name, ms in times.items():
        print(f"  {name}: {ms[0]:.4f} / {ms[1]:.4f} ms (median of {REPS}, first / second turn)")
    stage_ms = min(times["stage only"])
    print(f"  stage rate: {staged / stage_ms / 1e9:.3f} TB/s staged, {sectors / stage_ms / 1e9:.3f} TB/s of sectors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
