"""The fine refine's (2.2, `fine_scores`) time at its shapes, on one NVIDIA GPU.

    python -m linemod_tpu_torch.tools.fine_time [--parent PATH]

The shapes (`fine_cases`, also checked by chip_smoke.py and the `cuda`
tests):

- fixture: the fixture frame's fine planes [33, 304, 384] with its 1,950
  bank (2,048 padded) and the K=512 candidates the frame's cut gives, F=64,
  window 8 (the main path);
- 1280x960: a random 1280x960 frame with 2,048 synthetic templates
  (coarse_max_split.synthetic_1280) and 512 random candidates;
- dual, synthetic: the dual-modality shape, t_fine=5: planes [401, rows,
  stride] of random responses (the last all zero) with rows and stride from
  linear_plane_shape(480, 640, 5, max_cells) at the fixture bank's boxes,
  F=128 (64 color features on planes 0..199, 64 normal ones on 200..399, a
  tenth of them invalid, on the zero plane), window 4, K=512 candidates at
  origins (g * 16) // 5 of random coarse cells;
- K=2,048: the fixture's fine planes with 2,048 random candidates of the
  1,950 bank (top_k at 4 classes).

For each: the kernel (at 1, 2, 4 and 8 warps a block, and with
twice or half the slices of `fine_layout` where the kernel is built for
that layout) against
fine_scores_plain exactly, the work's bound inputs (`fine_work`), and times
from `tools.timing` (event ms, 50 launches queued behind a sleep, and
profiler device ms) with the card's name and power limit, in turns. With
`--parent PATH` (the `similarity.cu` of an older commit, whose C entry
`fine_scores` takes neither the plane count nor the warps a block:
one block a candidate, one thread a window cell) it also builds that
source and times it against the current kernel in turns (old, new, new,
old). It also builds the kernel with its plane-row loads made
`__ldcg` (cached in L2 only: `VARIANTS`) and times it beside the kernel,
which shows what the L1 saves. `fine_edge_cases` holds the edge cases
chip_smoke.py and the `cuda` tests check. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops import similarity_cuda as sc
from ..ops.matching import _planes_3d, candidate_cut, coarse_similarity
from ..ops.spread import linear_plane_shape
from .coarse_max_split import compile_texts, fixture_states, in_turns, show, synthetic_1280

# an older commit's C entry: (planes, rows, stride, off3, f, cand_t,
# base_yx, k, win, out, stream)
_PARENT_FINE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
K = 512
# (what changes, the kernel's source line, its replacement)
VARIANTS = {
    "rows through L2 only (__ldcg)": ("w[i] = __ldg(words + min((at >> 2) - ((at & 3) <= slack), last_word));",
                                      "w[i] = __ldcg(words + min((at >> 2) - ((at & 3) <= slack), last_word));"),
}


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev) for a in arrays]


def fixture_fine(dev):
    """(the fixture's match state, the frame's fine and coarse planes, the
    bank's largest box side in px)."""
    det, _, coarse, _, colorf = fixture_states(dev, big=False)
    fine = _planes_3d(colorf, det.state.cfg.t_fine, det.state.max_cells_fine)
    return det.state, fine, coarse, int(det.bank.bbox[:, 2:4].max())


def random_candidates(state, k: int, seed: int, n_real=None):
    """(cand_t, base_yx) host arrays: k random templates of the first n_real
    (all by default), each at a random coarse cell where it fits, at the
    fine origins (g * 2 * t_coarse) // t_fine."""
    cfg = state.cfg
    lim = state.lim_coarse.cpu().numpy()
    rng = np.random.default_rng(seed)
    t = rng.integers(0, n_real or state.n_templates, k)
    gy = rng.integers(0, 1 << 20, k) % lim[t, 0]
    gx = rng.integers(0, 1 << 20, k) % lim[t, 1]
    span = 2 * cfg.t_coarse
    return t, np.stack([gy * span // cfg.t_fine, gx * span // cfg.t_fine], 1)


def dual_synthetic(dev, box: int, k: int = K, n: int = 2048, seed: int = 5):
    """The dual shape's (planes, off3, cand_t, base_yx, win): t_fine=5,
    t_coarse=8 at 640x480 (see the module's note)."""
    t_fine, t_coarse, ch, cw = 5, 8, 30, 40
    max_cells = -(-box // t_fine) + 1
    _, _, rows, stride = linear_plane_shape(480, 640, t_fine, max_cells)
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 5, (401, rows, stride), dtype=np.uint8)
    planes[-1] = 0
    per = 8 * t_fine * t_fine
    p = np.concatenate([rng.integers(0, per, (n, 64)), rng.integers(per, 2 * per, (n, 64))], 1)
    off3 = np.stack([p, rng.integers(0, max_cells, (n, 128)), rng.integers(0, max_cells, (n, 128))], -1)
    off3[rng.random((n, 128)) < 0.1] = (2 * per, 0, 0)
    span = 2 * t_coarse
    base = np.stack([rng.integers(0, ch, k) * span // t_fine, rng.integers(0, cw, k) * span // t_fine], 1)
    off3, cand_t, base = _to(dev, off3, rng.integers(0, n, k), base)
    return torch.from_numpy(planes).to(dev), off3, cand_t, base, -(-span // t_fine)


def fine_cases(dev, state, fine_planes, coarse_planes, box, syn, syn_color) -> dict:
    """label -> (planes, off3, cand_t, base_yx, win) at the four shapes of
    the module's note; state and its planes are the fixture's, syn and
    syn_color synthetic_1280's."""
    cfg = state.cfg
    win = -(-2 * cfg.t_coarse // cfg.t_fine)
    ch, cw = state.coarse_shape[:2]
    _, cand_t, gy, gx = candidate_cut(coarse_similarity(state, coarse_planes), cw, cfg.top_k)
    span = 2 * cfg.t_coarse
    fixture = (cand_t.int(), torch.stack([gy * span // cfg.t_fine, gx * span // cfg.t_fine], 1).int())
    syn_fine = _planes_3d(syn_color, syn.cfg.t_fine, syn.max_cells_fine)
    n_real = 1950 if state.n_templates > 1950 else None
    return {
        f"fixture, K={cfg.top_k}": (fine_planes, state.off3_fine, *fixture, win),
        f"1280x960, K={K}": (syn_fine, syn.off3_fine, *_to(dev, *random_candidates(syn, K, 7)), win),
        f"dual synthetic, K={K}, F=128": dual_synthetic(dev, box),
        "K=2048": (fine_planes, state.off3_fine, *_to(dev, *random_candidates(state, 2048, 8, n_real)), win),
    }


def fine_edge_cases(dev, shape=(33, 304, 384), k: int = 64) -> dict:
    """label -> (planes, off3, cand_t, base_yx, win): planes of 4 past a
    byte lane's flush (F=256 at window 8, 512 at window 4, 64 at window 20),
    windows 1, 2, 3, 5, 12 and 32, F=37 (a part batch), K=1, half the
    features on the zero plane, and windows ending at the planes' last byte
    at every word shift; random planes of `shape`, seed 11."""
    rng = np.random.default_rng(11)
    p, rows, stride = shape
    rand = rng.integers(0, 5, shape, dtype=np.uint8)
    rand[-1] = 0
    full4 = np.full(shape, 4, np.uint8)
    full4[-1] = 0

    def case(planes, f, win, n=16, kk=k, zero_half=False):
        m = min(rows, stride) // 2 - win
        off3 = np.stack([rng.integers(0, p - 1, (n, f)), rng.integers(0, m, (n, f)),
                         rng.integers(0, m, (n, f))], -1)
        if zero_half:
            off3[:, ::2] = (p - 1, 0, 0)
        base = np.stack([rng.integers(0, rows - m - win, kk), rng.integers(0, stride - m - win, kk)], 1)
        if planes is full4:
            base[:] = 0
        return (torch.from_numpy(planes).to(dev), *_to(dev, off3, rng.integers(0, n, kk), base), win)

    cases = {
        "planes of 4, F=256, win 8 (2 slices, 128 features a lane)": case(full4, 256, 8),
        "planes of 4, F=512, win 4 (8 slices, 64 features a lane)": case(full4, 512, 4),
        "planes of 4, F=64, win 20 (5 warps a candidate)": case(full4, 64, 20),
        **{f"win {w}": case(rand, 64, w) for w in (1, 2, 3, 5, 12, 32)},
        "F=37": case(rand, 37, 8),
        "K=1": case(rand, 64, 8, kk=1),
        "half the features on the zero plane": case(rand, 64, 8, zero_half=True),
    }
    last = rand.copy()
    last[-1] = rng.integers(0, 5, (rows, stride))
    off3 = np.array([[(p - 1, rows - 8 - 1, stride - 8 - 3)] * 64])
    base = np.array([[1, 0], [0, 1], [1, 2], [1, 3]])
    cases["windows ending at the planes' last byte"] = (
        torch.from_numpy(last).to(dev), *_to(dev, off3, np.zeros(4), base), 8)
    return cases


def fine_work(planes, off3, cand_t, base_yx, win) -> dict:
    """What the work needs, counted on the planes' device: `touched`, the
    distinct plane bytes the K windows read (a mask set through the gather
    indices); `bytes`, those plus the K x F x 12 triplet bytes, the K x 12
    of cand_t and base_yx and the K x win^2 x 4 of the output; `adds`, the
    int32 adds of the features off the zero plane over the windows; and
    `whole_bytes`, the earlier yardstick with the whole planes in place of
    the touched bytes."""
    k, f = cand_t.shape[0], off3.shape[1]
    stride = planes.shape[2]
    dev = planes.device
    mask = torch.zeros(planes.numel(), dtype=torch.bool, device=dev)
    sub = (torch.arange(win, device=dev)[:, None] * stride + torch.arange(win, device=dev)[None, :]).reshape(-1)
    base = base_yx[:, 0].long() * stride + base_yx[:, 1].long()
    for c0 in range(0, k, 256):
        off = sc._flat_offsets(planes, off3[cand_t[c0 : c0 + 256].long()])
        mask[(off[:, :, None] + base[c0 : c0 + 256, None, None] + sub).reshape(-1)] = True
    touched = int(mask.sum().item())
    rest = k * f * 12 + k * 12 + 4 * k * win * win
    live = int((off3[cand_t.long()][..., 0] < planes.shape[0] - 1).sum().item())
    return {"touched": touched, "bytes": touched + rest, "adds": live * win * win,
            "whole_bytes": planes.numel() + rest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="similarity.cu of an older commit, timed against the fine kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fine_time: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()
    texts = {"whole": src}
    for name, (line, repl) in VARIANTS.items():
        if src.count(line) != 1:
            raise RuntimeError(f"the kernel no longer has the line to change for {name!r}")
        texts[name] = src.replace(line, repl)
    if args.parent:
        texts["parent"] = open(args.parent).read()
    libs = compile_texts(texts, os.path.join(cuda_lib.BUILD_DIR, "fine"))
    for name, lib in libs.items():
        lib.fine_scores.argtypes = _PARENT_FINE if name == "parent" else sc._SIGNATURES["fine_scores"]
        lib.fine_scores.restype = ctypes.c_int
    state, fine_p, coarse_p, box = fixture_fine(dev)
    cases = fine_cases(dev, state, fine_p, coarse_p, box, *synthetic_1280(dev))
    print(card)

    def launcher(name, planes, off3, cand_t, base_yx, win, warps=sc.FINE_WARPS, layout=None):
        k, f = cand_t.shape[0], off3.shape[1]
        layout = layout or sc.fine_layout(win)

        def launch():
            out = torch.empty((k, win, win), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            if name == "parent":
                err = libs[name].fine_scores(planes.data_ptr(), planes.shape[1], planes.shape[2], off3.data_ptr(),
                                             f, cand_t.data_ptr(), base_yx.data_ptr(), k, win, out.data_ptr(), stream)
            else:
                err = libs[name].fine_scores(planes.data_ptr(), *planes.shape, off3.data_ptr(), f,
                                             cand_t.data_ptr(), base_yx.data_ptr(), k, win, warps,
                                             *layout, out.data_ptr(), stream)
            cuda_lib.check_launch(name, err)
            return out

        return launch

    for label, case in cases.items():
        planes, off3, cand_t, base_yx, win = case
        want = sc.fine_scores_plain(*case)
        runs = {f"{w} warps a block": launcher("whole", *case, warps=w) for w in (1, 2, 4, 8)}
        runs.update({name: launcher(name, *case) for name in VARIANTS})
        lanes_row, slices = sc.fine_layout(win)
        for other in ((lanes_row, 2 * slices), (lanes_row, slices // 2))[: 1 + (slices > 1)]:
            run = launcher("whole", *case, layout=other)
            try:
                run()
            except RuntimeError:  # a layout the kernel is not built for
                continue
            rows = 32 // (other[0] * other[1])
            runs[f"layout {other} ({-(-win // rows)} warps a candidate)"] = run
        if args.parent:
            runs["parent"] = launcher("parent", *case)
        for name, run in runs.items():
            if not torch.equal(run(), want):
                raise SystemExit(f"fine_time: the {name!r} kernel at {label} differs from fine_scores_plain")
        work = fine_work(*case)
        print(f"fine, {label}: planes {tuple(planes.shape)} x {tuple(off3.shape)}, K={cand_t.shape[0]}, win {win} "
              f"({lanes_row} lanes a row, {slices} slices); {work['touched']} distinct plane bytes touched, "
              f"{work['bytes']} B needed ({work['whole_bytes']} B with the whole planes), {work['adds']} adds; "
              f"exact at every warps a block and variant")
        if args.parent:
            print("  the older commit's kernel against this one, in turns (old, new, new, old):")
            show(in_turns({"parent": runs["parent"], "whole": runs[f"{sc.FINE_WARPS} warps a block"]}))
        print("  warps a block, and the variants:")
        show(in_turns({name: run for name, run in runs.items() if name != "parent"}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
