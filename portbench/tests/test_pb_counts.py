"""The bound functions against brute-force counts at small shapes, and the
plane geometry against the port's own planes."""

import numpy as np
import pytest
import torch

from portbench import counts, inputs
from portbench.reference import match


def _bank(n, seed, wh=(40, 30)):
    rng = np.random.default_rng(seed)
    w = rng.integers(wh[0] // 2, wh[0], n)
    h = rng.integers(wh[1] // 2, wh[1], n)
    feat0 = np.zeros((n, 64, 3), np.int16)
    feat1 = np.zeros((n, 64, 3), np.int16)
    for f, (fw, fh) in ((feat0, (w, h)), (feat1, (w // 2, h // 2))):
        f[:, :, 0] = np.floor(rng.random((n, 64)) * fw[:, None])
        f[:, :, 1] = np.floor(rng.random((n, 64)) * fh[:, None])
        f[:, :, 2] = rng.integers(0, 8, (n, 64))
    valid0 = rng.random((n, 64)) < 0.8
    valid1 = rng.random((n, 64)) < 0.8
    bbox = np.stack([np.zeros(n), np.zeros(n), w, h], 1).astype(np.int32)
    return {"feat0": feat0, "valid0": valid0, "feat1": feat1, "valid1": valid1, "bbox": bbox}


def _dual_bank(n, seed):
    """_bank with normal features (nfeat*, nvalid*) drawn alike."""
    arrays = _bank(n, seed)
    normal = _bank(n, seed + 100)
    arrays.update({f"n{k}": normal[k] for k in ("feat0", "valid0", "feat1", "valid1")})
    return arrays


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fine_work_brute_force(seed, dual):
    """Color: T = 2, an 8 x 8 window from cell (8 gy, 8 gx). Dual: T = 5,
    the normal features on the planes past the color ones, a 4 x 4 window
    from cell (16 gy // 5, 16 gx // 5)."""
    arrays = _dual_bank(12, seed) if dual else _bank(12, seed)
    geo = counts.Geometry(arrays["bbox"], 100 if dual else 96, 80 if dual else 64, dual)
    bank = match.make_bank(arrays, "cpu", dual)
    rng = np.random.default_rng(seed + 10)
    ch, cw = geo.coarse[:2]
    k = 7
    cand_t = torch.as_tensor(rng.integers(0, 12, k))
    gy = torch.as_tensor(rng.integers(0, ch, k))
    gx = torch.as_tensor(rng.integers(0, cw, k))
    nbytes, adds = counts.fine_scores_work(geo, bank.feat0, bank.valid0, cand_t, gy, gx)
    touched, live = set(), 0
    t = 5 if dual else 2
    win = -(-16 // t)
    modalities = ("", "n") if dual else ("",)
    for i in range(k):
        tt = int(cand_t[i])
        for m, prefix in enumerate(modalities):
            for j in range(64):
                x, y, o = (int(v) for v in arrays[f"{prefix}feat0"][tt, j])
                ok = bool(arrays[f"{prefix}valid0"][tt, j])
                live += ok
                plane = m * 8 * t * t + (o * t + y % t) * t + x % t if ok else len(modalities) * 8 * t * t
                sy, sx = (y // t, x // t) if ok else (0, 0)
                for wy in range(win):
                    for wx in range(win):
                        touched.add((plane, int(gy[i]) * 16 // t + wy + sy, int(gx[i]) * 16 // t + wx + sx))
    slots = 64 * len(modalities)
    assert nbytes == len(touched) + k * slots * 12 + k * 12 + 4 * k * win * win
    assert adds == live * win * win


def test_coarse_max_adds_brute_force():
    arrays = _bank(9, 5, wh=(120, 100))
    geo = counts.Geometry(arrays["bbox"], 160, 128)
    ch, cw = geo.coarse[:2]
    live = arrays["valid1"].sum(1)
    nbytes, adds = counts.coarse_max_work(geo, live, arrays["bbox"][:, 2:4])
    brute = 0
    for t in range(9):
        w, h = arrays["bbox"][t, 2:4]
        for gy in range(ch):
            for gx in range(cw):
                if gy < ch - int(np.ceil(h / 16)) and gx < cw - int(np.ceil(w / 16)):
                    brute += int(live[t])
    assert adds == brute / 4
    assert nbytes == geo.plane_bytes("coarse") + 9 * 64 * 12 + 9 * 8 + 9 * 4


@pytest.mark.parametrize("dual", [False, True])
def test_coarse_scores_work(dual):
    arrays = _dual_bank(5, 6) if dual else _bank(5, 6)
    geo = counts.Geometry(arrays["bbox"], 96, 64, dual)
    ch, cw = geo.coarse[:2]
    live = match.make_bank(arrays, "cpu", dual).valid1.sum(1)[:5].numpy()
    if dual:
        assert (live == arrays["valid1"].sum(1) + arrays["nvalid1"].sum(1)).all()
    nbytes, adds = counts.coarse_scores_work(geo, live)
    assert adds == sum(int(v) * ch * cw for v in live) / 4
    planes = (2 if dual else 1) * 8 * 64 + 1
    assert geo.plane_bytes("coarse") == planes * geo.coarse[2] * geo.coarse[3]
    assert nbytes == geo.plane_bytes("coarse") + 5 * 64 * (2 if dual else 1) * 12 + 5 * ch * cw * 4


def test_rescan_live_takes_best_maxes_lower_index_first():
    tmax = torch.tensor([5.0, 9.0, 5.0, 1.0, 9.0, -1.0])
    live = torch.tensor([10, 11, 12, 13, 14, 15])
    assert list(counts.rescan_live(tmax, live, 3)) == [11, 14, 10]


@pytest.mark.parametrize("dual", [False, True])
def test_geometry_equals_the_ports_planes(dual):
    """The layout the counts assume is the one the port builds (CPU): both
    levels' planes, and for a dual bank both modalities' and 128 slots."""
    from linemod_tpu_torch.models.template_bank import TemplateBank, _pad_bank
    from linemod_tpu_torch.ops.matching import _planes_3d, build_match_state
    from linemod_tpu_torch.pipeline.pose_detection import make_match_config
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings

    path = "portbench/data/lagergehaeuse_dual.npz" if dual else "portbench/data/lagergehaeuse.npz"
    arrays = inputs.load_committed(path, dual)
    tb = TemplateBank(class_id="x", dual_modality=dual, **arrays)
    cam = CameraParameters()
    cfg = make_match_config(cam, TemplateSettings(), tb.num_templates, dual_modality=dual)
    st = build_match_state(_pad_bank(tb, cfg.template_chunk), cfg, "cpu")
    geo = counts.Geometry(arrays["bbox"], 640, 480, dual)
    assert tuple(st.fine_shape) == geo.fine and tuple(st.coarse_shape) == geo.coarse
    img = torch.zeros((480, 640, 3))
    depth = torch.zeros((480, 640)) if dual else None
    fine = _planes_3d(img, geo.t_fine, st.max_cells_fine, depth)
    assert fine.numel() == geo.plane_bytes("fine")
    coarse = _planes_3d(img, 8, st.max_cells_coarse, depth, half=True)
    assert coarse.numel() == geo.plane_bytes("coarse")
    assert st.off3_coarse.shape[0] == match.pad_count(1950) == 2048
    assert st.off3_fine.shape[1] == st.off3_coarse.shape[1] == geo.slots

