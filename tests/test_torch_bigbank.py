"""The port's large-bank path against the JAX reference on the CPU: the masked
max scan (kernel 2.3's plain version), the per-template maxes, the streaming
and prefiltered exact cuts with their proof, the packed [top_k + 1, 5]
array, the saturated-frame retry, the large-bank config and concat_banks.

Every integer and float32 similarity must be equal: both sides compute the
percent scale in the same float32 order, and the cuts keep the same
canonical (similarity desc, flat index asc) order.

`tests/goldens/img0_bigbank_ref.npz` holds the JAX package's results for the
shipped regime's bank on the fixture frame: the fixture bank's 1,950
templates followed by make_synthetic_bank(94350, seed=7, bbox_wh=64), 96,300
templates padded to 96,512. chip_smoke.py holds the card against it. Here
only its own invariants are checked (the port at that size takes minutes on
the CPU). Regenerate it with
`env JAX_PLATFORMS=cpu python tests/test_torch_bigbank.py`.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")
BIGBANK_REF = os.path.join(REPO, "tests", "goldens", "img0_bigbank_ref.npz")
SYNTHETIC_TEMPLATES = 94350  # + the fixture bank's 1,950 = 96,300


def _jax_parts(state):
    from linemod_tpu_torch.ops.matching import META_FIELDS, TENSOR_FIELDS

    arrays = {k: np.asarray(getattr(state, k)) for k in TENSOR_FIELDS}
    meta = {k: getattr(state, k) for k in META_FIELDS}
    meta["cfg"] = dataclasses.asdict(state.cfg)
    return arrays, meta


def _assert_equal(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


# ------------------------------------------------------- kernel 2.3, plain ---

def test_coarse_max_plain_equals_pallas_and_dense(rng):
    """coarse_max_plain == coarse_max_pallas (interpret mode) == the dense
    masked max, at the shapes of tests/test_pallas.py, with three templates
    whose lim fits no cell (-1)."""
    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.matching import MatchConfig, _planes_3d, build_match_state
    from linemod_tpu.ops.similarity_pallas import coarse_max_pallas
    from linemod_tpu_torch.ops.similarity_cuda import coarse_max, coarse_max_plain

    n = 32
    state = build_match_state(
        make_synthetic_bank(n, seed=5, bbox_wh=48), MatchConfig(width=640, height=480, template_chunk=n)
    )
    color = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    planes = _planes_3d(
        jnp.asarray(color[::2, ::2]), jnp.zeros((240, 320)), 8, state.max_cells_coarse, False
    )
    ch, cw, _, stride = state.coarse_shape
    lim = np.array(state.lim_coarse)
    lim[3] = (0, 0)
    lim[7] = (0, 5)
    lim[11] = (4, 0)
    want = np.asarray(
        coarse_max_pallas(planes, state.off3_coarse, jnp.asarray(lim), state.max_cells_coarse, interpret=True)
    )
    flat = np.asarray(planes).reshape(-1)
    grid = (np.arange(ch)[:, None] * stride + np.arange(cw)[None, :]).reshape(-1)
    dense = flat[np.asarray(state.off_coarse)[:, :, None] + grid].astype(np.int64).sum(1)
    fits = (np.repeat(np.arange(ch), cw)[None] < lim[:, :1]) & (np.tile(np.arange(cw), ch)[None] < lim[:, 1:])
    np.testing.assert_array_equal(want, np.where(fits, dense, -1).max(1))
    assert (want[[3, 7, 11]] == -1).all() and (np.delete(want, [3, 7, 11]) > 0).all()

    args = (torch.from_numpy(np.array(planes)), torch.from_numpy(np.array(state.off3_coarse)),
            torch.from_numpy(lim), ch, cw)
    got = coarse_max_plain(*args)
    assert got.dtype == torch.int32
    _assert_equal(got, want)
    launches = coarse_max.launches
    _assert_equal(coarse_max(*args), want)  # CPU tensors: the plain version
    assert coarse_max.launches == launches


def test_coarse_max_plain_chunks_and_clamps(monkeypatch):
    """Chunking the masked max does not change it; lim beyond the grid is
    clamped to it and negative lim fits nowhere."""
    from linemod_tpu_torch.ops import similarity_cuda as sc

    rng = np.random.default_rng(1)
    planes = torch.from_numpy(rng.integers(0, 5, (9, 20, 24), dtype=np.uint8))
    off3 = torch.from_numpy(np.stack(
        [rng.integers(0, 9, (10, 6)), rng.integers(0, 4, (10, 6)), rng.integers(0, 4, (10, 6))], -1
    ).astype(np.int32))
    ch, cw = 12, 16
    lim = torch.from_numpy(rng.integers(1, 12, (10, 2)).astype(np.int32))
    lim[0] = torch.tensor([99, 99])
    lim[1] = torch.tensor([-2, -3])
    whole = sc.coarse_max_plain(planes, off3, lim, ch, cw)
    scores = sc.coarse_scores_plain(planes, off3, ch, cw)
    assert whole[0] == scores[0].max() and whole[1] == -1
    monkeypatch.setattr(sc, "_MAX_CHUNK", 3)
    _assert_equal(sc.coarse_max_plain(planes, off3, lim, ch, cw), whole.numpy())


@pytest.mark.cuda
def test_cuda_coarse_max_equals_plain():
    """The CUDA kernel against its plain version on the card, at the
    fixture's coarse plane shape with 8,192 random templates, some of whose
    bounds fit no cell; then planes of 4 inside the grid (every fitting cell
    sums 256, past a byte lane) and templates whose 64 features lie on one
    plane (one bucket holds them all)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linemod_tpu_torch.ops import similarity_cuda as sc

    rng = np.random.default_rng(0)
    p, rows, stride, ch, cw, n, f = 513, 48, 128, 30, 40, 8192, 64
    planes = torch.from_numpy(rng.integers(0, 5, (p, rows, stride), dtype=np.uint8)).cuda()
    planes[-1] = 0
    off3 = np.stack([rng.integers(0, p, (n, f)), rng.integers(0, 9, (n, f)), rng.integers(0, 9, (n, f))], -1)
    lim = rng.integers(-2, 41, (n, 2))
    lim[:4] = [[0, 0], [0, 40], [30, 0], [-1, -1]]
    off3, lim = (torch.from_numpy(a.astype(np.int32)).cuda() for a in (off3, lim))
    launches = sc.coarse_max.launches
    got = sc.coarse_max(planes, off3, lim, ch, cw)
    assert sc.coarse_max.launches == launches + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sc.coarse_max_plain(planes, off3, lim, ch, cw), rtol=0, atol=0)
    assert (got[:4] == -1).all()

    full = torch.zeros_like(planes)
    full[:-1, :ch, :cw] = 4
    flat = off3.clone()
    flat[:, :, 1:] = 0
    got = sc.coarse_max(full, flat, lim, ch, cw)
    torch.testing.assert_close(got, sc.coarse_max_plain(full, flat, lim, ch, cw), rtol=0, atol=0)
    assert int(got.max()) == 4 * f

    one = off3.clone()
    one[:, :, 0] = torch.from_numpy(rng.integers(0, p - 1, (n, 1)).astype(np.int32)).cuda()
    got = sc.coarse_max(planes, one, lim, ch, cw)
    torch.testing.assert_close(got, sc.coarse_max_plain(planes, one, lim, ch, cw), rtol=0, atol=0)


def test_coarse_max_rejects_bad_inputs():
    from linemod_tpu_torch.ops.similarity_cuda import coarse_max

    planes = torch.zeros((3, 40, 128), dtype=torch.uint8)
    off3 = torch.zeros((4, 8, 3), dtype=torch.int32)
    lim = torch.ones((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        coarse_max(planes, off3, lim.long(), 4, 4)
    with pytest.raises(ValueError):
        coarse_max(planes, off3, lim[:3].contiguous(), 4, 4)
    with pytest.raises(ValueError):
        coarse_max(planes, off3, lim, 41, 4)
    with pytest.raises(ValueError):
        coarse_max(planes.float(), off3, lim, 4, 4)


# ------------------------------------------ the cuts at a small shape ---

# threshold 33 keeps part of the random frames' candidates (fine similarities 28-39)
_SMALL = dict(width=320, height=240, top_k=32, threshold=33.0, template_chunk=8)


def _small_states(prefilter_sel=40, scan_chunk=16, saturate=False, **over):
    """The 64-template synthetic bank of tests/test_matching.py as a JAX
    state (the production blocked cut) and the port's state carried over
    from it."""
    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu_torch.ops.matching import MatchConfig, match_state_from_numpy

    bank = make_synthetic_bank(64, seed=9, bbox_wh=48)
    if saturate:
        for f in ("feat0", "valid0", "feat1", "valid1"):
            getattr(bank, f)[:] = getattr(bank, f)[:1]
    kw = dict(_SMALL, prefilter_sel=prefilter_sel, scan_chunk=scan_chunk, **over)
    jstate = jax_build(bank, JaxConfig(cut_block_rows=256, **kw))
    state = match_state_from_numpy(*_jax_parts(jstate), "cpu")
    assert state.cfg == MatchConfig(**kw)
    return jstate, state


def _frame(seed):
    return np.random.default_rng(seed).uniform(0, 255, (240, 320, 3)).astype(np.float32)


def _coarse_planes(jstate, state, color):
    from linemod_tpu.ops.extract import downsample2 as jax_down
    from linemod_tpu.ops.matching import _planes_3d as jax_planes
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.matching import _planes_3d

    jp = jax_planes(jax_down(jnp.asarray(color)), jnp.zeros((120, 160)), 8, jstate.max_cells_coarse, False)
    tp = _planes_3d(downsample2(torch.from_numpy(color)), 8, state.max_cells_coarse)
    _assert_equal(tp, jp, "coarse planes")
    return jp, tp


@pytest.fixture(scope="module")
def small():
    jstate, state = _small_states()
    jp, tp = _coarse_planes(jstate, state, _frame(0))
    return jstate, state, jp, tp


def test_template_maxes_equal_jax(small):
    from linemod_tpu.ops.matching import _template_maxes as jax_maxes
    from linemod_tpu_torch.ops.matching import _template_maxes

    jstate, state, jp, tp = small
    got = _template_maxes(state, tp)
    assert got.dtype == torch.float32
    _assert_equal(got, jax_maxes(jstate, jp))


def test_rank_by_sim_then_index_equals_jax():
    from linemod_tpu.ops.matching import rank_by_sim_then_index as jax_rank
    from linemod_tpu_torch.ops.matching import rank_by_sim_then_index

    rng = np.random.default_rng(3)
    sim = rng.choice(np.float32([-1.0, 0.0, 50.0, 81.25]), 300)
    idx = rng.permutation(1000)[:300].astype(np.int32)
    got = rank_by_sim_then_index(torch.from_numpy(sim), torch.from_numpy(idx), 120)
    for g, w in zip(got, jax_rank(jnp.asarray(sim), jnp.asarray(idx), 120)):
        _assert_equal(g, w)


def test_candidate_cut_streaming_equals_jax_and_dense(small):
    from linemod_tpu.ops.matching import candidate_cut_streaming as jax_stream
    from linemod_tpu_torch.ops.matching import candidate_cut, candidate_cut_streaming, coarse_similarity

    jstate, state, jp, tp = small
    got = candidate_cut_streaming(state, tp, 32)
    for k, g, w in zip("sim t gy gx".split(), got, jax_stream(jstate, jp, 32)):
        _assert_equal(g, w, k)
    dense = candidate_cut(coarse_similarity(state, tp), state.coarse_shape[1], 32)
    for g, d in zip(got, dense):
        _assert_equal(g, d.numpy())


def test_candidate_cut_prefilter_equals_jax_and_dense(small):
    from linemod_tpu.ops.matching import candidate_cut_prefilter as jax_prefilter
    from linemod_tpu_torch.ops.matching import candidate_cut, candidate_cut_prefilter, coarse_similarity

    jstate, state, jp, tp = small
    got = candidate_cut_prefilter(state, tp, 32)
    want = jax_prefilter(jstate, jp, 32)
    for k, g, w in zip("sim t gy gx exact".split(), got, want):
        _assert_equal(g, w, k)
    assert bool(got[4])
    dense = candidate_cut(coarse_similarity(state, tp), state.coarse_shape[1], 32)
    for g, d in zip(got[:4], dense):
        _assert_equal(g, d.numpy())


@pytest.mark.parametrize("cut", ["prefilter", "streaming"])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_templates_equals_jax_and_dense(cut, seed):
    """match_templates on the prefiltered (with cut_exact) and streaming
    cuts equals JAX's, key by key, and the port's own dense cut."""
    from linemod_tpu.ops.matching import match_templates as jax_match
    from linemod_tpu_torch.ops.matching import match_templates

    sel = 40 if cut == "prefilter" else 0
    jstate, state = _small_states(prefilter_sel=sel)
    _, dense_state = _small_states(prefilter_sel=0, scan_chunk=0)
    color = _frame(seed)
    want = jax_match(jstate, jnp.asarray(color), jnp.zeros((240, 320)))
    got = match_templates(state, torch.from_numpy(color))
    dense = match_templates(dense_state, torch.from_numpy(color))
    assert sorted(got) == sorted(want)
    assert ("cut_exact" in got) == (cut == "prefilter")
    for k in want:
        _assert_equal(got[k], want[k], k)
    for k in dense:
        _assert_equal(got[k], dense[k].numpy(), k)
    assert 0 < int(got["valid"].sum()) < 32


@pytest.mark.parametrize("seed", [0, 2])
def test_detect_frame_packs_the_proof_row(seed):
    from linemod_tpu.ops.detect_core import detect_frame as jax_detect
    from linemod_tpu_torch.ops.detect_core import detect_frame

    jstate, state = _small_states()
    color = _frame(seed).astype(np.uint8)
    want = np.asarray(jax_detect(jstate, jnp.asarray(color)))
    got = detect_frame(state, torch.from_numpy(color)).numpy()
    assert got.shape == want.shape == (33, 5)
    _assert_equal(got, want)
    assert got[-1].tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]


def test_saturated_cut_is_reported_in_both_packages():
    """A bank of identical templates ties every maximum at the selection
    boundary (threshold 0 puts it above the threshold): cut_exact is False
    on both sides, and every output still agrees."""
    from linemod_tpu.ops.matching import match_templates as jax_match
    from linemod_tpu_torch.ops.matching import match_templates

    jstate, state = _small_states(prefilter_sel=20, top_k=16, threshold=0.0, saturate=True)
    color = _frame(0)
    want = jax_match(jstate, jnp.asarray(color), jnp.zeros((240, 320)))
    got = match_templates(state, torch.from_numpy(color))
    assert not bool(want["cut_exact"]) and not bool(got["cut_exact"])
    for k in want:
        _assert_equal(got[k], want[k], k)


def test_pose_detection_retries_saturated_frames():
    """A PoseDetection forced onto the prefiltered cut re-runs a saturated
    frame on the streaming cut and returns its poses, which equal JAX's
    (the port of tests/test_matching.py's test of the same name)."""
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import ModelProperties as JProps
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu.pipeline.pose_detection import PoseDetection as JaxDetection
    from linemod_tpu.pipeline.pose_detection import _pad_bank as jax_pad
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection, make_match_config

    cam_kw = dict(fx=500.0, fy=500.0, cx=160.0, cy=120.0, width=320, height=240)
    set_kw = dict(detector_threshold=0.0, use_depth_improvement=False)
    props_kw = dict(lower_color_range=(0, 0, 0), upper_color_range=(255, 255, 255),
                    rotationally_symmetrical=False, planes_of_symmetry=(0.0, 0.0, 0.0))
    banks = []
    for make in (jax_synthetic, make_synthetic_bank):
        bank = make(64, seed=9, bbox_wh=48, image_wh=(320, 240))
        for f in ("feat0", "valid0", "feat1", "valid1"):
            getattr(bank, f)[:] = getattr(bank, f)[:1]
        bank.median_depth[:] = 0.0
        bank.z[:] = 600.0
        banks.append(bank)
    over = dict(prefilter_sel=20, top_k=16, threshold=0.0, scan_chunk=16)

    jdet = JaxDetection(banks[0], JCam(**cam_kw), JSettings(**set_kw), JProps(**props_kw))
    jcfg = dataclasses.replace(jdet.state.cfg, **over)
    jdet.state = jax_build(jax_pad(banks[0], jcfg.template_chunk), jcfg)

    cam, settings = CameraParameters(**cam_kw), TemplateSettings(**set_kw)
    cfg = dataclasses.replace(make_match_config(cam, settings, 64), **over)
    det = PoseDetection(banks[1], cam, settings, ModelProperties(**props_kw), "cpu", cfg=cfg)
    exact = PoseDetection(banks[1], cam, settings, ModelProperties(**props_kw), "cpu",
                          cfg=dataclasses.replace(cfg, prefilter_sel=0))
    assert det.exact_state.cfg == exact.state.cfg and exact.exact_state is None

    color = np.random.default_rng(0).uniform(0, 255, (240, 320, 3)).astype(np.uint8)
    depth = np.full((240, 320), 600, np.uint16)
    got = det.detect(color, depth, 2)
    assert det.retries == 1  # the retry ran
    want = jdet.detect(color, depth, 2)
    ref = exact.detect(color, depth, 2)
    assert len(got) == len(want) == len(ref) >= 1
    for a, b, c in zip(got, want, ref):
        np.testing.assert_array_equal(a.translation, b.translation)
        np.testing.assert_array_equal(a.quaternion, b.quaternion)
        np.testing.assert_array_equal(a.translation, c.translation)
        np.testing.assert_array_equal(a.quaternion, c.quaternion)


# ------------------------------------------------- config and the bank ---

@pytest.mark.parametrize("n_templates", [1950, 8192, 8193, 96300])
def test_make_match_config_equals_jax(n_templates):
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.pipeline.pose_detection import make_match_config as jax_config
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings
    from linemod_tpu_torch.pipeline.pose_detection import make_match_config

    got = make_match_config(CameraParameters(), TemplateSettings(detector_threshold=85.0), n_templates)
    want = jax_config(JCam(), JSettings(detector_threshold=85.0), False, n_templates)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.prefilter_sel, got.scan_chunk) == ((1024, 4096) if n_templates > 8192 else (0, 0))


def test_concat_banks_equals_jax():
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.models.template_bank import concat_banks as jax_concat
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu_torch.models.template_bank import TemplateBank, concat_banks, make_synthetic_bank

    path = os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")
    got, got_off = concat_banks([TemplateBank.load(path), make_synthetic_bank(70, seed=7, bbox_wh=64)])
    want, want_off = jax_concat([JaxBank.load(path), jax_synthetic(70, seed=7, bbox_wh=64)])
    _assert_equal(got_off, want_off)
    assert got.class_id == want.class_id and got.dual_modality == want.dual_modality
    assert got.num_templates == 2020
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            _assert_equal(a, b, f.name)
        else:
            assert a == b, f.name
    with pytest.raises(ValueError):
        concat_banks([])


# -------------------------------------------------- the full-size golden ---

def test_bigbank_golden_invariants():
    """The golden's prefiltered cut is proved exact, and its valid rows and
    pose equal the 1,950-template fixture golden's."""
    ref = np.load(BIGBANK_REF)
    small_ref = np.load(TORCH_REF)
    packed = ref["packed"]
    assert packed.shape == (513, 5) and ref["maxes"].shape == (96512,)
    assert packed[-1].tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]
    assert ref["n_templates"] == 96300
    valid = packed[:512, 4] > 0.5
    small_valid = small_ref["packed"][:, 4] > 0.5
    np.testing.assert_array_equal(packed[:512][valid], small_ref["packed"][small_valid])
    assert int(valid.sum()) == 115
    for k in ("top_sim", "cand_t", "cand_gy", "cand_gx"):
        assert ref[k].shape == (512,), k
    np.testing.assert_array_equal(ref["translation"], small_ref["translation"])
    np.testing.assert_array_equal(ref["quaternion"], small_ref["quaternion"])


def jax_bigbank_reference():
    """Run the JAX reference on the fixture frame with the 96,300-template
    bank (CPU, about 10 s). Returns the golden's arrays."""
    import cv2
    import jax

    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank, concat_banks, make_synthetic_bank
    from linemod_tpu.ops.detect_core import detect_frame
    from linemod_tpu.ops.extract import downsample2
    from linemod_tpu.ops.matching import _planes_3d, _template_maxes, candidate_cut_prefilter
    from linemod_tpu.pipeline.pose_detection import PoseDetection

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank, _ = concat_banks([
        TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")),
        make_synthetic_bank(SYNTHETIC_TEMPLATES, seed=7, bbox_wh=64, image_wh=(640, 480)),
    ])
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    det = PoseDetection(bank, cam, settings, props)
    cfg = det.state.cfg
    assert (cfg.prefilter_sel, cfg.scan_chunk) == (1024, 4096)
    color = cv2.imread(os.path.join(EXAMPLE, "benchmark", "img0.png"))
    depth = cv2.imread(os.path.join(EXAMPLE, "benchmark", "depth0.png"), cv2.IMREAD_ANYDEPTH)
    color_c = det.recenter(np.ascontiguousarray(color))
    coarse = downsample2(jnp.asarray(color_c.astype(np.float32)))
    planes = _planes_3d(coarse, jnp.zeros(coarse.shape[:2]), cfg.t_coarse, det.state.max_cells_coarse, False)
    cut = jax.jit(candidate_cut_prefilter, static_argnums=2)(det.state, planes, cfg.top_k)
    pose = det.detect(color, depth, 1)[0]
    return {
        "packed": np.asarray(detect_frame(det.state, jnp.asarray(color_c.astype(np.uint8)))),
        "maxes": np.asarray(jax.jit(_template_maxes)(det.state, planes)),
        "top_sim": np.asarray(cut[0]),
        "cand_t": np.asarray(cut[1]),
        "cand_gy": np.asarray(cut[2]),
        "cand_gx": np.asarray(cut[3]),
        "cut_exact": np.asarray(cut[4]),
        "n_templates": np.asarray(bank.num_templates),
        "translation": np.asarray(pose.translation, np.float64),
        "quaternion": np.asarray(pose.quaternion, np.float64),
    }


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_bigbank_reference()
    np.savez_compressed(BIGBANK_REF, **arrays)
    print(f"wrote {BIGBANK_REF}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))
