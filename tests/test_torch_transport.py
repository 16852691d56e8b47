"""The port's upload routes (host quantize, delta-encoded color) and the two
cut opt-ins (`MatchConfig.approx_topk`, `guarded_cut`) against the JAX
reference on the CPU.

- `delta_encode_host` equals JAX's bit for bit, and the device decode gives
  the frame back;
- `match_templates_quant` / `detect_frame_quant` (the fixture's maps from
  the port's host quantizer), `detect_frame_delta`, `detect_frames_batch_delta`
  (3 frames) and `detect_frame_dual_delta` (the cube dual bank of
  tests/test_dual_modality.py, built by JAX here, on a rendered and a random
  frame; and the fixture's dual bank against tests/goldens/img0_dual_ref.npz)
  give JAX's packed arrays, and every route gives the default route's;
- the cut opt-ins on two scenes with the fixture bank: the fixture frame,
  dense at the coarse level (554,367 entries at threshold, so JAX's guard
  fails), and a flat gray frame with a 24x24 patch of the fixture (228
  entries, so the guard passes); and the cut alone on seeded similarities
  with ties, against JAX's `candidate_cut`;
- `PoseDetection(host_quant=True)` and `delta_transport`, through
  `detect`, `detect_submit_batch` and `detect_stream`, and
  `MultiModelPoseDetection.delta_transport` (the fixture and a synthetic
  class), give JAX's packed arrays and poses; the route precedence and the
  dual bank's refusal of host quantizing are JAX's.

Tolerances: delta frames and cut indices exact; packed candidates with
template ids, x, y and valid flags exact and similarities atol 1e-4 (the
fixture tests' tolerance; equal in practice); poses 1e-6 mm and 1e-9, the
same float64 pose math on the same matches.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_e2e_fixture import _assert_packed_equal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")
DUAL_REF = os.path.join(REPO, "tests", "goldens", "img0_dual_ref.npz")
MULTI_REF = os.path.join(REPO, "tests", "goldens", "img0_multi_ref.npz")
SETTINGS = os.path.join(EXAMPLE, "linemod_settings.yml")
MODEL = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
BANK = os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")
DUAL_BANK = os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")
IMG0 = os.path.join(EXAMPLE, "benchmark", "img0.png")
DEPTH0 = os.path.join(EXAMPLE, "benchmark", "depth0.png")


def sparse_frame(color: np.ndarray) -> np.ndarray:
    """A flat gray frame with the 24x24 patch of `color` around the
    fixture's object: 228 coarse entries at threshold 80 with the fixture
    bank, below top_k."""
    out = np.full_like(color, 128)
    out[237:261, 264:288] = color[237:261, 264:288]
    return out


def _port_bank(jbank):
    from linemod_tpu_torch.models.template_bank import TemplateBank

    return TemplateBank(**{f.name: getattr(jbank, f.name) for f in dataclasses.fields(TemplateBank)})


@pytest.fixture(scope="module")
def fx():
    """Both packages' detectors on the fixture bank (JAX's host_quant=None
    resolves to False on the CPU), the frame and the reference's packed."""
    from linemod_tpu.config import load_model_properties as jax_props
    from linemod_tpu.config import load_settings as jax_settings
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.pipeline.pose_detection import PoseDetection as JaxDetection
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    jcam, jsettings = jax_settings(SETTINGS)
    jdet = JaxDetection(JaxBank.load(BANK), jcam, jsettings, jax_props(MODEL))
    cam, settings = load_settings(SETTINGS)
    args = (TemplateBank.load(BANK), cam, settings, load_model_properties(MODEL), "cpu")
    det = PoseDetection(*args)
    color, depth = read_png(IMG0, "color"), read_png(DEPTH0, "anydepth")
    return {"jdet": jdet, "det": det, "args": args, "color": color, "depth": depth,
            "color_c": det.recenter(color), "packed": np.load(TORCH_REF)["packed"]}


def _same_poses(got: list, want: list):
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.translation, b.translation, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.quaternion, b.quaternion, rtol=0, atol=1e-9)


# ----------------------------------------------------------- delta encode ---

@pytest.mark.parametrize("shape", [(480, 640), (7, 1), (13, 29), (1, 2)])
def test_delta_encode_host_equals_jax_and_decodes(fx, shape):
    from linemod_tpu.ops.detect_core import delta_encode_host as jax_encode
    from linemod_tpu_torch.ops.detect_core import _delta_decode, delta_encode_host

    if shape == (480, 640):
        color = fx["color_c"]
    else:
        color = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = delta_encode_host(color)
    np.testing.assert_array_equal(got, jax_encode(color))
    assert got.dtype == np.uint8 and got.shape == (3, *shape)
    back = _delta_decode(torch.from_numpy(got))
    assert back.dtype == torch.float32 and back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), color.astype(np.float32))


# ------------------------------------------------------ routes, one frame ---

def test_detect_frame_quant_equals_jax(fx):
    from linemod_tpu.ops.detect_core import detect_frame_quant as jax_quant
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.ops.detect_core import detect_frame_quant
    from linemod_tpu_torch.ops.matching import match_templates_quant
    from linemod_tpu_torch.utils.native import quantize_frame

    q0, q1 = quantize_frame(fx["color_c"])
    jq0, jq1 = jax_native.quantize_frame(fx["color_c"])
    want = np.asarray(jax_quant(fx["jdet"].state, jnp.asarray(jq0), jnp.asarray(jq1)))
    got = detect_frame_quant(fx["det"].state, torch.from_numpy(q0), torch.from_numpy(q1)).numpy()
    assert got.shape == want.shape == (512, 5)
    _assert_packed_equal(got, want)
    _assert_packed_equal(got, fx["packed"])  # the default route's (JAX's detect_frame)
    m = match_templates_quant(fx["det"].state, torch.from_numpy(q0), torch.from_numpy(q1))
    assert int(m["valid"].sum()) == int(fx["packed"][:, 4].sum()) == 115


def test_detect_frame_delta_equals_jax(fx):
    from linemod_tpu.ops.detect_core import delta_encode_host as jax_encode
    from linemod_tpu.ops.detect_core import detect_frame_delta as jax_delta
    from linemod_tpu_torch.ops.detect_core import delta_encode_host, detect_frame_delta

    want = np.asarray(jax_delta(fx["jdet"].state, jnp.asarray(jax_encode(fx["color_c"]))))
    got = detect_frame_delta(fx["det"].state, torch.from_numpy(delta_encode_host(fx["color_c"]))).numpy()
    _assert_packed_equal(got, want)
    _assert_packed_equal(got, fx["packed"])


def test_detect_frames_batch_delta_equals_jax(fx):
    from linemod_tpu.ops.detect_core import detect_frames_batch_delta as jax_batch
    from linemod_tpu_torch.ops.detect_core import delta_encode_host, detect_frames_batch_delta

    frames = [fx["color_c"], np.roll(fx["color_c"], (9, -14), (0, 1)), sparse_frame(fx["color_c"])]
    deltas = np.stack([delta_encode_host(c) for c in frames])
    want = np.asarray(jax_batch(fx["jdet"].state, jnp.asarray(deltas)))
    got = detect_frames_batch_delta(fx["det"].state, torch.from_numpy(deltas)).numpy()
    assert got.shape == want.shape == (3, 512, 5)
    for g, w in zip(got, want):
        _assert_packed_equal(g, w)
    _assert_packed_equal(got[0], fx["packed"])
    assert [int(w[:, 4].sum()) for w in want] != [0, 0, 0]


def test_match_templates_quant_refuses_a_dual_state():
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.ops.matching import build_match_state, match_templates_quant
    from linemod_tpu_torch.pipeline.pose_detection import make_match_config
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings

    bank = TemplateBank.load(DUAL_BANK)
    state = build_match_state(bank, make_match_config(CameraParameters(), TemplateSettings(), 2048, True), "cpu")
    q = torch.zeros((480, 640), dtype=torch.uint8)
    with pytest.raises(ValueError, match="color-only"):
        match_templates_quant(state, q, q[::2, ::2])


# ------------------------------------------------------------ dual + delta ---

@pytest.fixture(scope="module")
def cube():
    """tests/test_dual_modality.py's cube dual bank, built by JAX, on both
    sides (the setup of tests/test_torch_dual.py)."""
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import ModelProperties as JProps
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.models.template_bank import build_template_bank
    from linemod_tpu.pipeline.pose_detection import PoseDetection as JaxDetection
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from test_matching import cube_mesh

    cam_kw = dict(fx=500.0, fy=500.0, cx=320, cy=240, width=640, height=480)
    set_kw = dict(only_color_modality=False, distance_start=600, distance_stop=600, subdivisions=0,
                  angle_start=-45, angle_stop=45, angle_step=45, depth_offset=0.0)
    props_kw = dict(planes_of_symmetry=(1.0, 1.0, 1.0))
    mesh = cube_mesh()
    jbank = build_template_bank(mesh, "cube", JCam(**cam_kw), JSettings(**set_kw), JProps(**props_kw))
    jdet = JaxDetection(jbank, JCam(**cam_kw), JSettings(**set_kw), JProps(**props_kw), host_quant=True)
    cam = CameraParameters(**cam_kw)
    det = PoseDetection(_port_bank(jbank), cam, TemplateSettings(**set_kw), ModelProperties(**props_kw), "cpu",
                        host_quant=True)
    return jdet, det, cam, mesh


def _cube_frame(cube, kind):
    if kind == "random":
        rng = np.random.default_rng(3)
        return (rng.integers(0, 256, (480, 640, 3)).astype(np.uint8),
                rng.uniform(400, 900, (480, 640)).astype(np.uint16))
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render_views
    from linemod_tpu_torch.utils.geometry import quat_to_mat

    _, det, cam, mesh = cube
    rot = quat_to_mat(det.bank.quat[4]).astype(np.float32)
    depth, color = render_views(mesh_to_arrays(mesh, "cpu"), rot[None], np.array([[40.0, -30.0, 600.0]], np.float32),
                                cam, with_color=True)
    return (color[0].numpy() * 255).astype(np.uint8), depth[0].numpy().astype(np.uint16)


@pytest.mark.parametrize("frame", ["rendered", "random"])
def test_cube_detect_frame_dual_delta_equals_jax(cube, frame):
    from linemod_tpu.ops.detect_core import delta_encode_host as jax_encode
    from linemod_tpu.ops.detect_core import detect_frame_dual_delta as jax_dual_delta
    from linemod_tpu_torch.ops.detect_core import delta_encode_host, detect_frame_dual, detect_frame_dual_delta

    jdet, det, _, _ = cube
    color, depth = _cube_frame(cube, frame)
    depthf = depth.astype(np.float32)
    want = np.asarray(jax_dual_delta(jdet.state, jnp.asarray(jax_encode(color)), jnp.asarray(depthf)))
    got = detect_frame_dual_delta(det.state, torch.from_numpy(delta_encode_host(color)),
                                  torch.from_numpy(depthf)).numpy()
    _assert_packed_equal(got, want)
    np.testing.assert_array_equal(
        got, detect_frame_dual(det.state, torch.from_numpy(color), torch.from_numpy(depthf)).numpy())
    assert want[:, 4].sum() > 0


def test_dual_bank_never_host_quantizes(cube):
    """host_quant=True on a dual bank is off (its normals need the depth on
    the device), as in JAX; the dual detector then takes the delta route
    when asked, and detects as JAX's does."""
    jdet, det, _, _ = cube
    assert jdet.host_quant is False and det.host_quant is False
    jdet.delta_transport = det.delta_transport = True
    try:
        color, depth = _cube_frame(cube, "rendered")
        want, got = np.asarray(jdet.detect_submit(color, depth)[0]), det.detect_submit(color, depth)[0].numpy()
        _assert_packed_equal(got, want)
        _same_poses(det.detect(color, depth, 1), jdet.detect(color, depth, 1))
    finally:
        jdet.delta_transport = det.delta_transport = False


def test_fixture_dual_delta_equals_golden():
    """The fixture with the dual bank through the delta route equals JAX's
    dual golden packed array and pose."""
    import dataclasses as dc

    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    ref = np.load(DUAL_REF)
    cam, settings = load_settings(SETTINGS)
    det = PoseDetection(TemplateBank.load(DUAL_BANK), cam, dc.replace(settings, only_color_modality=False),
                        load_model_properties(MODEL), "cpu", host_quant=True)
    assert not det.host_quant
    det.delta_transport = True
    color, depth = read_png(IMG0, "color"), read_png(DEPTH0, "anydepth")
    handle = det.detect_submit(color, depth)
    _assert_packed_equal(handle[0].numpy(), ref["packed"])
    pose = det.detect_collect(handle, 1)[0]
    np.testing.assert_allclose(pose.translation, ref["translation"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pose.quaternion, ref["quaternion"], rtol=0, atol=1e-9)


# --------------------------------------------------------- the cut opt-ins ---

@pytest.mark.parametrize("opt", ["approx_topk", "guarded_cut"])
@pytest.mark.parametrize("density", ["sparse", "dense"])
def test_candidate_cut_opt_ins_equal_jax(opt, density):
    """The cut alone on seeded similarities with heavy ties: the four arrays
    equal JAX's candidate_cut under the same opt-in (JAX's approximate pass
    is the exact top_k on the CPU), and the port's exact cut."""
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import candidate_cut as jax_cut
    from linemod_tpu_torch.ops.matching import MatchConfig, candidate_cut

    rng = np.random.default_rng(5 if density == "dense" else 6)
    n, cw, top_k = 64, 40, 128
    sim = np.round(rng.uniform(0, 100, (n, 30 * cw)) / 5).astype(np.float32) * 5
    if density == "sparse":
        sim = np.minimum(sim, 75.0)
        sim.reshape(-1)[rng.choice(sim.size, 40, replace=False)] = 90.0
    above = int((sim >= 80).sum())
    assert (above > top_k) == (density == "dense")
    want = jax_cut(JaxConfig(**{opt: True}), jnp.asarray(sim), cw, top_k)
    got = candidate_cut(torch.from_numpy(sim), cw, top_k, MatchConfig(**{opt: True}))
    exact = candidate_cut(torch.from_numpy(sim), cw, top_k)
    for g, w, e in zip(got, want, exact):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), e.numpy())


@pytest.mark.parametrize("opt", ["approx_topk", "guarded_cut"])
@pytest.mark.parametrize("scene", ["dense", "sparse"])
def test_cut_opt_ins_on_the_fixture_equal_jax(fx, scene, opt):
    """detect_frame with the opt-in equals JAX's under it and the default
    exact cut's. On the dense fixture frame JAX's guard fails (more entries
    at threshold than top_k, the approximate pass cannot hold them all); on
    the sparse frame it passes."""
    from linemod_tpu.ops.detect_core import detect_frame as jax_detect
    from linemod_tpu.ops.extract import downsample2
    from linemod_tpu.ops.matching import _planes_3d, coarse_similarity
    from linemod_tpu_torch.ops.detect_core import detect_frame

    color = fx["color_c"] if scene == "dense" else sparse_frame(fx["color_c"])
    jstate, state = fx["jdet"].state, fx["det"].state
    colorf = jnp.asarray(color.astype(np.float32))
    coarse = _planes_3d(downsample2(colorf), jnp.zeros(colorf.shape[:2])[::2, ::2], jstate.cfg.t_coarse,
                        jstate.max_cells_coarse, False)
    above = int((np.asarray(coarse_similarity(jstate, coarse)) >= jstate.cfg.threshold).sum())
    assert above == {"dense": 554367, "sparse": 228}[scene]
    jst = dataclasses.replace(jstate, cfg=dataclasses.replace(jstate.cfg, **{opt: True}))
    st = dataclasses.replace(state, cfg=dataclasses.replace(state.cfg, **{opt: True}))
    want = np.asarray(jax_detect(jst, jnp.asarray(color)))
    got = detect_frame(st, torch.from_numpy(color)).numpy()
    _assert_packed_equal(got, want)
    np.testing.assert_array_equal(got, detect_frame(state, torch.from_numpy(color)).numpy())
    if scene == "dense":
        _assert_packed_equal(got, fx["packed"])


@pytest.mark.parametrize("pass_kind", ["misses an entry", "catches all, unordered"])
def test_guard_takes_the_exact_cut_when_the_pass_misses(pass_kind):
    """tests/test_matching.py's fallback case: a pass that misses an entry
    at threshold fails the guard and the exact cut is taken; a pass that
    holds every such entry, in any order, passes it and is re-ranked."""
    from linemod_tpu_torch.ops.matching import _guarded, candidate_cut

    rng = np.random.default_rng(8)
    sim = np.round(rng.uniform(0, 100, (16, 60)) / 10).astype(np.float32) * 10
    top_k = 256
    assert int((sim >= 80).sum()) < top_k
    flat = torch.from_numpy(sim).reshape(-1)
    exact = candidate_cut(torch.from_numpy(sim), 10, top_k)
    e_sim, e_idx = torch.sort(flat, descending=True, stable=True)
    e_sim, e_idx = e_sim[:top_k], e_idx[:top_k]
    if pass_kind == "misses an entry":
        # the pass loses the first entry at threshold for a filler
        a_sim, a_idx = e_sim.clone(), e_idx.clone()
        a_sim[0], a_idx[0] = 0.0, int(torch.nonzero(flat == 0)[0])
    else:
        a_sim, a_idx = e_sim.flip(0), e_idx.flip(0)
    wrong = (torch.full_like(e_sim, -7.0), torch.zeros_like(e_idx))
    got_sim, got_idx = _guarded(flat, (a_sim, a_idx), (e_sim, e_idx) if pass_kind != "misses an entry" else wrong,
                                80.0, top_k)
    if pass_kind == "misses an entry":
        np.testing.assert_array_equal(got_sim.numpy(), wrong[0].numpy())
    else:
        np.testing.assert_array_equal(got_sim.numpy(), exact[0].numpy())
        np.testing.assert_array_equal((got_idx // sim.shape[1]).numpy(), exact[1].numpy())


# -------------------------------------------------------- the orchestrators ---

def _jax_detector(host_quant=None):
    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.pipeline.pose_detection import PoseDetection

    cam, settings = load_settings(SETTINGS)
    return PoseDetection(TemplateBank.load(BANK), cam, settings, load_model_properties(MODEL), host_quant=host_quant)


@pytest.mark.parametrize("route", ["host_quant", "delta"])
def test_pose_detection_route_equals_jax(fx, route):
    """detect_submit / detect on the route give JAX's packed array and pose
    on that route, which are the default route's."""
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection

    if route == "host_quant":
        jdet = _jax_detector(host_quant=True)
        det = PoseDetection(*fx["args"], host_quant=True)
        det.delta_transport = True  # host_quant takes precedence
    else:
        jdet = fx["jdet"]
        det = PoseDetection(*fx["args"])
        det.delta_transport = jdet.delta_transport = True
    try:
        assert (det.host_quant, jdet.host_quant) == ((True, True) if route == "host_quant" else (False, False))
        color, depth = fx["color"], fx["depth"]
        want = np.asarray(jdet.detect_submit(color, depth)[0])
        got = det.detect_submit(color, depth)[0].numpy()
        _assert_packed_equal(got, want)
        _assert_packed_equal(got, fx["packed"])
        _same_poses(det.detect(color, depth, 1), jdet.detect(color, depth, 1))
        _same_poses(det.detect(color, depth, 1), fx["det"].detect(color, depth, 1))
    finally:
        fx["jdet"].delta_transport = False


def test_host_quant_launches_the_quant_program(fx, monkeypatch):
    """The host-quantize route uploads the two maps and runs
    detect_frame_quant, never the color program; the delta route runs
    detect_frame_delta; the default neither."""
    from linemod_tpu_torch.pipeline import pose_detection as pd

    calls = []
    for name in ("detect_frame", "detect_frame_quant", "detect_frame_delta"):
        real = getattr(pd, name)
        monkeypatch.setattr(pd, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    det = pd.PoseDetection(*fx["args"], host_quant=True)
    det.detect_submit(fx["color"], fx["depth"])
    det.host_quant, det.delta_transport = False, True
    det.detect_submit(fx["color"], fx["depth"])
    det.delta_transport = False
    det.detect_submit(fx["color"], fx["depth"])
    assert calls == ["detect_frame_quant", "detect_frame_delta", "detect_frame"]
    assert pd.PoseDetection(*fx["args"]).host_quant is False  # None: off on this backend
    assert pd.PoseDetection(*fx["args"]).delta_transport is False


def test_batch_and_stream_routes_equal_jax(fx):
    """detect_submit_batch with delta_transport equals JAX's batch on the
    delta route; detect_stream with host_quant sends frame by frame (no
    batch program) and equals detect."""
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection

    frames = [(fx["color"], fx["depth"]),
              (np.roll(fx["color"], (9, -14), (0, 1)), np.roll(fx["depth"], (9, -14), (0, 1)))]
    jdet = fx["jdet"]
    det = PoseDetection(*fx["args"])
    det.delta_transport = jdet.delta_transport = True
    try:
        want = np.asarray(jdet.detect_submit_batch(frames)[0])
        handle = det.detect_submit_batch(frames)
        got = handle[0].numpy()
        assert got.shape == want.shape == (2, 512, 5)
        for g, w in zip(got, want):
            _assert_packed_equal(g, w)
        for a, b in zip(det.detect_collect_batch(handle, 1), jdet.detect_collect_batch(jdet.detect_submit_batch(frames))):
            _same_poses(a, b)
    finally:
        jdet.delta_transport = False
    hq = PoseDetection(*fx["args"], host_quant=True)
    batches = []
    hq.detect_submit_batch = lambda fr: batches.append(fr)
    streamed = list(hq.detect_stream(frames + frames[:1], 1, batch=2))
    assert batches == []
    for got, (c, d) in zip(streamed, frames + frames[:1]):
        _same_poses(got, fx["det"].detect(c, d, 1))


def test_multi_model_delta_transport_equals_jax():
    """MultiModelPoseDetection with delta_transport on the fixture and a
    synthetic class equals JAX's on the same route and the golden of the
    default route; it has no host-quantize route, as JAX's has none."""
    from linemod_tpu.config import ModelProperties as JaxProps
    from linemod_tpu.config import load_model_properties as jax_props
    from linemod_tpu.config import load_settings as jax_settings
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.pipeline.multi_model import MultiModelPoseDetection as JaxMulti
    from linemod_tpu_torch.config import ModelProperties, load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank, make_synthetic_bank
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection
    from linemod_tpu_torch.utils.png import read_png

    golden = np.load(MULTI_REF)
    jcam, jsettings = jax_settings(SETTINGS)
    jdet = JaxMulti({"lagergehaeuse": JaxBank.load(BANK), "synthetic": jax_synthetic(1950, seed=11, bbox_wh=64)},
                    jcam, jsettings, {"lagergehaeuse": jax_props(MODEL), "synthetic": JaxProps()})
    cam, settings = load_settings(SETTINGS)
    det = MultiModelPoseDetection(
        {"lagergehaeuse": TemplateBank.load(BANK), "synthetic": make_synthetic_bank(1950, seed=11, bbox_wh=64)},
        cam, settings, {"lagergehaeuse": load_model_properties(MODEL), "synthetic": ModelProperties()}, "cpu",
    )
    assert det.delta_transport is False and det.host_quant is False
    jdet.delta_transport = det.delta_transport = True
    color, depth = read_png(IMG0, "color"), read_png(DEPTH0, "anydepth")
    want = np.asarray(jdet.detect_submit(color, depth)[0])
    handle = det.detect_submit(color, depth)
    got = handle[0].numpy()
    assert got.shape == want.shape == (1024, 5)
    _assert_packed_equal(got, want)
    _assert_packed_equal(got, golden["packed"])
    out, jout = det._collect(handle, det.class_ids, 1, None), jdet.detect_all(color, depth, 1)
    for c in ("lagergehaeuse", "synthetic"):
        assert len(out[c]) == len(jout[c])
    _same_poses(out["lagergehaeuse"], jout["lagergehaeuse"])
