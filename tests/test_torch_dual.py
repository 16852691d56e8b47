"""The port's dual-modality path (color gradients and depth normals, T=5/8)
against the JAX reference on the CPU.

- `quantize_normals` on the fixture's depth (both pyramid levels) and on
  seeded synthetic depth with holes, 50 mm steps and slopes near the bins'
  edges: exact, slope magnitudes included;
- the dual match state built from the committed dual bank and from the
  cube bank of tests/test_dual_modality.py (built by JAX, carried over as
  arrays): every leaf equal to JAX's, and a JAX dual state's leaves carried
  over unchanged;
- `detect_frame_dual` on the cube bank: packed arrays equal to JAX's;
- the port's versions of tests/test_dual_modality.py's bank and detection
  cases, on frames the port's own renderer draws, to the same bounds (the
  delta-encoded transport is left out, as in the port);
- the fixture frame with the dual bank: normal maps, packed [512, 5], pose,
  the masked max's template maxes and the VSD / ADD scores against
  `tests/goldens/img0_dual_ref.npz`; the forced prefiltered and streaming
  cuts equal to the dense cut; a saturated dual bank retried with depth.

Tolerances: normal maps, state leaves, template ids, x, y, valid flags and
maxes exact; similarities atol 1e-4 (equal in practice); the pose 1e-6 mm
and 1e-9 (the same float64 pose math on identical matches); VSD and ADD
atol 1e-3 of the golden's (the port's renders equal JAX's, tests/
test_torch_render.py).

Regenerate the golden (JAX on the CPU, about a minute) with
`env JAX_PLATFORMS=cpu python tests/test_torch_dual.py`;
`test_dual_golden_equals_live_jax` keeps it from drifting.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_e2e_fixture import _assert_packed_equal
from test_torch_matching import _jax_state_parts

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
DUAL_BANK = os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")
DUAL_REF = os.path.join(REPO, "tests", "goldens", "img0_dual_ref.npz")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")
SCORE_ATOL = 1e-3


def _fixture_files():
    return {
        "settings": os.path.join(EXAMPLE, "linemod_settings.yml"),
        "model": os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"),
        "img0": os.path.join(EXAMPLE, "benchmark", "img0.png"),
        "depth0": os.path.join(EXAMPLE, "benchmark", "depth0.png"),
        "pose0": os.path.join(EXAMPLE, "benchmark", "pose0.yml"),
    }


def _port_bank(jbank):
    """A JAX TemplateBank's arrays as the port's TemplateBank."""
    from linemod_tpu_torch.models.template_bank import TemplateBank

    return TemplateBank(**{f.name: getattr(jbank, f.name) for f in dataclasses.fields(TemplateBank)})


# ------------------------------------------------------- quantize_normals ---

def _synthetic_depth(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    """Integer-mm depth: tiles of planes whose slopes point near the 8 bins'
    edges (22.5 + 45 k degrees), 50 / 49 / 51 mm steps, holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = np.zeros((h, w))
    for ty in range(0, h, 32):
        for tx in range(0, w, 32):
            k = rng.integers(0, 8)
            theta = np.radians(22.5 + 45.0 * k + rng.uniform(-0.3, 0.3))
            r = rng.uniform(1.0, 20.0)
            tile = (slice(ty, ty + 32), slice(tx, tx + 32))
            depth[tile] = 700.0 + r * (np.cos(theta) * xx[tile] + np.sin(theta) * yy[tile])
    depth = np.round(depth)
    for col, step in zip(rng.choice(np.arange(4, w - 4), 3, replace=False), (50.0, 49.0, 51.0)):
        depth[:, col:] += step
    depth[rng.uniform(size=(h, w)) < 0.05] = 0.0
    y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
    depth[y0 : y0 + 8, x0 : x0 + 8] = 0.0
    return depth.astype(np.float32)


def _normals_pair(depth: np.ndarray):
    from linemod_tpu.ops.normals import quantize_normals as jax_normals
    from linemod_tpu_torch.ops.normals import quantize_normals

    got = [t.numpy() for t in quantize_normals(torch.from_numpy(depth))]
    want = [np.asarray(a) for a in jax_normals(jnp.asarray(depth))]
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_normals_equals_jax_on_synthetic_depth(seed):
    depth = _synthetic_depth(seed)
    (q, mag2), (jq, jmag2) = _normals_pair(depth)
    assert q.dtype == np.uint8 and mag2.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(mag2, jmag2)
    assert len(np.unique(q)) >= 8  # most bins and "no orientation" occur


@pytest.mark.parametrize("level", [0, 1])
def test_quantize_normals_equals_jax_on_fixture_depth(level):
    from linemod_tpu_torch.utils.png import read_png

    depth = read_png(_fixture_files()["depth0"], "anydepth").astype(np.float32)
    if level:
        depth = np.ascontiguousarray(depth[::2, ::2])
    (q, mag2), (jq, jmag2) = _normals_pair(depth)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(mag2, jmag2)
    assert (q > 0).sum() > 1000


# ---------------------------------------------------- the cube dual bank ---

@pytest.fixture(scope="module")
def cube():
    """tests/test_dual_modality.py's setup: a cube's dual bank built by JAX,
    as a JAX PoseDetection and a port PoseDetection of the same arrays."""
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
    jdet = JaxDetection(jbank, JCam(**cam_kw), JSettings(**set_kw), JProps(**props_kw))
    cam = CameraParameters(**cam_kw)
    det = PoseDetection(_port_bank(jbank), cam, TemplateSettings(**set_kw), ModelProperties(**props_kw), "cpu")
    return jdet, det, cam, mesh


def _cube_frame(cube, t, offset=(0.0, 0.0)):
    """The port's render of template t's rotation at (ox, oy, 600) mm:
    (color uint8 BGR, depth uint16 mm)."""
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render_views
    from linemod_tpu_torch.utils.geometry import quat_to_mat

    _, det, cam, mesh = cube
    rot = quat_to_mat(det.bank.quat[t]).astype(np.float32)
    depth, color = render_views(
        mesh_to_arrays(mesh, "cpu"), rot[None], np.array([[offset[0], offset[1], 600.0]], np.float32),
        cam, with_color=True,
    )
    return (color[0].numpy() * 255).astype(np.uint8), depth[0].numpy().astype(np.uint16)


@pytest.mark.parametrize("bank_kind", ["cube", "fixture"])
def test_dual_match_state_equals_jax(cube, bank_kind):
    """build_match_state on the dual bank (T=5/8, the normal planes past the
    color planes) equals JAX's leaf for leaf; match_state_from_numpy takes
    a JAX dual state's leaves unchanged; make_match_config equals JAX's."""
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu.pipeline.pose_detection import _pad_bank as jax_pad
    from linemod_tpu.pipeline.pose_detection import make_match_config as jax_config
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings
    from linemod_tpu_torch.ops.matching import (
        META_FIELDS,
        TENSOR_FIELDS,
        build_match_state,
        match_state_from_numpy,
    )
    from linemod_tpu_torch.pipeline.pose_detection import make_match_config

    if bank_kind == "cube":
        jdet, det, cam, _ = cube
        jbank = jdet.bank
        jcam = JCam(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height)
    else:
        jbank = JaxBank.load(DUAL_BANK)
        cam, jcam = CameraParameters(), JCam()
    assert jbank.dual_modality
    cfg = make_match_config(cam, TemplateSettings(), jbank.num_templates, dual_modality=True)
    jcfg = jax_config(jcam, JSettings(), True, jbank.num_templates)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.t_fine, cfg.t_coarse, cfg.dual_modality) == (5, 8, True)
    jstate = jax_build(jax_pad(jbank, jcfg.template_chunk), jcfg)
    from linemod_tpu_torch.models.template_bank import _pad_bank

    state = build_match_state(_pad_bank(_port_bank(jbank), cfg.template_chunk), cfg, "cpu")
    carried = match_state_from_numpy(*_jax_state_parts(jstate), "cpu")
    for k in TENSOR_FIELDS:
        want = np.asarray(getattr(jstate, k))
        for got in (getattr(state, k), getattr(carried, k)):
            assert got.dtype == torch.int32, k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for k in META_FIELDS:
        assert getattr(state, k) == getattr(carried, k), k
    # the normal features sit on planes 8 t^2 .. 16 t^2 - 1, the zero plane is 16 t^2
    p = state.off3_coarse[..., 0]
    assert int(p.max()) == 2 * 8 * 64 and int(((p >= 512) & (p < 1024)).sum()) > 0
    assert state.coarse_plan.planes_shape[0] == 2 * 8 * 64 + 1
    assert int(state.off3_fine[..., 0].max()) == 2 * 8 * 25


@pytest.mark.parametrize("frame", ["rendered", "random"])
def test_cube_detect_frame_dual_equals_jax(cube, frame):
    from linemod_tpu.ops.detect_core import detect_frame_dual as jax_detect
    from linemod_tpu_torch.ops.detect_core import detect_frame_dual

    jdet, det, _, _ = cube
    if frame == "rendered":
        color, depth = _cube_frame(cube, 4, (40.0, -30.0))
    else:
        rng = np.random.default_rng(3)
        color = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
        depth = rng.uniform(400, 900, (480, 640)).astype(np.uint16)
    depthf = depth.astype(np.float32)
    want = np.asarray(jax_detect(jdet.state, jnp.asarray(color), jnp.asarray(depthf)))
    got = detect_frame_dual(det.state, torch.from_numpy(color), torch.from_numpy(depthf)).numpy()
    assert got.shape == want.shape
    _assert_packed_equal(got, want)
    assert want[:, 4].sum() > 0


def test_cube_bank_has_normal_features(cube):
    _, det, _, _ = cube
    bank = det.bank
    assert bank.dual_modality and bank.nfeat0 is not None
    assert np.all(bank.nvalid0.sum(1) >= 4)
    n = bank.num_templates
    np.testing.assert_array_equal(det.state.nf_fine[:n].numpy(), bank.valid0.sum(1) + bank.nvalid0.sum(1))


def test_cube_dual_detect(cube):
    _, det, _, _ = cube
    poses = det.detect(*_cube_frame(cube, 4), 1)
    assert len(poses) == 1
    p = poses[0]
    assert abs(p.translation[2] - 600) < 25
    assert abs(p.translation[0]) < 15 and abs(p.translation[1]) < 15


def test_cube_dual_detect_off_centre(cube):
    """Off-centre objects match as well as centred ones (the coarse -> fine
    window origin is the exact fine cell (g * 2 * t_coarse) // t_fine)."""
    _, det, _, _ = cube
    for ox, oy in [(0.0, 0.0), (170.0, 90.0), (-160.0, -80.0)]:
        handle = det.detect_submit(*_cube_frame(cube, 4, (ox, oy)))
        packed = handle[0].numpy()
        valid = packed[:, 4] > 0.5
        assert valid.any(), f"no match at offset ({ox}, {oy})"
        assert float(packed[valid, 3].max()) > 85.0
        poses = det.detect_collect(handle, 1)
        assert len(poses) == 1
        p = poses[0]
        assert abs(p.translation[0] - ox) < 20
        assert abs(p.translation[1] - oy) < 20
        assert abs(p.translation[2] - 600) < 30


def test_cube_fine_window_mapping_exact_under_translation(cube):
    """A translation by multiples of t_fine = 5 that are not multiples of
    the 16-px coarse cell keeps the best fine similarity and moves the match
    by exactly the shift."""
    _, det, _, _ = cube
    color0, depth0 = _cube_frame(cube, 4)

    def best(colour, dep):
        packed = det.detect_submit(colour, dep)[0].numpy()
        valid = packed[:, 4] > 0.5
        assert valid.any()
        i = np.argmax(np.where(valid, packed[:, 3], -1))
        return packed[i, 3], packed[i, 1], packed[i, 2]

    sim0, x0, y0 = best(color0, depth0)
    for dx, dy in [(85, 45), (165, 0), (0, 125), (-90, -35)]:
        sim, x, y = best(np.roll(color0, (dy, dx), axis=(0, 1)), np.roll(depth0, (dy, dx), axis=(0, 1)))
        assert sim >= sim0 - 1e-3, f"shift ({dx},{dy}): sim {sim} vs {sim0}"
        assert (x - x0, y - y0) == (dx, dy)


# ------------------------------------------- the fixture with the dual bank ---

def jax_dual_reference():
    """The JAX reference on the fixture frame with the dual bank (CPU).
    Returns (the golden's arrays, the JAX detector)."""
    import cv2
    import jax

    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.ops.detect_core import detect_frame_dual
    from linemod_tpu.ops.extract import downsample2
    from linemod_tpu.ops.matching import _planes_3d, _template_maxes
    from linemod_tpu.ops.normals import quantize_normals
    from linemod_tpu.pipeline.benchmark import Benchmark, read_ground_truth_pose
    from linemod_tpu.pipeline.pose_detection import PoseDetection
    from linemod_tpu.types import ObjectPose
    from linemod_tpu.utils.ply import load_ply

    f = _fixture_files()
    cam, settings = load_settings(f["settings"])
    settings = dataclasses.replace(settings, only_color_modality=False)
    det = PoseDetection(TemplateBank.load(DUAL_BANK), cam, settings, load_model_properties(f["model"]))
    state = det.state
    color = cv2.imread(f["img0"])
    depth = cv2.imread(f["depth0"], cv2.IMREAD_ANYDEPTH)
    color_c = det.recenter(np.ascontiguousarray(color))
    depth_c = det.recenter(np.ascontiguousarray(depth))
    depthf = jnp.asarray(depth_c.astype(np.float32))
    pose = det.detect(color, depth, 1)[0]
    planes = _planes_3d(downsample2(jnp.asarray(color_c.astype(np.float32))), depthf[::2, ::2],
                        state.cfg.t_coarse, state.max_cells_coarse, True)
    bench = Benchmark(load_ply(f["model"]), cam)
    gt = read_ground_truth_pose(f["pose0"])
    scene = depth_c.astype(np.float32)
    color_ref = np.load(TORCH_REF)
    color_pose = ObjectPose(translation=color_ref["translation"], quaternion=color_ref["quaternion"])
    ref = {
        "packed": np.asarray(detect_frame_dual(state, jnp.asarray(color_c), jnp.asarray(depth_c))),
        "quaternion": np.asarray(pose.quaternion, np.float64),
        "translation": np.asarray(pose.translation, np.float64),
        "nquant0": np.asarray(quantize_normals(depthf)[0]),
        "nquant1": np.asarray(quantize_normals(depthf[::2, ::2])[0]),
        "maxes": np.asarray(jax.jit(_template_maxes)(state, planes)),
        "render0": np.asarray(bench._render(gt)),
        "vsd": np.asarray(bench.score_vsd(scene, gt, pose)),
        "add": np.asarray(bench.score_add(gt, pose)),
        "color_vsd": np.asarray(bench.score_vsd(scene, gt, color_pose)),
    }
    return ref, det


@pytest.fixture(scope="module")
def dual_fixture():
    """The port's PoseDetection with the dual bank on the fixture frame:
    (detector, packed, poses, color, depth)."""
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    f = _fixture_files()
    cam, settings = load_settings(f["settings"])
    settings = dataclasses.replace(settings, only_color_modality=False)
    det = PoseDetection(TemplateBank.load(DUAL_BANK), cam, settings, load_model_properties(f["model"]), "cpu")
    color, depth = read_png(f["img0"], "color"), read_png(f["depth0"], "anydepth")
    handle = det.detect_submit(color, depth)
    packed = handle[0].numpy()
    return det, packed, det.detect_collect(handle, 1), color, depth


def test_dual_bank_size():
    from linemod_tpu_torch.models.template_bank import TemplateBank

    bank = TemplateBank.load(DUAL_BANK)
    assert bank.dual_modality and bank.num_templates == 1950  # 13 views x 15 radii x 10 rolls
    assert bank.nvalid0.sum(1).min() >= 1 and bank.nvalid1.sum(1).min() >= 1


def test_dual_fixture_normal_maps_equal_golden(dual_fixture):
    from linemod_tpu_torch.ops.normals import quantize_normals

    det, _, _, _, depth = dual_fixture
    ref = np.load(DUAL_REF)
    depth_c = torch.from_numpy(det.recenter(np.ascontiguousarray(depth)).astype(np.float32))
    np.testing.assert_array_equal(quantize_normals(depth_c)[0].numpy(), ref["nquant0"])
    np.testing.assert_array_equal(quantize_normals(depth_c[::2, ::2])[0].numpy(), ref["nquant1"])


def test_dual_fixture_packed_and_pose_equal_golden(dual_fixture):
    det, packed, poses, _, _ = dual_fixture
    ref = np.load(DUAL_REF)
    assert det.state.cfg.dual_modality and det.state.cfg.t_fine == 5
    assert packed.shape == ref["packed"].shape == (512, 5) and packed[:, 4].sum() > 0
    _assert_packed_equal(packed, ref["packed"])
    assert len(poses) == 1
    np.testing.assert_allclose(poses[0].translation, ref["translation"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(poses[0].quaternion, ref["quaternion"], rtol=0, atol=1e-9)


def test_dual_fixture_template_maxes_equal_golden(dual_fixture):
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.matching import _planes_3d, _template_maxes

    det, _, _, color, depth = dual_fixture
    state = det.state
    color_c = torch.from_numpy(det.recenter(np.ascontiguousarray(color))).float()
    depth_c = torch.from_numpy(det.recenter(np.ascontiguousarray(depth)).astype(np.float32))
    planes = _planes_3d(downsample2(color_c), state.cfg.t_coarse, state.max_cells_coarse, depth_c[::2, ::2])
    assert planes.shape[0] == 2 * 8 * 64 + 1
    np.testing.assert_array_equal(_template_maxes(state, planes).numpy(), np.load(DUAL_REF)["maxes"])


def test_dual_fixture_scores_equal_golden(dual_fixture):
    """The dual and the color fixture poses scored by the port's Benchmark
    (VSD, ADD) equal JAX's scores in the golden, and JAX's color pose meets
    the reference's criteria."""
    from linemod_tpu_torch.pipeline.benchmark import Benchmark, read_ground_truth_pose
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.ply import load_ply

    det, _, poses, _, depth = dual_fixture
    ref = np.load(DUAL_REF)
    f = _fixture_files()
    bench = Benchmark(load_ply(f["model"]), det.cam, "cpu")
    gt = read_ground_truth_pose(f["pose0"])
    scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
    assert bench.score_vsd(scene, gt, poses[0]) == pytest.approx(float(ref["vsd"]), abs=SCORE_ATOL)
    assert bench.score_add(gt, poses[0]) == pytest.approx(float(ref["add"]), abs=SCORE_ATOL)
    color_ref = np.load(TORCH_REF)
    color_pose = ObjectPose(translation=color_ref["translation"], quaternion=color_ref["quaternion"])
    color_vsd = bench.score_vsd(scene, gt, color_pose)
    assert color_vsd == pytest.approx(float(ref["color_vsd"]), abs=SCORE_ATOL) and color_vsd < 0.3


@pytest.mark.parametrize("cut", ["prefiltered", "streaming"])
def test_dual_forced_cuts_equal_dense(dual_fixture, cut):
    """The dual state with the prefiltered cut forced through cfg
    (prefilter_sel 1024, proved exact) or the streaming cut (scan_chunk
    512) gives the dense cut's packed array exactly."""
    from linemod_tpu_torch.ops.detect_core import detect_frame_dual

    det, packed, _, color, depth = dual_fixture
    over = dict(prefilter_sel=1024, scan_chunk=4096) if cut == "prefiltered" else dict(scan_chunk=512)
    state = dataclasses.replace(det.state, cfg=dataclasses.replace(det.state.cfg, **over))
    got = detect_frame_dual(
        state, torch.from_numpy(det.recenter(np.ascontiguousarray(color))),
        torch.from_numpy(det.recenter(np.ascontiguousarray(depth)).astype(np.float32)),
    ).numpy()
    if cut == "prefiltered":
        assert got.shape == (513, 5) and got[-1, 0] == 1.0
        got = got[:-1]
    np.testing.assert_array_equal(got, packed)


def test_dual_saturated_bank_is_retried_with_depth(dual_fixture):
    """64 copies of one dual fixture template, threshold 0, prefilter_sel 20:
    the proof fails and the frame is re-run on the streaming cut, with its
    depth, giving the streaming cut's result."""
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.ops.detect_core import detect_frame_dual
    from linemod_tpu_torch.pipeline.pose_detection import (
        PoseDetection,
        make_match_config,
        resolve_prefilter_packed,
    )

    bank = dataclasses.replace(dual_fixture[0].bank)
    rows = np.zeros(64, np.int64) + 700
    for name in ("feat0", "valid0", "feat1", "valid1", "nfeat0", "nvalid0", "nfeat1", "nvalid1",
                 "bbox", "quat", "z", "median_depth", "hull"):
        setattr(bank, name, getattr(bank, name)[rows])
    cam = CameraParameters(fx=500.0, fy=500.0, cx=160.0, cy=120.0, width=320, height=240)
    settings = TemplateSettings(detector_threshold=0.0, use_depth_improvement=False, only_color_modality=False)
    cfg = dataclasses.replace(make_match_config(cam, settings, 64, dual_modality=True),
                              prefilter_sel=20, top_k=16, scan_chunk=16)
    det = PoseDetection(bank, cam, settings, ModelProperties(), "cpu", cfg=cfg)
    rng = np.random.default_rng(0)
    color = rng.uniform(0, 255, (240, 320, 3)).astype(np.uint8)
    depth = rng.uniform(500, 700, (240, 320)).astype(np.uint16)
    packed = det.detect_submit(color, depth)[0].numpy()
    assert packed.shape == (17, 5) and packed[-1, 0] == 0.0
    resolved = resolve_prefilter_packed(packed, det, color, depth)
    assert det.retries == 1
    want = detect_frame_dual(det.exact_state, torch.from_numpy(color),
                             torch.from_numpy(depth.astype(np.float32))).numpy()
    np.testing.assert_array_equal(resolved, want)
    assert want[:, 4].sum() > 0


def test_dual_golden_equals_live_jax():
    """The committed golden the card is checked against is what the JAX
    reference computes now, and JAX's dual pose meets the reference's
    criteria (VSD < 0.3, ADD <= 21 mm)."""
    ref = jax_dual_reference()[0]
    golden = np.load(DUAL_REF)
    assert sorted(golden.files) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(golden[k], ref[k], err_msg=k)
    assert float(ref["vsd"]) < 0.3 and float(ref["add"]) <= 21.0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_dual_reference()[0]
    np.savez_compressed(DUAL_REF, **arrays)
    print(f"wrote {DUAL_REF}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))
    print(f"JAX dual pose: VSD {float(arrays['vsd']):.4f}, ADD {float(arrays['add']):.3f} mm; "
          f"JAX color pose VSD {float(arrays['color_vsd']):.4f}")
