"""The port's multi-class detection (pipeline/multi_model.py) against the JAX
reference on the CPU: the seven cases of tests/test_multi_model.py, the
fixture with a second, synthetic class (the shape chip_smoke.py runs on the
card), and make_match_config's n_classes.

The cube, tetrahedron and octahedron banks are built by JAX's
build_template_bank here (a few seconds each) and carried over as arrays;
the scenes are drawn by the port's renderer and fed to both sides.

Tolerances: banks, offsets, packed candidates (ints exact, similarities
atol 1e-4, equal in practice) and ICP-off poses exact (the same float64
pose math on the same matches); errors of the consistency check equal.
With ICP on, the stream must equal the port's detect_all exactly and meet
tests/test_multi_model.py's gate (the ICP pose is not held to JAX's: the
reference's ICP is chaotic at the float32 level, see
tests/test_torch_icp.py). `tests/goldens/img0_multi_ref.npz` holds JAX's
packed [1024, 5] and per-class poses on the fixture frame with the fixture
bank and make_synthetic_bank(1950, seed=11, bbox_wh=64); regenerate it with
`env JAX_PLATFORMS=cpu python tests/test_torch_multi_model.py`.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_e2e_fixture import _assert_packed_equal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
MULTI_REF = os.path.join(REPO, "tests", "goldens", "img0_multi_ref.npz")
PLACEMENTS = {"cube": (-110.0, 0.0, 600.0), "tetra": (110.0, 20.0, 600.0)}
CROWD = [
    ("cube", (-220.0, -110.0, 600.0)), ("cube", (-110.0, 110.0, 600.0)),
    ("cube", (0.0, -110.0, 600.0)), ("cube", (110.0, 110.0, 600.0)),
    ("cube", (220.0, -110.0, 600.0)), ("cube", (-220.0, 110.0, 600.0)),
    ("tetra", (110.0, -110.0, 620.0)), ("octa", (-110.0, -110.0, 620.0)),
]


def _port_bank(jbank):
    from linemod_tpu_torch.models.template_bank import TemplateBank

    return TemplateBank(**{f.name: getattr(jbank, f.name) for f in dataclasses.fields(TemplateBank)})


def _port_mesh(jmesh):
    from linemod_tpu_torch.utils.ply import Mesh

    return Mesh(vertices=jmesh.vertices, colors=jmesh.colors, indices=jmesh.indices, normals=jmesh.normals)


@pytest.fixture(scope="module")
def setup():
    """tests/test_multi_model.py's setup, both sides: cameras, settings,
    props, meshes and the three banks (JAX's and the port's)."""
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import ModelProperties as JProps
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.models.template_bank import build_template_bank
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from test_matching import cube_mesh
    from test_multi_model import octa_mesh, tetra_mesh

    cam_kw = dict(fx=500.0, fy=500.0, cx=320, cy=240, width=640, height=480)
    set_kw = dict(distance_start=600, distance_stop=600, distance_step=50, subdivisions=0, angle_start=-45,
                  angle_stop=45, angle_step=45, detector_threshold=80.0, use_depth_improvement=True,
                  depth_offset=0.0)
    props_kw = dict(lower_color_range=(0.0, 0.0, 0.0), upper_color_range=(255.0, 255.0, 255.0),
                    rotationally_symmetrical=False, planes_of_symmetry=(1.0, 1.0, 1.0))
    jax_side = (JCam(**cam_kw), JSettings(**set_kw), JProps(**props_kw))
    meshes = {"cube": cube_mesh(), "tetra": tetra_mesh(), "octa": octa_mesh()}
    jbanks = {c: build_template_bank(m, c, *jax_side) for c, m in meshes.items()}
    port_side = (CameraParameters(**cam_kw), TemplateSettings(**set_kw), ModelProperties(**props_kw))
    return dict(jax=jax_side, port=port_side, jmeshes=meshes,
                meshes={c: _port_mesh(m) for c, m in meshes.items()},
                jbanks=jbanks, banks={c: _port_bank(b) for c, b in jbanks.items()})


def _scene(setup, placements):
    """The classes at their placements (template 4's rotation), drawn by
    the port's renderer and composited by z-buffer: (color uint8 BGR,
    depth uint16)."""
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render_views
    from linemod_tpu_torch.utils.geometry import quat_to_mat

    cam = setup["port"][0]
    depth_acc = np.zeros((480, 640), np.float32)
    color_acc = np.zeros((480, 640, 3), np.float32)
    for c, pos in placements:
        rot = quat_to_mat(setup["banks"][c].quat[4]).astype(np.float32)
        d, col = render_views(mesh_to_arrays(setup["meshes"][c], "cpu"), rot[None],
                              np.array([pos], np.float32), cam, with_color=True)
        d, col = d[0].numpy(), col[0].numpy()
        closer = (d > 0) & ((depth_acc == 0) | (d < depth_acc))
        depth_acc = np.where(closer, d, depth_acc)
        color_acc = np.where(closer[..., None], col, color_acc)
    return (color_acc * 255).astype(np.uint8), depth_acc.astype(np.uint16)


@pytest.fixture(scope="module")
def two_class(setup):
    """The two-class scene and both sides' detectors (ICP off)."""
    from linemod_tpu.pipeline.multi_model import MultiModelPoseDetection as JaxMulti
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection

    classes = ("cube", "tetra")
    cam, settings, props = setup["port"]
    jcam, jsettings, jprops = setup["jax"]
    det = MultiModelPoseDetection({c: setup["banks"][c] for c in classes}, cam, settings,
                                  {c: props for c in classes}, "cpu", model_files=["cube.ply", "tetra.ply"])
    jdet = JaxMulti({c: setup["jbanks"][c] for c in classes}, jcam, jsettings, {c: jprops for c in classes},
                    model_files=["cube.ply", "tetra.ply"])
    return det, jdet, _scene(setup, PLACEMENTS.items())


def _same_poses(got: dict, want: dict):
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c]), c
        for a, b in zip(got[c], want[c]):
            np.testing.assert_array_equal(a.translation, b.translation)
            np.testing.assert_array_equal(a.quaternion, b.quaternion)
            assert tuple(a.bounding_box) == tuple(b.bounding_box)


def test_concat_banks_offsets_equal_jax(setup):
    from linemod_tpu.models.template_bank import concat_banks as jax_concat
    from linemod_tpu_torch.models.template_bank import concat_banks

    combined, offsets = concat_banks([setup["banks"]["cube"], setup["banks"]["tetra"]])
    jcombined, joffsets = jax_concat([setup["jbanks"]["cube"], setup["jbanks"]["tetra"]])
    np.testing.assert_array_equal(offsets, joffsets)
    assert offsets[1] == setup["banks"]["cube"].num_templates
    assert combined.class_id == jcombined.class_id == "cube+tetra"
    for f in ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull"):
        np.testing.assert_array_equal(getattr(combined, f), getattr(jcombined, f), err_msg=f)


@pytest.mark.parametrize("ids,files", [
    (["a", "b"], ["models/b.ply", "models/a.ply"]),
    (["a"], ["a.ply", "b.ply"]),
    (["a", "c"], ["a.ply", "b.ply"]),
], ids=["consistent", "count", "id"])
def test_consistency_check_equals_jax(ids, files):
    from linemod_tpu.pipeline.multi_model import check_bank_model_consistency as jax_check
    from linemod_tpu_torch.pipeline.multi_model import check_bank_model_consistency

    def outcome(fn):
        try:
            fn(ids, files)
        except ValueError as e:
            return str(e)
        return None

    got = outcome(check_bank_model_consistency)
    assert got == outcome(jax_check)
    assert (got is None) == (ids == ["a", "b"])


def test_detect_both_classes_one_frame_equals_jax(two_class):
    import jax.numpy as jnp

    from linemod_tpu.ops.detect_core import detect_frame as jax_detect_frame

    det, jdet, (color, depth) = two_class
    assert det.state.cfg.top_k == jdet.state.cfg.top_k == 1024
    handle = det.detect_submit(color, depth)
    want_packed = np.asarray(jax_detect_frame(jdet.state, jnp.asarray(det.recenter(color))))
    _assert_packed_equal(handle[0].numpy(), want_packed)
    out = det._collect(handle, det.class_ids, 1, None)
    _same_poses(out, jdet.detect_all(color, depth, num_objects=1))
    for c, poses in out.items():
        assert len(poses) == 1, f"{c} not detected"
        exp = PLACEMENTS[c]
        t = poses[0].translation
        assert abs(t[0] - exp[0]) < 20 and abs(t[1] - exp[1]) < 20 and abs(t[2] - exp[2]) < 30, c


def test_detect_all_stream_matches_sync(two_class):
    det, _, (color, depth) = two_class
    ref = det.detect_all(color, depth, num_objects=1)
    outs = list(det.detect_all_stream([(color, depth)] * 3, num_objects=1, pipeline_depth=1))
    assert len(outs) == 3
    for out in outs:
        _same_poses(out, ref)


def test_detect_all_stream_with_icp(setup, two_class):
    """Every class's refine and verify submitted in stage 1 and collected in
    stage 2; the stream equals the port's detect_all exactly. The scene
    sits at the verify cut (z = 600 mm), so the masks are nearly empty and
    only x is gated, as in tests/test_multi_model.py (which holds JAX's
    ICP-on poses to the same gate)."""
    from linemod_tpu_torch.ops.icp import IcpRefiner
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection

    _, _, (color, depth) = two_class
    classes = ("cube", "tetra")
    cam, settings, props = setup["port"]
    icps = {c: IcpRefiner(setup["meshes"][c], cam, 2, mesh_arrays=mesh_to_arrays(setup["meshes"][c], "cpu"))
            for c in classes}
    det = MultiModelPoseDetection({c: setup["banks"][c] for c in classes}, cam,
                                  dataclasses.replace(settings, use_icp=True), {c: props for c in classes}, "cpu",
                                  icps=icps)
    ref = det.detect_all(color, depth, num_objects=1)
    outs = list(det.detect_all_stream([(color, depth)] * 2, num_objects=1, pipeline_depth=1))
    assert len(outs) == 2
    for out in outs:
        _same_poses(out, ref)
    for c in classes:
        assert ref[c], f"{c} not detected with ICP on"
        assert abs(ref[c][0].translation[0] - PLACEMENTS[c][0]) < 40, c


def test_no_class_starvation_in_crowded_frame(setup):
    """Six cubes, a tetrahedron and an octahedron: top_k = 512 x 3, and
    neither minority class is crowded out; the poses equal JAX's."""
    from linemod_tpu.pipeline.multi_model import MultiModelPoseDetection as JaxMulti
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection

    cam, settings, props = setup["port"]
    jcam, jsettings, jprops = setup["jax"]
    classes = ("cube", "tetra", "octa")
    det = MultiModelPoseDetection({c: setup["banks"][c] for c in classes}, cam, settings,
                                  {c: props for c in classes}, "cpu")
    assert det.state.cfg.top_k == 512 * 3
    color, depth = _scene(setup, CROWD)
    out = det.detect_all(color, depth, num_objects=6)
    jdet = JaxMulti({c: setup["jbanks"][c] for c in classes}, jcam, jsettings, {c: jprops for c in classes})
    _same_poses(out, jdet.detect_all(color, depth, num_objects=6))
    assert len(out["cube"]) >= 4, f"cubes: {len(out['cube'])}"
    assert len(out["tetra"]) >= 1 and len(out["octa"]) >= 1
    for c, want in [("tetra", (110.0, -110.0)), ("octa", (-110.0, -110.0))]:
        got = out[c][0].translation
        assert abs(got[0] - want[0]) < 25 and abs(got[1] - want[1]) < 25, c


def test_single_class_restriction_equals_jax(two_class):
    from linemod_tpu_torch.pipeline.pose_detection import DetectionDebug

    det, jdet, (color, depth) = two_class
    dbg = DetectionDebug()
    poses = det.detect("cube", color, depth, num_objects=4, debug=dbg)
    _same_poses({"cube": poses}, {"cube": jdet.detect("cube", color, depth, num_objects=4)})
    assert len(poses) >= 1 and dbg.num_raw_matches > 0 and dbg.groups_kept >= 1
    for p in poses:
        assert p.translation[0] < 0  # only the cube's side


@pytest.mark.parametrize("n_templates,n_classes", [(2048, 1), (3900, 2), (600, 3), (96300, 2)])
def test_make_match_config_n_classes_equals_jax(n_templates, n_classes):
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.pipeline.pose_detection import make_match_config as jax_config
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings
    from linemod_tpu_torch.pipeline.pose_detection import make_match_config

    cfg = make_match_config(CameraParameters(), TemplateSettings(), n_templates, n_classes=n_classes)
    jcfg = jax_config(JCam(), JSettings(), False, n_templates, n_classes=n_classes)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.top_k == 512 * n_classes
    assert cfg.prefilter_sel == (max(2 * cfg.top_k, 1024) if n_templates > 8192 else 0)


# ----------------------------------------- the fixture with a second class ---

def jax_multi_reference():
    """JAX's MultiModelPoseDetection on the fixture frame with the fixture
    bank and a synthetic second class (CPU): the golden's arrays."""
    import cv2
    import jax.numpy as jnp

    from linemod_tpu.config import ModelProperties, load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank, make_synthetic_bank
    from linemod_tpu.ops.detect_core import detect_frame
    from linemod_tpu.pipeline.multi_model import MultiModelPoseDetection

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    banks = {"lagergehaeuse": TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")),
             "synthetic": make_synthetic_bank(1950, seed=11, bbox_wh=64)}
    det = MultiModelPoseDetection(banks, cam, settings,
                                  {"lagergehaeuse": load_model_properties(model), "synthetic": ModelProperties()})
    color = cv2.imread(os.path.join(EXAMPLE, "benchmark", "img0.png"))
    depth = cv2.imread(os.path.join(EXAMPLE, "benchmark", "depth0.png"), cv2.IMREAD_ANYDEPTH)
    out = det.detect_all(color, depth, num_objects=1)
    pose = out["lagergehaeuse"][0]
    return {
        "packed": np.asarray(detect_frame(det.state, jnp.asarray(det.recenter(color)))),
        "translation": np.asarray(pose.translation, np.float64),
        "quaternion": np.asarray(pose.quaternion, np.float64),
        "synthetic_poses": np.array([len(out["synthetic"])], np.int64),
    }


def test_fixture_two_classes_equal_golden():
    """The fixture bank and 1,950 synthetic templates: 3,900 templates
    padded to 4,096, top_k 1,024; the packed [1024, 5] and the fixture
    class's pose equal JAX's."""
    from linemod_tpu_torch.config import ModelProperties, load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank, make_synthetic_bank
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection
    from linemod_tpu_torch.utils.png import read_png

    golden = np.load(MULTI_REF)
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    banks = {"lagergehaeuse": TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")),
             "synthetic": make_synthetic_bank(1950, seed=11, bbox_wh=64)}
    det = MultiModelPoseDetection(banks, cam, settings,
                                  {"lagergehaeuse": load_model_properties(model), "synthetic": ModelProperties()},
                                  "cpu")
    assert det.state.n_templates == 4096 and det.state.cfg.top_k == 1024
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    handle = det.detect_submit(color, depth)
    packed = handle[0].numpy()
    assert packed.shape == golden["packed"].shape == (1024, 5)
    _assert_packed_equal(packed, golden["packed"])
    out = det._collect(handle, det.class_ids, 1, None)
    assert len(out["synthetic"]) == int(golden["synthetic_poses"][0])
    np.testing.assert_allclose(out["lagergehaeuse"][0].translation, golden["translation"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["lagergehaeuse"][0].quaternion, golden["quaternion"], rtol=0, atol=1e-9)


def test_multi_golden_equals_live_jax():
    ref = jax_multi_reference()
    golden = np.load(MULTI_REF)
    assert sorted(golden.files) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(golden[k], ref[k], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_multi_reference()
    np.savez_compressed(MULTI_REF, **arrays)
    print(f"wrote {MULTI_REF}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))
    print(f"JAX fixture-class pose t={arrays['translation']}, {int(arrays['packed'][:, 4].sum())} valid, "
          f"{int(arrays['synthetic_poses'][0])} synthetic poses")
