"""The PyTorch port's main path on the bundled fixture frame, against the JAX
reference on the CPU.

Color-only `PoseDetection.detect` on `example/benchmark/img0.png` with the
committed 1,950-template bank (padded to 2,048), ICP off. The port runs its
plain PyTorch scans here (CPU tensors); the same checks run on the card in
`chip_smoke.py`, where the CUDA kernels take the scans.

Tolerances: template ids, x, y and valid flags exact; similarities atol 1e-4
(the existing golden test's tolerance; they agree bit for bit in practice);
pose translation 1e-6 mm and quaternion 1e-9, since both sides run the same
float64 numpy pose math on identical matches.

`tests/goldens/img0_torch_ref.npz` (JAX's packed [512, 5], fixture pose and
quantized maps at both pyramid levels) is what the card is checked against;
regenerate it with `env JAX_PLATFORMS=cpu python tests/test_torch_e2e_fixture.py`.
`test_torch_golden_equals_live_jax` keeps it from drifting.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
GOLDEN = os.path.join(REPO, "tests", "goldens", "img0_golden.npz")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")


def _fixture_files():
    return {
        "settings": os.path.join(EXAMPLE, "linemod_settings.yml"),
        "bank": os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"),
        "model": os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"),
        "img0": os.path.join(EXAMPLE, "benchmark", "img0.png"),
        "depth0": os.path.join(EXAMPLE, "benchmark", "depth0.png"),
        "pose0": os.path.join(EXAMPLE, "benchmark", "pose0.yml"),
    }


def jax_reference():
    """Run the JAX reference on the fixture (CPU). Returns (reference arrays,
    detector, color, depth)."""
    import cv2
    import jax.numpy as jnp

    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.ops.detect_core import detect_frame
    from linemod_tpu.ops.extract import downsample2
    from linemod_tpu.ops.gradients import quantize_color_gradients
    from linemod_tpu.pipeline.pose_detection import PoseDetection

    f = _fixture_files()
    cam, settings = load_settings(f["settings"])
    det = PoseDetection(
        TemplateBank.load(f["bank"]), cam, settings, load_model_properties(f["model"])
    )
    color = cv2.imread(f["img0"])
    depth = cv2.imread(f["depth0"], cv2.IMREAD_ANYDEPTH)
    color_c = det.recenter(np.ascontiguousarray(color))
    colorf = jnp.asarray(color_c.astype(np.float32))
    pose = det.detect(color, depth, 1)[0]
    ref = {
        "packed": np.asarray(detect_frame(det.state, jnp.asarray(color_c.astype(np.uint8)))),
        "quaternion": np.asarray(pose.quaternion, np.float64),
        "translation": np.asarray(pose.translation, np.float64),
        "quant0": np.asarray(quantize_color_gradients(colorf)[0]),
        "quant1": np.asarray(quantize_color_gradients(downsample2(colorf))[0]),
    }
    return ref, det, color, depth


@pytest.fixture(scope="module")
def jax_side():
    return jax_reference()


@pytest.fixture(scope="module")
def torch_side():
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    f = _fixture_files()
    cam, settings = load_settings(f["settings"])
    det = PoseDetection(
        TemplateBank.load(f["bank"]), cam, settings, load_model_properties(f["model"]),
        device="cpu",
    )
    color = read_png(f["img0"], "color")
    depth = read_png(f["depth0"], "anydepth")
    handle = det.detect_submit(color, depth)
    packed = handle[0].numpy()
    poses = det.detect_collect(handle, 1)
    return det, packed, poses


def _assert_packed_equal(got, want):
    np.testing.assert_array_equal(got[:, [0, 1, 2, 4]], want[:, [0, 1, 2, 4]])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-4)


def test_torch_packed_equals_jax_detect_frame(jax_side, torch_side):
    ref = jax_side[0]
    _, packed, _ = torch_side
    assert packed.shape == (512, 5)
    _assert_packed_equal(packed, ref["packed"])


def test_torch_top_matches_golden(torch_side):
    _, packed, _ = torch_side
    top = packed[packed[:, 4] > 0.5][:8]
    np.testing.assert_allclose(top, np.load(GOLDEN)["top_matches"], rtol=0, atol=1e-4)


def test_torch_pose_equals_jax_pose(jax_side, torch_side):
    ref = jax_side[0]
    _, _, poses = torch_side
    assert len(poses) == 1
    np.testing.assert_allclose(poses[0].translation, ref["translation"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(poses[0].quaternion, ref["quaternion"], rtol=0, atol=1e-9)


def test_torch_pose_passes_vsd_and_add(jax_side, torch_side):
    """VSD < 0.3 and ADD <= 21 mm, scored by the JAX Benchmark (the port has
    no renderer yet)."""
    from linemod_tpu.pipeline.benchmark import Benchmark
    from linemod_tpu.utils.ply import load_ply
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose

    det, _, poses = torch_side
    _, jdet, _, depth = jax_side
    f = _fixture_files()
    bench = Benchmark(load_ply(f["model"]), jdet.cam)
    gt = read_ground_truth_pose(f["pose0"])
    scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
    vsd = bench.score_vsd(scene, gt, poses[0])
    add = bench.score_add(gt, poses[0])
    assert vsd < 0.3, f"VSD {vsd} fails the < 0.3 criterion"
    assert add <= 21.0, f"ADD {add} mm fails the <= 21 mm criterion"


def test_torch_add_error_equals_jax(torch_side):
    """The port's ADD equals JAX's on the fixture pose (float32 sums in a
    different order: rtol 1e-5)."""
    import jax.numpy as jnp

    from linemod_tpu.ops.metrics import add_error as jax_add_error
    from linemod_tpu.pipeline.benchmark import read_ground_truth_pose as jax_read_gt
    from linemod_tpu.utils.geometry import quat_to_mat
    from linemod_tpu.utils.ply import load_ply
    from linemod_tpu_torch.pipeline.benchmark import model_vertices, score_add

    _, _, poses = torch_side
    f = _fixture_files()
    gt = jax_read_gt(f["pose0"])
    est = poses[0]
    want = float(
        jax_add_error(
            jnp.asarray(load_ply(f["model"]).vertices, jnp.float32),
            *[
                jnp.asarray(a, jnp.float32)
                for a in (quat_to_mat(gt.quaternion), gt.translation,
                          quat_to_mat(est.quaternion), est.translation)
            ],
        )
    )
    got = score_add(model_vertices(f["model"], "cpu"), gt, est)
    assert got == pytest.approx(want, rel=1e-5)
    assert got <= 21.0


@pytest.mark.parametrize(
    "variant", [{}, {"use_depth_improvement": False}, {"number_wanted_poses": 3}],
    ids=["default", "no_depth_check", "three_poses"],
)
def test_torch_group_candidate_poses_equal_jax(jax_side, torch_side, variant):
    """Grouping, the checks and the pose math on the fixture's matches, under
    settings that take the other branches, equal the JAX orchestrator's."""
    import dataclasses

    from linemod_tpu.pipeline.pose_detection import group_candidate_poses as jax_group
    from linemod_tpu_torch.pipeline.pose_detection import group_candidate_poses

    det, packed, _ = torch_side
    _, jdet, color, depth = jax_side
    valid = packed[:, 4] > 0.5
    args = (packed[valid, 0].astype(np.int64), packed[valid, 1], packed[valid, 2])
    color_c = det.recenter(np.ascontiguousarray(color))
    depth_c = det.recenter(np.ascontiguousarray(depth))
    got = group_candidate_poses(
        *args, det.bank, det.props, dataclasses.replace(det.settings, **variant), det.cam,
        color_c, depth_c, {},
    )
    want = jax_group(
        *args, jdet.bank, jdet.props, dataclasses.replace(jdet.settings, **variant),
        jdet.cam, color_c, depth_c, {},
    )
    assert [len(g) for g in got] == [len(g) for g in want] and got
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.translation, b.translation)
            np.testing.assert_array_equal(a.quaternion, b.quaternion)
            assert a.bounding_box == b.bounding_box


def test_torch_quantized_levels_equal_reference(jax_side, torch_side):
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.utils.png import read_png

    ref = jax_side[0]
    det, _, _ = torch_side
    color_c = det.recenter(read_png(_fixture_files()["img0"], "color"))
    colorf = torch.from_numpy(color_c).float()
    np.testing.assert_array_equal(quantize_color_gradients(colorf)[0].numpy(), ref["quant0"])
    np.testing.assert_array_equal(
        quantize_color_gradients(downsample2(colorf))[0].numpy(), ref["quant1"]
    )


def test_torch_golden_equals_live_jax(jax_side):
    """The committed golden the card is checked against is what the JAX
    reference computes now."""
    ref = jax_side[0]
    golden = np.load(TORCH_REF)
    assert sorted(golden.files) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(golden[k], ref[k], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_reference()[0]
    np.savez_compressed(TORCH_REF, **arrays)
    print(f"wrote {TORCH_REF}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))
