"""The port's synthetic accuracy protocol (`pipeline/synth_eval`,
`tools/accuracy_eval`) against the JAX reference on the CPU.

The frames are the reference's: the same renders (the port's
`ops/rasterizer.render` in its default form, dividing by the focal lengths
as JAX's traced camera does) composited by the same numpy code on the same
`np.random.default_rng((seed, index))` stream, so they must equal JAX's byte
for byte. Detection on equal frames gives equal packed candidates, so the
pose is held to 0.5 mm / 1e-4 and VSD / ADD-S to 1e-3.

`tests/goldens/synth_eval_ref.npz` holds JAX's 120-frame protocol (30 frames
a mode x clean, shiny, holes, clutter, seed 0): each frame's color and depth
sha256, base template, ground truth, whether it was detected, the pose, VSD
and ADD-S, and the packed [512, 5] of frame 0 of each mode. `chip_smoke.py`
holds the card's run of the protocol to it. Regenerate it with
`env JAX_PLATFORMS=cpu python tests/test_torch_synth_eval.py` (~10 minutes).
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
SYNTH_REF = os.path.join(REPO, "tests", "goldens", "synth_eval_ref.npz")
MODES = ("clean", "shiny", "holes", "clutter")
FRAMES_PER_MODE = 30


def sha256(a: np.ndarray) -> bytes:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest().encode()


def jax_protocol(frames_per_mode: int = FRAMES_PER_MODE, seed: int = 0) -> dict:
    """JAX's synthetic protocol (scripts/accuracy_eval.py's loop, ICP off)
    at full precision, as arrays over the frames in mode order."""
    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.pipeline.benchmark import Benchmark
    from linemod_tpu.pipeline.pose_detection import PoseDetection
    from linemod_tpu.pipeline.synth_eval import SyntheticEvalSet, eval_camera
    from linemod_tpu.utils.ply import load_ply

    cam0, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    props = load_model_properties(model)
    mesh = load_ply(model)
    cam = eval_camera(cam0)
    gen = SyntheticEvalSet(mesh, bank, cam0, seed=seed)
    det = PoseDetection(bank, cam, settings, props)
    bench = Benchmark(mesh, cam)
    n = len(MODES) * frames_per_mode
    out = {
        "modes": np.asarray(MODES),
        "seed": np.int64(seed),
        "color_sha256": np.zeros(n, "S64"),
        "depth_sha256": np.zeros(n, "S64"),
        "base_template": np.zeros(n, np.int64),
        "gt_translation": np.zeros((n, 3)),
        "gt_quaternion": np.zeros((n, 4)),
        "detected": np.zeros(n, bool),
        "translation": np.full((n, 3), np.nan),
        "quaternion": np.full((n, 4), np.nan),
        "vsd": np.full(n, np.nan),
        "adds": np.full(n, np.nan),
    }
    for m, mode in enumerate(MODES):
        det.settings = dataclasses.replace(
            settings, depth_offset=0.0 if mode == "clean" else settings.depth_offset
        )
        for i in range(frames_per_mode):
            k = m * frames_per_mode + i
            color, depth, gt, meta = gen.make_frame(i, mode)
            out["color_sha256"][k] = sha256(color)
            out["depth_sha256"][k] = sha256(depth)
            out["base_template"][k] = meta["base_template"]
            out["gt_translation"][k] = gt.translation
            out["gt_quaternion"][k] = gt.quaternion
            handle = det.detect_submit(color, depth)
            if i == 0:
                out[f"packed_{mode}"] = np.asarray(handle[0])
            poses = det.detect_collect(handle, 1)
            if poses:
                est = poses[0]
                out["detected"][k] = True
                out["translation"][k] = est.translation
                out["quaternion"][k] = est.quaternion
                out["vsd"][k] = bench.score_vsd(depth.astype(np.float32), gt, est)
                out["adds"][k] = bench.score_adds(gt, est)
            print(f"{mode} {i}: detected {bool(poses)} vsd {out['vsd'][k]:.4f} adds {out['adds'][k]:.3f}",
                  flush=True)
    return out


@pytest.fixture(scope="module")
def setup():
    """Both packages' generators, detectors and scorers on the fixture."""
    from linemod_tpu.config import load_model_properties as jax_props
    from linemod_tpu.config import load_settings as jax_settings
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.pipeline.benchmark import Benchmark as JaxBenchmark
    from linemod_tpu.pipeline.pose_detection import PoseDetection as JaxDetection
    from linemod_tpu.pipeline.synth_eval import SyntheticEvalSet as JaxEvalSet
    from linemod_tpu.pipeline.synth_eval import eval_camera as jax_eval_camera
    from linemod_tpu.utils.ply import load_ply as jax_load_ply

    from linemod_tpu_torch.tools.accuracy_eval import Protocol

    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    cam0, settings = jax_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = JaxBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    mesh = jax_load_ply(model)
    cam = jax_eval_camera(cam0)
    proto = Protocol.load("cpu")
    return {
        "jax_gen": JaxEvalSet(mesh, bank, cam0, seed=0),
        "jax_det": JaxDetection(bank, cam, settings, jax_props(model)),
        "jax_bench": JaxBenchmark(mesh, cam),
        "proto": proto,
        "det": proto.detector(),
        "ref": np.load(SYNTH_REF),
    }


@pytest.fixture(scope="module")
def frames(setup):
    """Frame 0 of the shiny and clutter modes through both packages: the
    frames, the packed candidates, the first pose and its scores."""
    out = {}
    for mode in ("shiny", "clutter"):
        color_j, depth_j, gt_j, meta_j = setup["jax_gen"].make_frame(0, mode)
        handle = setup["jax_det"].detect_submit(color_j, depth_j)
        packed_j = np.asarray(handle[0])
        est_j = setup["jax_det"].detect_collect(handle, 1)[0]
        rec = setup["proto"].run_frame(setup["det"], 0, mode)
        handle = setup["det"].detect_submit(rec["color"], rec["depth"])
        out[mode] = {
            "jax": {"color": color_j, "depth": depth_j, "gt": gt_j, "meta": meta_j, "packed": packed_j,
                    "pose": est_j, "vsd": setup["jax_bench"].score_vsd(depth_j.astype(np.float32), gt_j, est_j),
                    "adds": setup["jax_bench"].score_adds(gt_j, est_j)},
            "port": {**rec, "packed": handle[0].numpy()},
        }
    return out


def test_synthetic_eval_frames_pass_reference_criteria(frames):
    """Frame 0 of the shiny and clutter modes (between-template GT poses,
    +40 mm sensor corruption, distractors) is detected by the port and
    passes the reference's criteria (VSD < 0.3, ADD-S <= 21 mm), as in
    tests/test_synth_eval.py."""
    from linemod_tpu_torch.ops.metrics import OBJECT_DIAMETER, VSD_CORRECT

    for mode, f in frames.items():
        rec = f["port"]
        assert rec["pose"] is not None, f"no detection in mode {mode}"
        assert rec["vsd"] < VSD_CORRECT, f"{mode}: VSD {rec['vsd']}"
        assert rec["adds"] <= OBJECT_DIAMETER, f"{mode}: ADD-S {rec['adds']}"
        t_err = np.linalg.norm(rec["pose"].translation - rec["gt"].translation)
        assert t_err < 30.0, f"{mode}: translation error {t_err} mm"


@pytest.mark.parametrize("mode", ["shiny", "clutter"])
def test_frames_equal_jax(frames, mode):
    """The port's frame 0 is JAX's byte for byte, with the same ground truth."""
    jax, port = frames[mode]["jax"], frames[mode]["port"]
    assert port["color"].dtype == jax["color"].dtype and np.array_equal(port["color"], jax["color"])
    assert port["depth"].dtype == jax["depth"].dtype and np.array_equal(port["depth"], jax["depth"])
    assert port["meta"] == jax["meta"]
    assert np.array_equal(port["gt"].translation, jax["gt"].translation)
    assert np.array_equal(port["gt"].quaternion, jax["gt"].quaternion)


@pytest.mark.parametrize("mode", ["shiny", "clutter"])
def test_detection_equals_jax(frames, mode):
    """The packed [512, 5] equals JAX's (ints exact, similarities 1e-4), the
    pose is within 0.5 mm / 1e-4 and VSD / ADD-S within 1e-3."""
    jax, port = frames[mode]["jax"], frames[mode]["port"]
    assert np.array_equal(port["packed"][:, [0, 1, 2, 4]], jax["packed"][:, [0, 1, 2, 4]])
    np.testing.assert_allclose(port["packed"][:, 3], jax["packed"][:, 3], atol=1e-4)
    np.testing.assert_allclose(port["pose"].translation, jax["pose"].translation, atol=0.5)
    np.testing.assert_allclose(port["pose"].quaternion, jax["pose"].quaternion, atol=1e-4)
    assert abs(port["vsd"] - jax["vsd"]) <= 1e-3 and abs(port["adds"] - jax["adds"]) <= 1e-3


@pytest.mark.parametrize("mode", ["shiny", "clutter"])
def test_golden_equals_live(setup, frames, mode):
    """The committed golden's frame 0 is what both packages give now."""
    ref, k = setup["ref"], MODES.index(mode) * FRAMES_PER_MODE
    for side in ("jax", "port"):
        f = frames[mode][side]
        assert sha256(f["color"]) == ref["color_sha256"][k] and sha256(f["depth"]) == ref["depth_sha256"][k]
        assert np.array_equal(f["packed"][:, [0, 1, 2, 4]], ref[f"packed_{mode}"][:, [0, 1, 2, 4]])
        np.testing.assert_allclose(f["pose"].translation, ref["translation"][k], atol=0.5)
        np.testing.assert_allclose(f["pose"].quaternion, ref["quaternion"][k], atol=1e-4)
        assert abs(f["vsd"] - ref["vsd"][k]) <= 1e-3 and abs(f["adds"] - ref["adds"][k]) <= 1e-3


def test_cube_and_camera_equal_jax():
    """The distractor cube's mesh and the eval camera are JAX's."""
    from linemod_tpu.config import CameraParameters as JaxCamera
    from linemod_tpu.pipeline.synth_eval import _cube_mesh as jax_cube
    from linemod_tpu.pipeline.synth_eval import eval_camera as jax_eval_camera

    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.pipeline.synth_eval import _cube_mesh, eval_camera

    got, want = _cube_mesh(), jax_cube()
    for f in ("vertices", "colors", "indices"):
        assert np.array_equal(getattr(got, f), getattr(want, f)) and getattr(got, f).dtype == getattr(want, f).dtype
    cam = eval_camera(CameraParameters(cx=300.5, cy=250.25))
    assert dataclasses.asdict(cam) == dataclasses.asdict(jax_eval_camera(JaxCamera(cx=300.5, cy=250.25)))


def test_accuracy_tool_first_frames(tmp_path, setup):
    """tools/accuracy_eval with one frame a mode on the CPU: the JAX
    script's JSON schema, and per mode the golden's detection and scores."""
    from linemod_tpu_torch.tools.accuracy_eval import main

    out = tmp_path / "acc.json"
    assert main(["--frames-per-mode", "1", "--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "ACCURACY_r05.json")) as f:
        schema = json.load(f)
    assert set(got) - {"device"} == set(schema) - {"diagnostics"} and got["device"] == "cpu"
    assert set(got["total"]) == set(schema["total"]) and got["total"]["frames"] == 4
    ref = setup["ref"]
    # the JSON rounds VSD to 4 decimals and ADD-S to 2
    for mode in MODES:
        stats, k = got["modes"][mode], MODES.index(mode) * FRAMES_PER_MODE
        assert set(stats) == set(schema["modes"][mode])
        assert stats["detected"] == int(ref["detected"][k])
        if ref["detected"][k]:
            assert abs(stats["vsd"][0] - ref["vsd"][k]) <= 1e-3 + 5e-5
            assert abs(stats["adds"][0] - ref["adds"][k]) <= 1e-3 + 5e-3
    assert got["total"]["detected"] == int(sum(ref["detected"][MODES.index(m) * FRAMES_PER_MODE] for m in MODES))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_protocol()
    np.savez_compressed(SYNTH_REF, **arrays)
    print(f"wrote {SYNTH_REF}: {int(arrays['detected'].sum())} of {len(arrays['detected'])} detected, "
          f"VSD pass {int((arrays['vsd'] < 0.3).sum())}, ADD-S pass {int((arrays['adds'] <= 21.0).sum())}")
