"""The port's depth-to-color registration and Kinect v2 frame transform
(`linemod_tpu_torch/ops/registration.py`) against the JAX reference on the
CPU.

The cases of `tests/test_registration.py`, run through the port, and the
port held to JAX's output with 0 differing pixels: one float32 ulp in the
projection moves a point to the neighbouring pixel, so the count is exact.

`tests/goldens/registration_ref.npz` is JAX's registration of a seeded
Kinect v2 case (512x424 depth into 1920x1080 color, `kinect_depth(seed)`),
stored as the seed, the input's sha256, the cameras and the output's
nonzero pixels; `chip_smoke.py` holds the card to it. Regenerate it with
`env JAX_PLATFORMS=cpu python tests/test_torch_registration.py`.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG_REF = os.path.join(REPO, "tests", "goldens", "registration_ref.npz")


def kinect_depth(seed: int) -> np.ndarray:
    """A seeded Kinect v2 depth frame: integer mm in [500, 4500], 5% holes
    (chip_smoke.py builds the same frame)."""
    rng = np.random.default_rng(seed)
    depth = np.round(rng.uniform(500.0, 4500.0, (424, 512))).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    return depth


def _k(fx, fy, cx, cy):
    return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def _extrinsic():
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    return (rotation_about_axis([0.3, 1.0, 0.2], 0.05).astype(np.float32),
            np.asarray([52.0, -1.5, 3.3], np.float32))


def _jax(depth, k_d, k_c, rot, trans, width, height):
    import jax.numpy as jnp

    from linemod_tpu.ops.registration import register_depth_to_color

    return np.asarray(register_depth_to_color(
        jnp.asarray(depth), jnp.asarray(k_d), jnp.asarray(k_c), jnp.asarray(rot), jnp.asarray(trans),
        out_width=width, out_height=height,
    ))


def _port(depth, k_d, k_c, rot, trans, width, height):
    from linemod_tpu_torch.ops.registration import register_depth_to_color

    return register_depth_to_color(torch.from_numpy(depth), k_d, k_c, rot, trans,
                                   out_width=width, out_height=height).numpy()


# -- the reference's cases (tests/test_registration.py) ------------------------

def test_identity_extrinsics_same_intrinsics_is_identity():
    rng = np.random.default_rng(0)
    depth = np.zeros((64, 96), np.float32)
    depth[16:48, 24:72] = rng.uniform(500, 900, (32, 48)).astype(np.float32)
    k = _k(80.0, 80.0, 48.0, 32.0)
    out = _port(depth, k, k, np.eye(3), np.zeros(3), 96, 64)
    np.testing.assert_allclose(out, depth, atol=1e-3)
    assert np.array_equal(out, _jax(depth, k, k, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 96, 64))


def test_pure_x_translation_shifts_columns():
    depth = np.zeros((64, 96), np.float32)
    depth[20:40, 30:60] = 800.0
    k = _k(100.0, 100.0, 48.0, 32.0)
    out = _port(depth, k, k, np.eye(3), np.asarray([40.0, 0.0, 0.0]), 96, 64)
    np.testing.assert_allclose(out[20:40, 35:65], 800.0)
    assert np.all(out[20:40, 30:35] == 0.0)


def test_nearest_surface_wins():
    depth = np.array([[800.0, 400.0]], np.float32)
    out = _port(depth, _k(100.0, 100.0, 1.0, 0.0), _k(100.0, 100.0, 0.0, 0.0), np.eye(3), np.zeros(3), 2, 1)
    assert out[0, 0] == 400.0


def test_crop_convert_flip():
    from linemod_tpu_torch.ops.registration import CROP_X0, CROP_Y0, kinect_frame_transform

    bgra = np.zeros((1080, 1920, 4), np.uint8)
    big = np.zeros((1082, 1920), np.float32)
    bgra[CROP_Y0 + 10, CROP_X0 + 20] = (10, 20, 30, 255)
    big[CROP_Y0 + 10, CROP_X0 + 20] = 1234.6
    color, depth = kinect_frame_transform(bgra, big)
    assert color.shape == (480, 640, 3) and color.dtype == np.uint8
    assert depth.shape == (480, 640) and depth.dtype == np.uint16
    assert tuple(color[10, 639 - 20]) == (10, 20, 30)
    assert depth[10, 639 - 20] == 1235


@pytest.mark.parametrize("case", ["unpadded", "saturation"])
def test_frame_transform_equals_jax(case):
    """The unpadded big depth, and saturation / nan / inf, give JAX's frames."""
    from linemod_tpu.ops.registration import kinect_frame_transform as jax_transform

    from linemod_tpu_torch.ops.registration import CROP_X0, CROP_Y0, kinect_frame_transform

    bgra = np.random.default_rng(1).integers(0, 256, (1080, 1920, 4), dtype=np.uint8)
    if case == "unpadded":
        big = np.full((1080, 1920), 700.0, np.float32)
    else:
        big = np.zeros((1082, 1920), np.float32)
        big[CROP_Y0 + 1, CROP_X0 + 1] = 1e9
        big[CROP_Y0 + 2, CROP_X0 + 2] = np.nan
        big[CROP_Y0 + 3, CROP_X0 + 3] = np.inf
    color, depth = kinect_frame_transform(bgra, big)
    want_color, want_depth = jax_transform(bgra, big)
    assert np.array_equal(color, want_color) and np.array_equal(depth, want_depth)
    if case == "unpadded":
        assert depth.shape == (480, 640) and np.all(depth == 700)
    else:
        assert (depth[1, 638], depth[2, 637], depth[3, 636]) == (65535, 0, 0)


def test_kinect2_source_without_freenect2():
    from linemod_tpu.pipeline.sensors import Kinect2Source as JaxKinect2Source

    from linemod_tpu_torch.pipeline.sensors import Kinect2Source

    with pytest.raises(RuntimeError) as want:
        JaxKinect2Source()
    with pytest.raises(RuntimeError) as got:
        Kinect2Source()
    assert str(got.value) == str(want.value)
    bgra = np.zeros((1080, 1920, 4), np.uint8)
    big = np.full((1082, 1920), 650.0, np.float32)
    frames = list(Kinect2Source.from_raw_frames([(bgra, big)]))
    assert len(frames) == 1 and frames[0][1].shape == (480, 640) and np.all(frames[0][1] == 650)


# -- against JAX, pixel for pixel ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registration_equals_jax_small(seed):
    """64x48 into 96x72 with a rotated and shifted color camera: 0 pixels
    differ from JAX's output."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(500, 4000, (48, 64)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0
    k_d, k_c = _k(45.7, 45.6, 31.8, 23.3), _k(54.1, 54.1, 47.5, 35.5)
    rot, trans = _extrinsic()
    want = _jax(depth, k_d, k_c, rot, trans, 96, 72)
    got = _port(depth, k_d, k_c, rot, trans, 96, 72)
    assert int((want > 0).sum()) > 1000
    assert int((got != want).sum()) == 0


def jax_registration_reference(seed: int = 0) -> dict:
    """JAX's registration of the seeded Kinect v2 case, with its inputs."""
    depth = kinect_depth(seed)
    k_d, k_c = _k(365.456, 365.456, 254.878, 205.395), _k(1081.37, 1081.37, 959.5, 539.5)
    rot, trans = _extrinsic()
    out = _jax(depth, k_d, k_c, rot, trans, 1920, 1080).ravel()
    idx = np.flatnonzero(out).astype(np.int32)
    return {"seed": np.int64(seed), "depth_sha256": np.bytes_(hashlib.sha256(depth.tobytes()).hexdigest()),
            "k_depth": k_d, "k_color": k_c, "rot": rot, "trans": trans,
            "index": idx, "value": out[idx], "output_sha256": np.bytes_(hashlib.sha256(out.tobytes()).hexdigest())}


def test_kinect_golden_equals_port():
    """The port on the CPU against the committed JAX golden at Kinect v2's
    shapes (512x424 into 1920x1080): 0 pixels differ."""
    ref = np.load(REG_REF)
    depth = kinect_depth(int(ref["seed"]))
    assert hashlib.sha256(depth.tobytes()).hexdigest().encode() == ref["depth_sha256"]
    got = _port(depth, ref["k_depth"], ref["k_color"], ref["rot"], ref["trans"], 1920, 1080).ravel()
    want = np.zeros_like(got)
    want[ref["index"]] = ref["value"]
    assert int((got != want).sum()) == 0
    assert hashlib.sha256(got.tobytes()).hexdigest().encode() == ref["output_sha256"]


def test_kinect_golden_equals_live_jax():
    """The golden has not drifted from JAX's registration."""
    ref = np.load(REG_REF)
    live = jax_registration_reference(int(ref["seed"]))
    for key in ("depth_sha256", "index", "value", "output_sha256"):
        assert np.array_equal(live[key], ref[key]), key


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_registration_reference()
    np.savez_compressed(REG_REF, **arrays)
    print(f"wrote {REG_REF}: {len(arrays['index'])} nonzero pixels of 1920x1080")
