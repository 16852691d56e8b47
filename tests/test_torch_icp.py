"""The port's ICP slice (ops/depth3d.py, ops/icp.py) against the JAX
reference on the CPU, on the fixture mesh, the pose0 render, the real
recentred depth0.png and seeded synthetic inputs.

- scene_cloud_from_depth on the port's render of pose0 (bit-equal to JAX's,
  tests/test_torch_render.py) with its tight bbox, and on depth0.png with
  the fixture bbox (276, 246, 93, 88): points, normals and valid equal;
- organized_normals on a seeded surface whose bbox fills the 384 window
  (the border masks): equal;
- knn_plane_normals on a seeded 512-point cloud: |dot| >= 1 - KNN_DOT;
- verify_mean_depth_diff on a render against a noisy scene, a mask that
  touches the image border, and an empty mask (0.0, accepted, as JAX);
- icp_refine_batch from test_icp_metrics' perturbed pose and the four
  stress starts of tests/test_icp_stress.py at sample step 8: one iteration
  within ONE_ITER_MM / ONE_ITER_ROT of JAX's; sixteen within ENVELOPE_MM /
  ENVELOPE_ROT of the nearest of JAX's poses from the start and from the
  starts one float32 ulp away (y and z, each up and down);
  the stress test's own bars (dt < 10 mm, ADD-S < 10 mm, verify <= 35 mm);
- the parameter wiring of tests/test_icp_stress.py, refine_best against
  refine + best_verified, a pose 120 mm off rejected, the path without mesh
  arrays, and the model cloud equal to JAX's at steps 2 and 8.

Why an envelope: the reference's 16 iterations are chaotic at the float32
level. From these starts, a start one ulp away moves JAX's own pose by up
to 1.17 mm and 0.11 in a rotation-matrix entry (on the fixture frame by
2.76 mm and 0.39, tests/test_torch_icp_fixture.py), while one iteration of
the port is within a few ulps of JAX's. Measured gaps, here and on the
fixture: one iteration 1.22e-4 mm and 1.31e-6; sixteen, to the nearest
envelope pose, 0.125 mm and 0.0048. The limits are about 4x those: 5e-4
mm and 5e-6, 0.5 mm and 0.02 (no tighter rotation limit can hold while the
reference's own poses spread by 0.1-0.4). Verify means: VERIFY_ATOL_MM
(the port sums in float64).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
MODEL = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
ONE_ITER_MM = 5e-4
ONE_ITER_ROT = 5e-6
ENVELOPE_MM = 0.5
ENVELOPE_ROT = 0.02
VERIFY_ATOL_MM = 1e-4
KNN_DOT = 1e-5
STRESS = [(50.0, 0.0), (0.0, 15.0), (50.0, 15.0), (-50.0, 10.0)]


@pytest.fixture(scope="module")
def pose0():
    """The fixture mesh, CameraParameters(), pose0 and the port's render of
    it with its tight bbox."""
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.utils.ply import load_ply

    cam = CameraParameters()
    mesh = load_ply(MODEL)
    marr = mesh_to_arrays(mesh, "cpu")
    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    rot, trans = gt.rotation_matrix().astype(np.float32), gt.translation.astype(np.float32)
    depth = render(marr, rot, trans, cam.fx, cam.fy, 320.0, 240.0).numpy()
    ys, xs = np.nonzero(depth > 0)
    bbox = (int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))
    return cam, mesh, marr, rot, trans, depth, bbox


def _clouds(depth, bbox, cam):
    from linemod_tpu.ops.depth3d import scene_cloud_from_depth as jax_cloud
    from linemod_tpu_torch.ops.depth3d import scene_cloud_from_depth

    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.width / 2.0, cy=cam.height / 2.0)
    got = scene_cloud_from_depth(torch.from_numpy(np.ascontiguousarray(depth, np.float32)), bbox, **kw)
    want = jax_cloud(jnp.asarray(depth, jnp.float32), jnp.asarray(np.asarray(bbox, np.int32)), **kw)
    return got, [np.asarray(a) for a in want]


@pytest.mark.parametrize("scene", ["pose0_render", "depth0"])
def test_scene_cloud_equals_jax(pose0, scene):
    cam, *_, depth, bbox = pose0
    if scene == "depth0":
        from linemod_tpu_torch.utils.png import read_png

        depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")  # cx, cy at the centre
        bbox = (276, 246, 93, 88)
    (pts, nrm, valid), (jpts, jnrm, jvalid) = _clouds(depth, bbox, cam)
    assert int(jvalid.sum()) > 1000
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(pts.numpy(), jpts)
    np.testing.assert_array_equal(nrm.numpy(), jnrm)
    v = valid.numpy()
    np.testing.assert_allclose(np.linalg.norm(nrm.numpy()[v], axis=1), 1.0, atol=1e-3)
    assert (nrm.numpy()[v][:, 2] < 0).mean() > 0.8  # facing the camera


def test_organized_normals_full_window_equal_jax():
    """A seeded curved surface with holes and a 30 mm step whose bbox fills
    the 384 x 384 window: the window's first and last rows and columns
    have no neighbour beyond it (the reference's border masks)."""
    from linemod_tpu.ops.depth3d import scene_cloud_from_depth as jax_cloud
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.depth3d import scene_cloud_from_depth

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float64)
    depth = 620.0 + 0.002 * (xx - 300) ** 2 + 0.05 * yy + rng.normal(0, 0.5, xx.shape)
    depth[:, 300:] += 30.0
    depth[rng.uniform(size=depth.shape) < 0.03] = 0.0
    depth = np.round(depth).astype(np.float32)
    cam = CameraParameters()
    bbox = (100, 50, 384, 384)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=320.0, cy=240.0)
    got = scene_cloud_from_depth(torch.from_numpy(depth), bbox, **kw)
    want = jax_cloud(jnp.asarray(depth), jnp.asarray(np.asarray(bbox, np.int32)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == 4096


def test_knn_plane_normals_equal_jax_up_to_sign():
    from linemod_tpu.ops.depth3d import knn_plane_normals as jax_knn
    from linemod_tpu_torch.ops.depth3d import knn_plane_normals

    rng = np.random.default_rng(1)
    xy = rng.uniform(-60, 60, (512, 2))
    z = 600.0 + 0.004 * (xy ** 2).sum(1) + rng.normal(0, 0.3, 512)
    pts = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    valid = rng.uniform(size=512) > 0.1
    got = knn_plane_normals(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_knn(jnp.asarray(pts), jnp.asarray(valid)))
    dots = np.abs((got * want).sum(1))
    assert dots.min() >= 1.0 - KNN_DOT, dots.min()
    assert (got[:, 2] < 0).mean() > 0.9


def _verify_pair(scene, rendered):
    from linemod_tpu.ops.icp import verify_mean_depth_diff as jax_verify
    from linemod_tpu_torch.ops.icp import verify_mean_depth_diff

    got = float(verify_mean_depth_diff(torch.from_numpy(scene), torch.from_numpy(rendered)))
    return got, float(jax_verify(jnp.asarray(scene), jnp.asarray(rendered)))


@pytest.mark.parametrize("case", ["noisy_scene", "border", "empty"])
def test_verify_mean_depth_diff_equals_jax(pose0, case):
    """The empty mask scores 0.0 on both sides: the reference clamps the
    count to 1, so an empty twice-eroded mask passes the 35 mm gate, and
    the port keeps that (ROADMAP queue 3)."""
    from linemod_tpu_torch.ops.icp import VERIFY_ACCEPT_MM

    rendered = pose0[5]
    rng = np.random.default_rng(2)
    if case == "noisy_scene":
        scene = (rendered + 8.0 + rng.normal(0, 6.0, rendered.shape)).astype(np.float32)
    elif case == "border":
        # the object cut by the crop's left and top edges; the scene covers
        # the whole crop, so the mask touches the border
        rendered = np.ascontiguousarray(rendered[270:, 300:])
        scene = np.full(rendered.shape, 640.0, np.float32)
        assert (rendered[0] > 0).any() and (rendered[:, 0] > 0).any()
    else:
        scene = np.full(rendered.shape, 600.0, np.float32)  # at the cut: no pixel counts
    got, want = _verify_pair(scene, rendered)
    assert got == pytest.approx(want, abs=VERIFY_ATOL_MM)
    if case == "empty":
        assert got == want == 0.0 and got <= VERIFY_ACCEPT_MM
    else:
        assert got > 1.0


# ----------------------------------------------------------------- ICP ---

def _starts():
    """(name, scene key, r0, t0, tolerance): test_icp_metrics' perturbed
    pose on the pose0 render, and the four stress starts."""
    from linemod_tpu_torch.utils.geometry import mat_to_quat, quat_to_mat, rotation_about_axis

    out = [("perturbed", "pose0", None, None, 0.0)]
    for dz, deg in STRESS:
        pert = rotation_about_axis([0.3, 1.0, 0.2], np.radians(deg)).astype(np.float32)
        gt_rot = rotation_about_axis([1.0, 0.0, 0.0], np.radians(105.0)).astype(np.float32)
        r0 = quat_to_mat(mat_to_quat(pert @ gt_rot)).astype(np.float32)
        t0 = (np.array([10.0, 25.0, 620.0], np.float32) + np.array([5.0, -5.0, dz])).astype(np.float32)
        out.append((f"stress dz={dz} deg={deg}", "stress", r0, t0, 0.01))
    return out


@pytest.fixture(scope="module")
def stress_scene():
    """tests/test_icp_stress.py's scene: the fixture rendered at 105 deg
    about x, t = (10, 25, 620), by the port."""
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.utils.geometry import rotation_about_axis
    from linemod_tpu_torch.utils.ply import load_ply

    cam = CameraParameters(fx=1044.87, fy=1045.69, cx=320, cy=240, width=640, height=480)
    mesh = load_ply(MODEL)
    marr = mesh_to_arrays(mesh, "cpu")
    gt_rot = rotation_about_axis([1.0, 0.0, 0.0], np.radians(105.0)).astype(np.float32)
    gt_t = np.array([10.0, 25.0, 620.0], np.float32)
    depth = render(marr, gt_rot, gt_t, cam.fx, cam.fy, 320.0, 240.0).numpy()
    return cam, mesh, marr, gt_rot, gt_t, depth


@pytest.fixture(scope="module")
def icp_runs(pose0, stress_scene):
    """For each start: the inputs (model points, normals, scene cloud, r0,
    t0, tolerance), the port's one- and sixteen-iteration poses and JAX's
    one-iteration pose and its sixteen-iteration envelope."""
    from linemod_tpu.ops.icp import icp_refine_batch as jax_icp
    from linemod_tpu_torch.ops.depth3d import scene_cloud_from_depth
    from linemod_tpu_torch.ops.icp import icp_refine_batch
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    runs = {}
    cam, mesh, _, rot, trans, depth, bbox = pose0
    s_cam, _, _, _, _, s_depth = stress_scene
    for name, scene, r0, t0, tol in _starts():
        if scene == "pose0":
            d_rot = rotation_about_axis([0.3, 1.0, 0.2], np.radians(4.0)).astype(np.float32)
            r0, t0 = (d_rot @ rot).astype(np.float32), trans + np.array([6.0, -5.0, 8.0], np.float32)
            cloud_args = (depth, bbox, cam)
        else:
            cloud_args = (s_depth, (220, 180, 200, 160), s_cam)
        d, b, c = cloud_args
        cloud = scene_cloud_from_depth(torch.from_numpy(d), b, fx=c.fx, fy=c.fy, cx=320.0, cy=240.0)
        model = (np.ascontiguousarray(mesh.vertices[::8]), np.ascontiguousarray(mesh.normals[::8]))

        def port_run(iters, t=t0):
            r, tt, _ = icp_refine_batch(
                torch.from_numpy(model[0]), *cloud, torch.from_numpy(r0[None]), torch.from_numpy(t[None]),
                iterations=iters, model_nrm=torch.from_numpy(model[1]), tolerance=tol,
            )
            return r[0].numpy(), tt[0].numpy()

        def jax_run(iters, t=t0):
            r, tt, _ = jax_icp(
                jnp.asarray(model[0]), *(jnp.asarray(a.numpy()) for a in cloud), jnp.asarray(r0[None]),
                jnp.asarray(t[None]), iterations=iters, model_nrm=jnp.asarray(model[1]), tolerance=tol,
            )
            return np.asarray(r)[0], np.asarray(tt)[0]

        starts = [t0]
        for axis in (1, 2):
            for direction in (np.inf, -np.inf):
                t = t0.copy()
                t[axis] = np.nextafter(t[axis], np.float32(direction))
                starts.append(t)
        runs[name] = dict(port1=port_run(1), jax1=jax_run(1), port16=port_run(16),
                          envelope=[jax_run(16, t) for t in starts])
    return runs


@pytest.mark.parametrize("start", [s[0] for s in _starts()])
def test_icp_one_iteration_equals_jax(icp_runs, start):
    (r, t), (jr, jt) = icp_runs[start]["port1"], icp_runs[start]["jax1"]
    assert float(np.abs(t - jt).max()) <= ONE_ITER_MM
    assert float(np.abs(r - jr).max()) <= ONE_ITER_ROT


@pytest.mark.parametrize("start", [s[0] for s in _starts()])
def test_icp_sixteen_iterations_within_jax_envelope(icp_runs, start):
    r, t = icp_runs[start]["port16"]
    gaps = [(float(np.abs(t - et).max()), float(np.abs(r - er).max())) for er, et in icp_runs[start]["envelope"]]
    mm, rot = min(gaps, key=lambda g: max(g[0] / ENVELOPE_MM, g[1] / ENVELOPE_ROT))
    assert mm <= ENVELOPE_MM and rot <= ENVELOPE_ROT, (mm, rot)


def _pose_error(rot, trans, gt_rot, gt_t, mesh):
    from linemod_tpu_torch.ops.metrics import adds_error

    sub = torch.from_numpy(mesh.subsampled_vertices(40))
    adds = float(adds_error(sub, *(torch.from_numpy(np.asarray(a, np.float32)) for a in (gt_rot, gt_t, rot, trans))))
    return float(np.linalg.norm(np.asarray(trans) - gt_t)), adds


@pytest.mark.parametrize("dz,deg", STRESS)
def test_icp_stress_bars(icp_runs, stress_scene, dz, deg):
    """The stress test's own bars, met by the port's and by JAX's pose:
    translation error < 10 mm, ADD-S < 10 mm, and the verify gate on a
    full-frame render of the port's pose."""
    from linemod_tpu_torch.ops.icp import VERIFY_ACCEPT_MM, verify_mean_depth_diff
    from linemod_tpu_torch.ops.rasterizer import render

    cam, mesh, marr, gt_rot, gt_t, depth = stress_scene
    run = icp_runs[f"stress dz={dz} deg={deg}"]
    for r, t in (run["port16"], run["envelope"][0]):
        dt, adds = _pose_error(r, t, gt_rot, gt_t, mesh)
        assert dt < 10.0 and adds < 10.0, (dt, adds)
    r, t = run["port16"]
    rendered = render(marr, r, t, cam.fx, cam.fy, 320.0, 240.0)
    assert float(verify_mean_depth_diff(torch.from_numpy(depth), rendered)) <= VERIFY_ACCEPT_MM


def test_icp_parameters_wired(stress_scene):
    """iterations, tolerance and rejection_scale reach the loop (the
    assertions of tests/test_icp_stress.py, at sample step 8)."""
    from linemod_tpu_torch.ops.icp import IcpRefiner
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.geometry import mat_to_quat, rotation_about_axis

    cam, mesh, marr, gt_rot, gt_t, depth = stress_scene
    pert = rotation_about_axis([0.3, 1.0, 0.2], np.radians(15.0)).astype(np.float32)
    init = ObjectPose(translation=(gt_t + np.array([5.0, -5.0, 50.0])).astype(np.float64),
                      quaternion=mat_to_quat(pert @ gt_rot), bounding_box=(220, 180, 200, 160))

    def refined(**kw):
        return IcpRefiner(mesh, cam, 8, mesh_arrays=marr, **kw).refine(depth, [init])[0]

    two = refined(iterations=2, tolerance=0.0)
    full = refined(iterations=16, tolerance=0.0)
    assert not np.allclose(full.translation, two.translation, atol=1e-3)
    frozen = refined(iterations=16, tolerance=1e9)  # freezes after the second update
    assert np.allclose(frozen.translation, two.translation, atol=1e-3)
    still = refined(iterations=8, tolerance=0.0, rejection_scale=1e-6)  # every pair rejected
    assert np.allclose(still.translation, np.asarray(init.translation), atol=1e-3)
    ref_tol = refined(iterations=16, tolerance=0.1)
    dt, adds = _pose_error(ref_tol.rotation_matrix(), ref_tol.translation, gt_rot, gt_t, mesh)
    assert dt < 10.0 and adds < 10.0


def test_refine_best_equals_refine_then_best_verified(pose0):
    """tests/test_icp_metrics.py's pipeline cases: refine converges within
    5 mm and best_verified accepts the result; the fused refine_best picks
    the pose refine + best_verified picks; a pose 120 mm off is rejected;
    without mesh arrays refine_best is the first refined pose."""
    from linemod_tpu_torch.ops.icp import IcpRefiner
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.geometry import mat_to_quat, rotation_about_axis

    cam, mesh, marr, rot, trans, depth, _ = pose0
    refiner = IcpRefiner(mesh, cam, sample_step=8, mesh_arrays=marr)
    near = ObjectPose(translation=(trans + np.array([5.0, 5.0, 10.0])).astype(np.float64),
                      quaternion=mat_to_quat(rotation_about_axis([0, 0, 1], np.radians(3)) @ rot),
                      bounding_box=(276, 249, 93, 92))
    refined = refiner.refine(depth, [near])
    assert np.linalg.norm(refined[0].translation - trans) < 5.0
    assert refiner.best_verified(depth, refined) is refined[0]
    off = ObjectPose(translation=(trans + np.array([6.0, -4.0, 10.0])).astype(np.float64),
                     quaternion=mat_to_quat(rot), bounding_box=(240, 200, 160, 160))
    refined = refiner.refine(depth, [off])
    two_call = refiner.best_verified(depth, refined)
    fused = refiner.refine_best(depth, [off])
    assert (two_call is None) == (fused is None)
    if fused is not None:
        np.testing.assert_allclose(fused.translation, two_call.translation, rtol=0, atol=1e-4)
        assert abs(np.dot(fused.quaternion, two_call.quaternion)) == pytest.approx(1.0, abs=1e-6)
    bad = ObjectPose(translation=(trans + np.array([0.0, 0.0, 120.0])).astype(np.float64),
                     quaternion=mat_to_quat(rot), bounding_box=(276, 249, 93, 92))
    assert refiner.best_verified(depth, [bad]) is None
    bare = IcpRefiner(mesh, cam, sample_step=8, device="cpu")
    got = bare.refine_best(depth, [off])
    np.testing.assert_array_equal(got.translation, refined[0].translation)
    assert bare.best_verified(depth, refined) is refined[0]


def test_empty_verify_mask_accepts_pose(pose0):
    """Pins the reference's defect, which the port matches (ROADMAP queue
    3): against a scene at the 600 mm cut no pixel counts, the mean is 0.0
    and the pose passes the gate, whatever it is."""
    from linemod_tpu_torch.ops.icp import IcpRefiner
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.geometry import mat_to_quat

    cam, mesh, marr, rot, trans, depth, _ = pose0
    refiner = IcpRefiner(mesh, cam, sample_step=8, mesh_arrays=marr)
    far = ObjectPose(translation=(trans + np.array([0.0, 0.0, 120.0])).astype(np.float64),
                     quaternion=mat_to_quat(rot), bounding_box=(276, 249, 93, 92))
    flat = np.full(depth.shape, 600.0, np.float32)
    assert refiner.best_verified(flat, [far]) is far


@pytest.mark.parametrize("step", [2, 8])
def test_model_cloud_equals_jax(step):
    from linemod_tpu.config import CameraParameters as JaxCam
    from linemod_tpu.ops.icp import IcpRefiner as JaxRefiner
    from linemod_tpu.utils.ply import load_ply as jax_load_ply
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.icp import IcpRefiner
    from linemod_tpu_torch.utils.ply import load_ply

    got = IcpRefiner(load_ply(MODEL), CameraParameters(), step, device="cpu")
    want = JaxRefiner(jax_load_ply(MODEL), JaxCam(), step)
    assert got.model_pts.shape == (7168 if step == 2 else 2048, 3)
    np.testing.assert_array_equal(got.model_pts.numpy(), np.asarray(want.model_pts))
    np.testing.assert_array_equal(got.model_nrm.numpy(), np.asarray(want.model_nrm))
    with pytest.raises(ValueError, match="mesh_arrays or a device"):
        IcpRefiner(load_ply(MODEL), CameraParameters(), step)
