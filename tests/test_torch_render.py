"""The port's renderer and accuracy metrics against the JAX reference on the
CPU: the cases of tests/test_rasterizer.py, a render of the fixture's
ground-truth pose against JAX's, VSD, ADD and ADD-S on seeded poses, the
metric cases of tests/test_icp_metrics.py (reading `example/` directly),
the LINEMOD ground-truth reader and the Benchmark's counters.

Tolerances: the closed-form cases keep tests/test_rasterizer.py's; the
renders' coverage equal to JAX's within 0.1% of the covered pixels and
their depth within 1e-2 mm where both cover (the port fuses its dot
products as XLA's CPU backend does, and its render of pose0 equals JAX's
bit for bit, 6,548 pixels; in another order the cofactors' cancellation
moves depths by up to 0.142 mm); metrics atol 1e-4 (ADD, ADD-S in mm;
VSD, a ratio of pixel counts). Colors, and the renders at template poses
(depth and color, as a standalone render and as template generation
compiles it), are held to JAX's exactly.
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
POSE0 = os.path.join(EXAMPLE, "benchmark", "pose0.yml")

W = H = 128
FX = FY = 128.0
CX = CY = 64.0
COVERAGE_FRACTION = 1e-3
DEPTH_ATOL_MM = 1e-2
METRIC_ATOL = 1e-4


def square_mesh(z=600.0, half=100.0, slant=0.0):
    """Two triangles forming a square x, y in [-half, half] at depth z (+ slant * x)."""
    from linemod_tpu_torch.utils.ply import Mesh

    v = np.array(
        [
            [-half, -half, z - slant * half],
            [half, -half, z + slant * half],
            [half, half, z + slant * half],
            [-half, half, z - slant * half],
        ],
        np.float32,
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    return Mesh(vertices=v, colors=colors, indices=f)


def do_render(mesh, t=None, **kw):
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render

    t = np.zeros(3, np.float32) if t is None else t
    out = render(
        mesh_to_arrays(mesh, "cpu"), np.eye(3, dtype=np.float32), t,
        FX, FY, CX, CY, width=W, height=H, **kw,
    )
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


# ------------------------------------ the cases of tests/test_rasterizer.py ---

def test_flat_square_depth_and_coverage():
    d = do_render(square_mesh(z=600.0, half=100.0))
    # projected half-extent = 100 * 128 / 600 = 21.33 px around the centre
    assert d[64, 64] == pytest.approx(600.0, abs=0.1)
    assert d[64, 64 + 20] == pytest.approx(600.0, abs=0.1)
    assert d[64, 64 + 23] == 0.0
    assert d[0, 0] == 0.0
    assert abs(np.count_nonzero(d) - (2 * 21.333) ** 2) < 180


def test_slanted_plane_interpolation():
    # z = 600 + 0.5 x on the ray x / z = (u - cx) / fx
    d = do_render(square_mesh(z=600.0, half=100.0, slant=0.5))
    for du in (-15, 0, 10):
        assert d[64, 64 + du] == pytest.approx(600.0 / (1.0 - 0.5 * du / FX), rel=1e-4)


def test_occlusion_zbuffer():
    from linemod_tpu_torch.utils.ply import Mesh

    near = square_mesh(z=500.0, half=30.0)
    far = square_mesh(z=800.0, half=100.0)
    both = Mesh(
        vertices=np.concatenate([near.vertices, far.vertices]),
        colors=np.concatenate([near.colors, far.colors]),
        indices=np.concatenate([near.indices, far.indices + 4]),
    )
    d = do_render(both)
    assert d[64, 64] == pytest.approx(500.0, abs=0.1)
    assert d[64, 64 + 12] == pytest.approx(800.0, abs=0.1)


def test_backface_still_rendered():
    m = square_mesh()
    m.indices = m.indices[:, ::-1].copy()  # the reference culls no back faces
    assert do_render(m)[64, 64] == pytest.approx(600.0, abs=0.1)


def test_rotation_translation():
    # +60 mm in x at z = 600 -> +12.8 px
    d = do_render(square_mesh(half=50.0), t=np.array([60, 0, 0], np.float32))
    assert d[64, 64 + 13] == pytest.approx(600.0, abs=0.1)
    assert d[64, 64 - 13] == 0.0


def test_crop_origin():
    full = do_render(square_mesh(half=100.0))
    crop = do_render(square_mesh(half=100.0), origin=(32.0, 32.0))
    np.testing.assert_allclose(crop[:96, :96], full[32:, 32:], atol=1e-3)


def test_color_interpolation():
    _, c = do_render(square_mesh(), with_color=True)
    assert c[64, 64].sum() > 0.5  # the centre blends three vertices
    np.testing.assert_allclose(c[0, 0], 0.0)
    assert c[64 - 20, 64 - 20][0] > 0.6  # near vertex 0, red


def test_white_mesh_renders_white():
    m = square_mesh()
    m.colors = np.ones_like(m.colors)
    d, c = do_render(m, with_color=True)
    np.testing.assert_allclose(c[d > 0], 1.0, atol=1e-4)


@pytest.mark.parametrize("with_color", [False, True], ids=["depth", "color"])
def test_small_scene_equals_jax(with_color):
    """Two overlapping squares, slanted and rotated, cropped: depth and
    color against JAX's render in blocks of 8 faces (the port's blocks of
    512 pick the same face a pixel)."""
    from linemod_tpu.ops.rasterizer import mesh_to_arrays as jax_arrays
    from linemod_tpu.ops.rasterizer import render as jax_render
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.utils.geometry import rotation_about_axis
    from linemod_tpu_torch.utils.ply import Mesh

    a, b = square_mesh(z=620.0, half=90.0, slant=0.4), square_mesh(z=560.0, half=40.0)
    mesh = Mesh(vertices=np.concatenate([a.vertices, b.vertices]),
                colors=np.concatenate([a.colors, b.colors]),
                indices=np.concatenate([a.indices, b.indices + 4]))
    rot = rotation_about_axis([0.2, 0.1, 1.0], 0.3).astype(np.float32)
    t = np.array([5.0, -8.0, 10.0], np.float32)
    kw = dict(width=W, height=H, with_color=with_color, origin=(4.0, 8.0))
    want = jax_render(jax_arrays(mesh, pad_faces_to=8), jnp.asarray(rot), jnp.asarray(t),
                      FX, FY, CX, CY, face_block=8, **kw)
    got = render(mesh_to_arrays(mesh, "cpu"), rot, t, FX, FY, CX, CY, **kw)
    want = want if with_color else (want,)
    got = got if with_color else (got,)
    d_w, d_g = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(d_g > 0, d_w > 0)
    np.testing.assert_allclose(d_g, d_w, rtol=0, atol=DEPTH_ATOL_MM)
    if with_color:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_render_views_equals_single_renders():
    """A stack of views renders each view as `render` does with the
    principal point at the image centre: depth and color, exactly."""
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render, render_views
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    cam = CameraParameters(fx=FX, fy=FY, cx=10.0, cy=20.0, width=W, height=H)
    mesh = square_mesh(z=620.0, half=60.0, slant=0.3)
    marr = mesh_to_arrays(mesh, "cpu")
    rots = np.stack([rotation_about_axis([0.1, 0.3, 1.0], a) for a in (0.0, 0.4)]).astype(np.float32)
    trans = np.array([[0.0, 0.0, 0.0], [12.0, -5.0, 30.0]], np.float32)
    depth, color = render_views(marr, rots, trans, cam, with_color=True)
    assert depth.shape == (2, H, W) and color.shape == (2, H, W, 3)
    for i in range(2):
        d, c = render(marr, rots[i], trans[i], FX, FY, W / 2.0, H / 2.0, width=W, height=H, with_color=True)
        assert (d > 0).sum() > 100
        np.testing.assert_array_equal(depth[i].numpy(), d.numpy())
        np.testing.assert_array_equal(color[i].numpy(), c.numpy())


# ------------------------------------------ the fixture at template poses ---

# (viewpoint index at radius 500, in-plane angle): view 1 holds a pixel that
# only the padding faces cover, far from their projection
TEMPLATE_VIEWS = [(0, -45.0), (5, 15.0), (40, 35.0)]


@pytest.fixture(scope="module")
def template_renders():
    """The fixture model at three template poses (radius 500, the 320 x 320
    window at origin (160, 80)), rendered by JAX's `render` as a standalone
    program and as template generation compiles it (an outer jit and
    lax.map closing over the mesh and the camera), and by the port with and
    without `focal_reciprocal`."""
    import jax

    from linemod_tpu.ops.rasterizer import mesh_to_arrays as jax_arrays
    from linemod_tpu.ops.rasterizer import render as jax_render
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.models.viewpoints import camera_view_points
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.utils.geometry import quat_to_mat, template_view_pose
    from linemod_tpu_torch.utils.ply import load_ply

    cam = CameraParameters()
    mesh = load_ply(MODEL)
    vps = camera_view_points(500.0, 3)
    rots = np.array([quat_to_mat(template_view_pose(vps[i], a)) for i, a in TEMPLATE_VIEWS], np.float32)
    trans = np.tile(np.array([[0.0, 0.0, 500.0]], np.float32), (len(rots), 1))
    kw = dict(width=320, height=320, with_color=True, origin=(160.0, 80.0))
    args = (cam.fx, cam.fy, cam.width / 2.0, cam.height / 2.0)
    jmesh = jax_arrays(mesh)
    standalone = [jax_render(jmesh, jnp.asarray(r), jnp.asarray(t), *args, **kw) for r, t in zip(rots, trans)]

    @jax.jit
    def generation(rs, ts):
        return jax.lax.map(lambda rt: jax_render(jmesh, rt[0], rt[1], *args, **kw), (rs, ts))

    gen = generation(jnp.asarray(rots), jnp.asarray(trans))
    pmesh = mesh_to_arrays(mesh, "cpu")
    out = {}
    for i in range(len(rots)):
        out["standalone", i] = tuple(np.asarray(a) for a in standalone[i])
        out["generation", i] = (np.asarray(gen[0][i]), np.asarray(gen[1][i]))
        for form, recip in (("port", False), ("port_gen", True)):
            d, c = render(pmesh, rots[i], trans[i], *args, focal_reciprocal=recip, **kw)
            out[form, i] = (d.numpy(), c.numpy())
    return out


@pytest.mark.parametrize("view", range(len(TEMPLATE_VIEWS)))
@pytest.mark.parametrize("form", ["standalone", "generation"])
def test_template_pose_render_equals_jax(template_renders, form, view):
    """Depth and color at a template pose, bit for bit: the default render
    against JAX's standalone program, `focal_reciprocal` against the
    generation program's."""
    want = template_renders[form, view]
    got = template_renders["port" if form == "standalone" else "port_gen", view]
    assert (want[0] > 0).sum() > 3000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_template_forms_differ():
    """The two forms are different programs: XLA multiplies by the focal
    lengths' reciprocals where the camera is a constant. The port's forms
    differ likewise (so neither test above is vacuous)."""
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    mesh = square_mesh(z=620.0, half=60.0, slant=0.3)
    rot = rotation_about_axis([0.1, 0.3, 1.0], 0.4).astype(np.float32)
    kw = dict(width=W, height=H)
    a = render(mesh_to_arrays(mesh, "cpu"), rot, np.zeros(3, np.float32), 1044.87, 1045.69141, CX, CY,
               **kw).numpy()
    b = render(mesh_to_arrays(mesh, "cpu"), rot, np.zeros(3, np.float32), 1044.87, 1045.69141, CX, CY,
               focal_reciprocal=True, **kw).numpy()
    np.testing.assert_array_equal(a > 0, b > 0)
    assert (a != b).sum() > 0 and float(np.abs(a - b).max()) < 1e-2


# ---------------------------------------- the fixture's ground-truth pose ---

@pytest.fixture(scope="module")
def pose0_scene():
    """The fixture mesh and pose0 (the port's readers), the port's render of
    pose0 and the JAX package's."""
    from linemod_tpu.ops.metrics import render_pose_depth as jax_render_pose
    from linemod_tpu.ops.rasterizer import mesh_to_arrays as jax_arrays
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops.metrics import render_pose_depth
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.utils.ply import load_ply

    cam = CameraParameters()
    mesh = load_ply(MODEL)
    gt = read_ground_truth_pose(POSE0)
    rot = gt.rotation_matrix().astype(np.float32)
    trans = gt.translation.astype(np.float32)
    got = render_pose_depth(mesh_to_arrays(mesh, "cpu"), rot, trans, cam.fx, cam.fy,
                            width=cam.width, height=cam.height).numpy()
    want = np.asarray(jax_render_pose(jax_arrays(mesh), jnp.asarray(rot), jnp.asarray(trans),
                                      cam.fx, cam.fy, width=cam.width, height=cam.height))
    return cam, mesh, gt, got, want


def test_pose0_render_equals_jax(pose0_scene):
    *_, got, want = pose0_scene
    covered = int((want > 0).sum())
    assert 6000 < covered < 8000  # one ~93 x 92 px blob
    assert int(((got > 0) != (want > 0)).sum()) <= COVERAGE_FRACTION * covered
    both = (got > 0) & (want > 0)
    assert float(np.abs(got - want)[both].max()) <= DEPTH_ATOL_MM
    ys, xs = np.nonzero(got)
    assert 560 < got[both].min() and got[both].max() < 650
    assert abs(xs.mean() - 320) < 60 and abs(ys.mean() - 240) < 60


def test_vsd_zero_for_identical(pose0_scene):
    from linemod_tpu_torch.ops.metrics import vsd_error

    d = torch.from_numpy(pose0_scene[3])
    assert float(vsd_error(d, d, d)) == pytest.approx(0.0, abs=1e-6)


def test_vsd_high_for_disjoint(pose0_scene):
    from linemod_tpu_torch.ops.metrics import vsd_error

    depth = pose0_scene[3]
    e = float(vsd_error(torch.from_numpy(depth), torch.from_numpy(np.roll(depth, 200, axis=1)),
                        torch.from_numpy(depth)))
    assert e > 0.8


def test_add_errors(pose0_scene):
    from linemod_tpu_torch.ops.metrics import OBJECT_DIAMETER, add_error, adds_error
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    _, mesh, gt, _, _ = pose0_scene
    v = torch.from_numpy(mesh.vertices)
    r = torch.from_numpy(gt.rotation_matrix().astype(np.float32))
    t = torch.from_numpy(gt.translation.astype(np.float32))
    assert float(add_error(v, r, t, r, t)) == pytest.approx(0.0, abs=1e-3)
    t2 = t + torch.tensor([10.0, 0.0, 0.0])
    assert float(add_error(v, r, t, r, t2)) == pytest.approx(10.0, abs=1e-2)
    sub = torch.from_numpy(mesh.subsampled_vertices(40))
    assert float(adds_error(sub, r, t, r, t2)) <= 10.0 + 1e-3  # ADD-S <= ADD
    # a rotation about the symmetry axis (model y) keeps ADD-S small
    rsym = r @ torch.from_numpy(rotation_about_axis([0, 1, 0], np.radians(30)).astype(np.float32))
    assert float(adds_error(sub, r, t, rsym, t)) < OBJECT_DIAMETER


# ----------------------------------------------- the metrics against JAX ---

def _seeded_pose(rng, gt):
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    rot = rotation_about_axis(rng.normal(size=3), rng.uniform(-0.2, 0.2)) @ gt.rotation_matrix()
    return rot.astype(np.float32), (gt.translation + rng.normal(0, 8, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax_on_seeded_poses(pose0_scene, seed):
    """VSD (on the port's renders, with a seeded scene), ADD and ADD-S of a
    seeded estimate against pose0, port against JAX."""
    from linemod_tpu.ops.metrics import add_error as j_add
    from linemod_tpu.ops.metrics import adds_error as j_adds
    from linemod_tpu.ops.metrics import vsd_error as j_vsd
    from linemod_tpu_torch.ops.metrics import add_error, adds_error, render_pose_depth, vsd_error
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays

    cam, mesh, gt, gt_r, _ = pose0_scene
    rng = np.random.default_rng(seed)
    rot, trans = _seeded_pose(rng, gt)
    est_r = render_pose_depth(mesh_to_arrays(mesh, "cpu"), rot, trans, cam.fx, cam.fy,
                              width=cam.width, height=cam.height).numpy()
    scene = np.where(rng.uniform(size=gt_r.shape) < 0.2, 0.0, gt_r + rng.normal(0, 10, gt_r.shape))
    scene = scene.astype(np.float32)
    got = float(vsd_error(*(torch.from_numpy(a) for a in (gt_r, est_r, scene))))
    want = float(j_vsd(*(jnp.asarray(a) for a in (gt_r, est_r, scene))))
    assert got == pytest.approx(want, abs=METRIC_ATOL) and 0.0 < got < 1.0
    r_gt = gt.rotation_matrix().astype(np.float32)
    t_gt = gt.translation.astype(np.float32)
    for port_fn, jax_fn, verts in ((add_error, j_add, mesh.vertices),
                                   (adds_error, j_adds, mesh.subsampled_vertices(40))):
        args = (verts, r_gt, t_gt, rot, trans)
        got = float(port_fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
        want = float(jax_fn(*(jnp.asarray(a) for a in args)))
        assert got == pytest.approx(want, abs=METRIC_ATOL)


def test_benchmark_scores_and_counters_equal_jax(pose0_scene, tmp_path):
    """The port's Benchmark against JAX's on pose0 and a seeded estimate:
    VSD, ADD, ADD-S and the counters."""
    from linemod_tpu.config import CameraParameters as JCam
    from linemod_tpu.pipeline.benchmark import Benchmark as JaxBenchmark
    from linemod_tpu.types import ObjectPose as JPose
    from linemod_tpu.utils.ply import load_ply as jax_load_ply
    from linemod_tpu_torch.pipeline.benchmark import Benchmark
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.geometry import mat_to_quat

    cam, mesh, gt, gt_r, _ = pose0_scene
    rot, trans = _seeded_pose(np.random.default_rng(5), gt)
    est = ObjectPose(translation=trans.astype(np.float64), quaternion=mat_to_quat(rot))
    scene = gt_r + 5.0
    bench = Benchmark(mesh, cam, "cpu")
    jbench = JaxBenchmark(jax_load_ply(MODEL), JCam())
    jgt, jest = (JPose(translation=p.translation, quaternion=p.quaternion) for p in (gt, est))
    for pose, jpose in ((gt, jgt), (est, jest)):
        bench.next_image()
        jbench.next_image()
        assert bench.score_vsd(scene, gt, pose) == pytest.approx(
            jbench.score_vsd(scene, jgt, jpose), abs=METRIC_ATOL)
        assert bench.score_add(gt, pose) == pytest.approx(jbench.score_add(jgt, jpose), abs=METRIC_ATOL)
        assert bench.score_adds(gt, pose) == pytest.approx(jbench.score_adds(jgt, jpose), abs=METRIC_ATOL)
    assert (bench.image_counter, bench.hodan_correct, bench.add_correct) == (
        jbench.image_counter, jbench.hodan_correct, jbench.add_correct)
    assert bench.hodan_score == jbench.hodan_score
    assert bench.hodan_correct >= 1  # pose0 against itself


def test_read_ground_truth_linemod_equals_jax(tmp_path):
    """A .tra/.rot pair (cm, and the frame fix about x) read by both."""
    from linemod_tpu.pipeline.benchmark import read_ground_truth_linemod as jax_read
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_linemod
    from linemod_tpu_torch.utils.geometry import rotation_about_axis

    rot = rotation_about_axis([0.3, -0.5, 0.8], 0.7)
    tra, rot_p = tmp_path / "tra0.tra", tmp_path / "rot0.rot"
    tra.write_text("1 3\n1.5 -2.25 60.125\n")
    rot_p.write_text("3 3\n" + "\n".join(" ".join(f"{v:.9f}" for v in row) for row in rot) + "\n")
    got = read_ground_truth_linemod(str(tra), str(rot_p))
    want = jax_read(str(tra), str(rot_p))
    np.testing.assert_allclose(got.translation, [15.0, -22.5, 601.25], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.translation, want.translation)
    np.testing.assert_array_equal(got.quaternion, want.quaternion)
    fixed = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0) @ np.loadtxt(rot_p, skiprows=1)
    np.testing.assert_allclose(got.rotation_matrix(), fixed, rtol=0, atol=1e-8)
