"""Offline template generation in the port against the JAX package on the
CPU: the pose math, settings, viewpoints, mesh import and bank persistence
that generation uses (the cases of tests/test_core.py and
tests/test_mesh_io.py, plus equality with JAX's functions), and whole banks
built by `build_template_bank` in both packages, held equal array for array
(`np.array_equal` on every field): the cube of tests/test_matching.py
(color) and tests/test_dual_modality.py (dual), the tetrahedron and the
octahedron of tests/test_multi_model.py, and the tetrahedron over the
whole, unpruned icosphere. `TemplateGenerator` writes the same bank and
skips it on a second run.

The fixture model's banks are held to the committed goldens in
tests/test_torch_generate_fixture.py. Running this file regenerates the
color golden, JAX's CPU generation of the fixture at radius 500 (about 3
minutes):

    env JAX_PLATFORMS=cpu python tests/test_torch_generate.py
"""

import dataclasses
import os
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
MODEL = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
COLOR_GOLDEN = os.path.join(REPO, "tests", "goldens", "gen_color_r500_ref.npz")
FIELDS = ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull")
DUAL_FIELDS = ("nfeat0", "nvalid0", "nfeat1", "nvalid1")


def port_config(cam, settings, props):
    """The JAX package's config dataclasses as the port's (same fields)."""
    from linemod_tpu_torch import config as pc

    return (pc.CameraParameters(**dataclasses.asdict(cam)),
            pc.TemplateSettings(**dataclasses.asdict(settings)),
            pc.ModelProperties(**dataclasses.asdict(props)))


def port_mesh(mesh):
    from linemod_tpu_torch.utils.ply import Mesh

    return Mesh(vertices=mesh.vertices, colors=mesh.colors, indices=mesh.indices, normals=mesh.normals)


def assert_banks_equal(got, want):
    """Every array of the two banks equal (shape, dtype and values)."""
    assert got.dual_modality == want.dual_modality
    assert got.num_templates == want.num_templates > 0
    for f in FIELDS + (DUAL_FIELDS if want.dual_modality else ()):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), (f, np.nonzero((a != b).reshape(len(a), -1).any(1))[0])


# ------------------------------------------------------------- pose math ---

def test_template_view_pose_equals_jax(rng):
    """Template poses, their up vectors and quaternion products, bit for bit
    (float64 numpy in both), with the on-axis nudge."""
    from linemod_tpu.utils import geometry as jg
    from linemod_tpu_torch.utils import geometry as pg

    assert np.array_equal(pg.GL_TO_CV, jg.GL_TO_CV)
    points = [rng.normal(size=3) * 500 for _ in range(20)] + [np.array([0.0, 500.0, 0.0])]
    for p in points:
        assert np.array_equal(pg.camera_up_on_sphere(p), jg.camera_up_on_sphere(p))
        for a in (-45.0, 0.0, 35.0):
            assert np.array_equal(pg.template_view_pose(p, a), jg.template_view_pose(p, a))
    for _ in range(10):
        a, b = rng.normal(size=4), rng.normal(size=4)
        assert np.array_equal(pg.quat_mul(a, b), jg.quat_mul(a, b))


def test_template_pose_frontal_and_in_plane():
    from linemod_tpu_torch.utils.geometry import GL_TO_CV, quat_to_mat, rotation_about_axis, template_view_pose

    np.testing.assert_allclose(quat_to_mat(template_view_pose([0.0, 0.0, 500.0], 0.0)),
                               np.diag([1.0, -1.0, -1.0]), atol=1e-6)
    q0 = quat_to_mat(template_view_pose([0.0, 0.0, 500.0], 0.0))
    rel = quat_to_mat(template_view_pose([0.0, 0.0, 500.0], 30.0)) @ q0.T
    assert np.degrees(np.arccos((np.trace(rel) - 1) / 2)) == pytest.approx(30.0, abs=1e-4)
    np.testing.assert_allclose(rel[2, 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(GL_TO_CV, rotation_about_axis([1, 0, 0], np.pi), atol=1e-12)


def test_settings_angles_radii_and_listing(tmp_path):
    from linemod_tpu.config import TemplateSettings as JSettings
    from linemod_tpu.config import files_in_directory as j_files
    from linemod_tpu_torch.config import TemplateSettings, files_in_directory, load_settings

    _, s = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    js = JSettings(**dataclasses.asdict(s))
    for a, b in ((s.in_plane_angles, js.in_plane_angles), (s.radii, js.radii)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert len(s.radii) == 15 and len(s.in_plane_angles) == 10
    assert np.array_equal(TemplateSettings(angle_start=-45, angle_stop=-45).in_plane_angles, [-45.0])
    for name in ("b.ply", "a.ply", "c.obj"):
        (tmp_path / name).write_text("")
    assert files_in_directory(str(tmp_path), ".ply") == j_files(str(tmp_path), ".ply") == ["a.ply", "b.ply"]
    assert files_in_directory(str(tmp_path / "missing"), ".ply") == []


# --------------------------------------------------------------- atan2 ---

def test_atan2_equals_xla():
    """The quantizers' atan2 equals XLA's CPU arctan2 bit for bit (the C
    library's atan2f): normal, integer-grid and extreme-exponent inputs,
    zeros of both signs and x = 1, where torch.atan2 differs on ~16%."""
    import jax
    import jax.numpy as jnp

    from linemod_tpu_torch.ops.gradients import atan2

    rng = np.random.default_rng(5)
    n = 400_000
    y = np.concatenate([rng.standard_normal(n) * 30, rng.integers(-600, 600, n) * 0.25,
                        2.0 ** rng.integers(-70, 70, n) * rng.choice([-1, 1], n)]).astype(np.float32)
    x = np.concatenate([rng.standard_normal(n) * 30, rng.integers(-600, 600, n) * 0.25,
                        2.0 ** rng.integers(-70, 70, n) * rng.choice([-1, 1], n)]).astype(np.float32)
    y[::97], y[::79], x[::89], x[::83] = 0.0, -0.0, 0.0, 1.0
    want = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    got = atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy() != want).mean() > 0.05


# ------------------------------------------------- scattered selection ---

@pytest.mark.parametrize("seed", [0, 1])
def test_select_scattered_features_equals_jax(seed):
    """The cut and the greedy scan on seeded [4, 48, 40] maps with integer
    scores (ties everywhere: top_k keeps the lower index) and masks from
    sparse to dense (fewer candidates than 512, fewer features than 63,
    the minimum distance shrinking), against JAX's vmapped function."""
    import jax
    import jax.numpy as jnp

    from linemod_tpu.ops.extract import erode_mask as j_erode
    from linemod_tpu.ops.extract import select_scattered_features as j_select
    from linemod_tpu_torch.ops.extract import erode_mask, select_scattered_features

    rng = np.random.default_rng(seed)
    score = rng.integers(0, 6, (4, 48, 40)).astype(np.float32)
    quant = (1 << rng.integers(0, 8, (4, 48, 40))).astype(np.uint8)
    mask = rng.uniform(size=(4, 48, 40)) < np.array([0.01, 0.1, 0.4, 0.9])[:, None, None]
    want = jax.vmap(j_select)(jnp.asarray(score), jnp.asarray(quant), jnp.asarray(mask))
    got = select_scattered_features(*(torch.from_numpy(a) for a in (score, quant, mask)))
    for name, a, b in zip(("x", "y", "ori", "valid"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert 0 < got[3].sum(1).min() and got[3].sum(1).max() == 63
    blob = rng.uniform(size=(3, 48, 40)) < 0.8
    assert np.array_equal(erode_mask(torch.from_numpy(blob)).numpy(),
                          np.asarray(jax.vmap(j_erode)(jnp.asarray(blob))))


# ------------------------------------------------------------ viewpoints ---

def test_icosphere_counts_and_radius():
    from linemod_tpu_torch.models.viewpoints import icosphere

    assert [icosphere(500.0, s).shape[0] for s in range(4)] == [12, 42, 162, 642]
    np.testing.assert_allclose(np.linalg.norm(icosphere(700.0, 2), axis=1), 700.0, rtol=1e-9)


def test_rot_sym_circle_and_pruning():
    from linemod_tpu_torch.models.viewpoints import camera_view_points, icosphere, prune_by_symmetry, rot_sym_circle

    v = rot_sym_circle(500.0, 3)
    assert v.shape[0] == 48  # the exact 7.5 degree step
    np.testing.assert_allclose(v[:, 0], 0.0)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 500.0, rtol=1e-9)
    # the fixture: rotationally symmetric, planes (1, 1, 1) -> 0..90 degrees
    v = camera_view_points(500.0, 3, True, (1.0, 1.0, 1.0))
    assert v.shape[0] == 13 and np.all(v[:, 1] >= 0) and np.all(v[:, 2] >= 0)
    assert prune_by_symmetry(icosphere(500.0, 1), (0.0, 0.0, 0.0)).shape[0] == 42


@pytest.mark.parametrize("args", [
    (500.0, 3, True, (1.0, 1.0, 1.0)), (600.0, 0, False, (1.0, 1.0, 1.0)),
    (650.0, 2, False, (0.0, 0.0, 0.0)), (1200.0, 1, False, (1.0, 0.0, -1.0)),
    (800.0, 2, True, (0.0, 1.0, 0.0)),
], ids=["fixture", "octant", "sphere", "planes", "circle"])
def test_camera_view_points_equal_jax(args):
    from linemod_tpu.models.viewpoints import camera_view_points as j_vps
    from linemod_tpu_torch.models.viewpoints import camera_view_points

    got, want = camera_view_points(*args), j_vps(*args)
    assert got.shape == want.shape and np.array_equal(got, want)


# ------------------------------------------------------------ mesh import ---

@pytest.fixture(scope="module")
def fixture_mesh():
    from linemod_tpu_torch.utils.ply import load_ply

    return load_ply(MODEL)


def write_obj(path, mesh, polygons=False):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for a, b, c in mesh.indices:
            tail = f" {c+1}//{c+1}" if polygons else ""
            f.write(f"f {a+1}//{a+1} {b+1}//{b+1} {c+1}//{c+1}{tail}\n")


def write_stl_binary(path, mesh):
    v = mesh.vertices
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(mesh.indices)))
        for a, b, c in mesh.indices:
            n = np.cross(v[b] - v[a], v[c] - v[a])
            n = n / max(np.linalg.norm(n), 1e-12)
            for row in (n, v[a], v[b], v[c]):
                f.write(np.asarray(row, "<f4").tobytes())
            f.write(b"\0\0")


def assert_meshes_equal(got, want):
    for f in ("vertices", "colors", "indices", "normals"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_obj_roundtrip_equals_jax(fixture_mesh, tmp_path):
    from linemod_tpu.utils.mesh_io import load_mesh as j_load
    from linemod_tpu_torch.utils.mesh_io import load_mesh

    p = str(tmp_path / "fixture.obj")
    write_obj(p, fixture_mesh)
    m = load_mesh(p)
    np.testing.assert_allclose(m.vertices, fixture_mesh.vertices, rtol=1e-5)
    np.testing.assert_array_equal(m.indices, fixture_mesh.indices)
    np.testing.assert_allclose(m.normals, fixture_mesh.normals, atol=1e-4)
    assert np.all(m.colors == 1.0)  # no colors in the file: white
    assert_meshes_equal(m, j_load(p))


def test_obj_polygon_fan_triangulation(fixture_mesh, tmp_path):
    from linemod_tpu_torch.utils.mesh_io import load_obj

    p = str(tmp_path / "fixture_poly.obj")
    write_obj(p, fixture_mesh, polygons=True)
    m = load_obj(p)
    assert m.indices.shape[0] == 2 * fixture_mesh.indices.shape[0]
    np.testing.assert_allclose(m.vertices, fixture_mesh.vertices, rtol=1e-5)


def test_stl_binary_roundtrip_equals_jax(fixture_mesh, tmp_path):
    from linemod_tpu.utils.mesh_io import load_stl as j_load_stl
    from linemod_tpu_torch.utils.mesh_io import load_stl

    p = str(tmp_path / "fixture.stl")
    write_stl_binary(p, fixture_mesh)
    m = load_stl(p)
    used = np.asarray(fixture_mesh.vertices, np.float32)[np.unique(fixture_mesh.indices.ravel())]
    np.testing.assert_allclose(np.unique(m.vertices, axis=0), np.unique(used, axis=0), rtol=1e-5)
    assert m.indices.shape[0] == fixture_mesh.indices.shape[0]
    assert np.all(m.colors == 1.0) and np.all(np.linalg.norm(m.normals, axis=1) > 0.9)
    assert_meshes_equal(m, j_load_stl(p))


def test_stl_ascii_and_unsupported(tmp_path):
    from linemod_tpu.utils.mesh_io import load_mesh as j_load
    from linemod_tpu_torch.utils.mesh_io import load_mesh

    p = str(tmp_path / "tri.stl")
    with open(p, "w") as f:
        f.write("solid x\n facet normal 0 0 1\n  outer loop\n")
        f.write("   vertex 0 0 0\n   vertex 1 0 0\n   vertex 0 1 0\n")
        f.write("  endloop\n endfacet\nendsolid x\n")
    m = load_mesh(p)
    assert m.num_faces == 1 and m.num_vertices == 3
    assert_meshes_equal(m, j_load(p))
    with pytest.raises(ValueError, match="unsupported"):
        load_mesh(str(tmp_path / "x.fbx"))


# ---------------------------------------------------------- persistence ---

@pytest.mark.parametrize("dual", [False, True], ids=["color", "dual"])
def test_synthetic_bank_and_save_load_across_packages(dual, tmp_path):
    """`make_synthetic_bank` equals JAX's for a seed; a bank saved by either
    package loads in the other with every array equal."""
    from linemod_tpu.models.template_bank import TemplateBank as JBank
    from linemod_tpu.models.template_bank import make_synthetic_bank as j_synth
    from linemod_tpu_torch.models.template_bank import TemplateBank, make_synthetic_bank

    got, want = make_synthetic_bank(40, seed=3, dual_modality=dual), j_synth(40, seed=3, dual_modality=dual)
    assert_banks_equal(got, want)
    p = str(tmp_path / "port.npz")
    got.save(p)
    assert_banks_equal(TemplateBank.load(p), got)
    assert_banks_equal(JBank.load(p), got)
    q = str(tmp_path / "jax.npz")
    want.save(q)
    back = TemplateBank.load(q)
    assert back.class_id == "synthetic"
    assert_banks_equal(back, want)


# ------------------------------------------------ whole banks against JAX ---

def _cam():
    from linemod_tpu.config import CameraParameters

    return CameraParameters(fx=500.0, fy=500.0, cx=320, cy=240, width=640, height=480)


def _settings(**kw):
    from linemod_tpu.config import TemplateSettings

    base = dict(distance_start=600, distance_stop=600, distance_step=50, subdivisions=0,
                angle_start=-45, angle_stop=45, angle_step=45, depth_offset=0.0)
    return TemplateSettings(**{**base, **kw})


def _mesh(name):
    from test_matching import cube_mesh
    from test_multi_model import octa_mesh, tetra_mesh

    return {"cube": cube_mesh, "tetra": tetra_mesh, "octa": octa_mesh}[name]()


BANK_CASES = {
    # tests/test_matching.py's cube, color only
    "cube": ("cube", dict(), (1.0, 1.0, 1.0)),
    # tests/test_dual_modality.py's cube, color gradients and depth normals
    "cube_dual": ("cube", dict(only_color_modality=False), (1.0, 1.0, 1.0)),
    # tests/test_multi_model.py's classes
    "tetra": ("tetra", dict(), (1.0, 1.0, 1.0)),
    "octa": ("octa", dict(), (1.0, 1.0, 1.0)),
    # no symmetry: all 12 icosphere viewpoints, at one in-plane angle
    "tetra_sphere": ("tetra", dict(angle_start=20, angle_stop=20), (0.0, 0.0, 0.0)),
    # three radii: the rows radius by radius, each radius scanned alone
    "cube_radii": ("cube", dict(distance_start=550, distance_stop=650), (1.0, 1.0, 1.0)),
    "cube_dual_radii": ("cube", dict(distance_start=550, distance_stop=650, only_color_modality=False),
                        (1.0, 1.0, 1.0)),
}
_JAX_BANKS = {}


def _case(case):
    """(mesh, class name, JAX's cam, settings and properties) of a case."""
    from linemod_tpu.config import ModelProperties

    name, kw, planes = BANK_CASES[case]
    return _mesh(name), name, _cam(), _settings(**kw), ModelProperties(planes_of_symmetry=planes)


def _jax_bank(case):
    """JAX's bank of a case and its progress calls, built once a module."""
    from linemod_tpu.models.template_bank import build_template_bank as j_build

    if case not in _JAX_BANKS:
        mesh, name, cam, settings, props = _case(case)
        calls = []
        bank = j_build(mesh, name, cam, settings, props, progress=lambda r, n: calls.append((r, n)))
        _JAX_BANKS[case] = bank, calls
    return _JAX_BANKS[case]


@pytest.mark.parametrize("case", list(BANK_CASES))
def test_bank_equals_jax(case):
    from linemod_tpu_torch.models.template_bank import build_template_bank

    mesh, name, cam, settings, props = _case(case)
    want, want_calls = _jax_bank(case)
    timings, seen = {}, []
    got = build_template_bank(port_mesh(mesh), name, *port_config(cam, settings, props), "cpu",
                              progress=lambda r, n: seen.append((r, n)), timings=timings)
    assert got.class_id == name
    assert_banks_equal(got, want)
    assert seen == want_calls and len(seen) == len(settings.radii)
    assert set(timings) == {"render", "quantize", "cut", "scan", "assemble"}
    assert all(t >= 0.0 for t in timings.values())


@pytest.mark.parametrize("radii_a_scan", [1, 2])
@pytest.mark.parametrize("case", ["cube_radii", "cube_dual_radii"])
def test_bank_scans_a_radius_and_takes_p20_a_chunk(case, radii_a_scan, monkeypatch):
    """Generation scans whole radii, each once: with SCAN_VIEWS of one
    radius's views, each radius alone (keys x its views); with two radii's,
    the first two together and the last alone. It never hands `_p20` more
    than VIEW_CHUNK views, and reports progress as JAX does: (radius,
    templates kept so far)."""
    from linemod_tpu_torch.models import template_bank

    scanned, p20_views = [], []
    scan, p20 = template_bank.scan_select, template_bank._p20

    def spy_scan(c, *args):
        scanned.append(c.x.shape[0])
        return scan(c, *args)

    def spy_p20(depth, box):
        p20_views.append(depth.shape[0])
        return p20(depth, box)

    mesh, name, cam, settings, props = _case(case)
    views = 3 * len(settings.in_plane_angles)  # the cube's 3 viewpoints a radius
    monkeypatch.setattr(template_bank, "VIEW_CHUNK", 5)
    monkeypatch.setattr(template_bank, "SCAN_VIEWS", radii_a_scan * views)
    monkeypatch.setattr(template_bank, "scan_select", spy_scan)
    monkeypatch.setattr(template_bank, "_p20", spy_p20)
    seen = []
    got = template_bank.build_template_bank(port_mesh(mesh), name, *port_config(cam, settings, props), "cpu",
                                            progress=lambda r, n: seen.append((r, n)))
    want, want_calls = _jax_bank(case)
    assert_banks_equal(got, want)
    keys = 2 if settings.only_color_modality else 4
    assert len(settings.radii) == 3
    assert scanned == ([keys * views] * 3 if radii_a_scan == 1 else [2 * keys * views, keys * views])
    assert p20_views == [5, views - 5] * 3
    assert seen == want_calls and [r for r, _ in seen] == [550.0, 600.0, 650.0]


def test_template_generator_writes_and_skips(tmp_path):
    """`TemplateGenerator.run` builds the bank of each model in the folder
    (an OBJ cube here), saves it, and loads it on a second run."""
    from linemod_tpu_torch.config import CameraParameters, TemplateSettings
    from linemod_tpu_torch.models.template_bank import build_template_bank
    from linemod_tpu_torch.pipeline.template_generator import TemplateGenerator
    from linemod_tpu_torch.utils.mesh_io import load_mesh

    models = tmp_path / "models"
    models.mkdir()
    cube = _mesh("cube")
    with open(models / "cube.obj", "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in cube.vertices)
        f.writelines(f"f {a+1} {b+1} {c+1}\n" for a, b, c in cube.indices)
    (models / "cube.yml").write_text("%YAML:1.0\n---\nplanes of symmetry: [ 1, 1, 1 ]\n")
    cam = CameraParameters(**dataclasses.asdict(_cam()))
    settings = TemplateSettings(**{**dataclasses.asdict(_settings()), "model_folder": str(models),
                                   "model_file_ending": ".obj", "angle_step": 90})
    gen = TemplateGenerator(cam, settings, str(tmp_path / "banks"), "cpu")
    (bank,) = gen.run(verbose=False)
    assert os.path.exists(gen.bank_path("cube.obj")) and os.path.exists(gen.bank_path("cube.obj") + ".json")
    from linemod_tpu_torch.config import load_model_properties

    props = load_model_properties(str(models / "cube.obj"))
    assert props.planes_of_symmetry == (1.0, 1.0, 1.0)
    want = build_template_bank(load_mesh(str(models / "cube.obj")), "cube.obj", cam, settings, props, "cpu")
    assert bank.num_templates == 6
    assert_banks_equal(bank, want)
    (again,) = gen.run(verbose=False)
    assert_banks_equal(again, want)


def main():
    """Regenerate the color golden with the JAX package on the CPU."""
    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import build_template_bank
    from linemod_tpu.utils.mesh_io import load_mesh

    cam, s = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    s = dataclasses.replace(s, distance_stop=s.distance_start)
    bank = build_template_bank(load_mesh(MODEL), "lagergehaeuse.ply", cam, s, load_model_properties(MODEL))
    np.savez_compressed(COLOR_GOLDEN, **{f: getattr(bank, f) for f in FIELDS})
    print(f"{bank.num_templates} templates -> {COLOR_GOLDEN}")


if __name__ == "__main__":
    main()


@pytest.mark.parametrize("case", ["tetra_sphere", "cube_dual", "cube_radii", "cube_dual_radii"])
def test_bank_in_view_chunks_equals_jax(case, monkeypatch):
    """A radius rendered, quantized, cut and reduced to p20 depths in
    chunks of views (5 of its 12 or 9 here; the card's generation takes 256
    at a time) gives JAX's bank."""
    from linemod_tpu_torch.models import template_bank

    monkeypatch.setattr(template_bank, "VIEW_CHUNK", 5)
    mesh, name, cam, settings, props = _case(case)
    got = template_bank.build_template_bank(port_mesh(mesh), name, *port_config(cam, settings, props), "cpu")
    assert got.num_templates > template_bank.VIEW_CHUNK
    assert_banks_equal(got, _jax_bank(case)[0])
