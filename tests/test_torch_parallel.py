"""The port's bank sharding (`linemod_tpu_torch/parallel/`) on CPU ranks
against the JAX reference: the cases of tests/test_parallel.py and
tests/test_multihost.py, the fixture frame at tp 8, the mesh layouts and
the process-group bootstrap, and the band helpers of `ops/spread.py`.

One gloo world of 8 CPU ranks runs every sharded case in sequence: the
module fixture `world` starts this file as 8 processes (its `__main__`
block is a rank's entry, as tests/multihost_worker.py is for JAX) with
LOCAL_WORLD_SIZE=4, so that the world is two "nodes" of 4 ranks, and each
rank writes its outputs to an .npz. Meshes of tp 2 and 4 use the first 2
or 4 ranks; the others idle. The pytest process builds the inputs (the
cube scene of tests/test_parallel.py drawn by the port's renderer, with
the port's build_template_bank) and, while the ranks run, the port's
single-device match_templates and JAX's on the same inputs.

Tolerance: every output (template_id, x, y, similarity, valid) equal bit
for bit, on every rank of the mesh, to both.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")
N_RANKS = 8
KEYS = ("template_id", "x", "y", "similarity", "valid")
WORLD_TIMEOUT_S = 300
# (name, tp, dp) of the meshes every rank builds, in this order; "t8" is
# global_detection_mesh(dp=3), which does not divide 8 and falls back to dp 1
MESHES = (("md", 4, 2), ("t8", 8, 1), ("t4", 4, 1), ("t2", 2, 1))

# the match configs of tests/test_parallel.py and tests/test_multihost.py
CUBE_A = dict(top_k=64, template_chunk=2, threshold=80.0)
CUBE_B = dict(top_k=64, template_chunk=16, threshold=80.0)
CUBE_C = dict(top_k=512, template_chunk=2, threshold=80.0)
SYN = dict(top_k=32, template_chunk=8, threshold=80.0)
SAT = dict(top_k=16, template_chunk=8, threshold=0.0)
MULTIHOST = dict(width=320, height=240, top_k=64, template_chunk=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------- inputs ---

def _cube_bank_scene():
    """tests/test_parallel.py:20-38 with the port: the cube bank (9
    templates) and the cube rendered at template 4's rotation, 600 mm."""
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.models.template_bank import build_template_bank
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render_views
    from linemod_tpu_torch.utils.geometry import quat_to_mat
    from linemod_tpu_torch.utils.ply import Mesh
    from test_matching import cube_mesh

    cam = CameraParameters(fx=500.0, fy=500.0, cx=320, cy=240, width=640, height=480)
    settings = TemplateSettings(
        distance_start=600, distance_stop=600, subdivisions=0, angle_start=-45, angle_stop=45, angle_step=45,
    )
    props = ModelProperties(planes_of_symmetry=(1.0, 1.0, 1.0))
    jm = cube_mesh()
    mesh = Mesh(vertices=jm.vertices, colors=jm.colors, indices=jm.indices, normals=jm.normals)
    bank = build_template_bank(mesh, "cube", cam, settings, props, "cpu")
    rot = quat_to_mat(bank.quat[4]).astype(np.float32)
    depth, color = render_views(
        mesh_to_arrays(mesh, "cpu"), rot[None], np.array([[0, 0, 600.0]], np.float32), cam, with_color=True,
    )
    return bank, color[0].numpy() * 255.0, depth[0].numpy()


def _synthetic_bank():
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank

    return make_synthetic_bank(64, seed=11, bbox_wh=48)


def _saturated_bank():
    """tests/test_parallel.py:223: every template a copy of template 0."""
    bank = _synthetic_bank()
    for f in ("feat0", "valid0", "feat1", "valid1"):
        arr = getattr(bank, f)
        arr[:] = arr[:1]
    return bank


def _multihost_bank():
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank

    return make_synthetic_bank(64, seed=7, bbox_wh=48, image_wh=(320, 240))


def _multihost_frames():
    rng = np.random.default_rng(11)
    colors = rng.uniform(0, 255, (2, 240, 320, 3)).astype(np.float32)
    depths = rng.uniform(400, 900, (2, 240, 320)).astype(np.float32)
    return colors, depths


def _make_inputs(path):
    bank, color, depth = _cube_bank_scene()
    bank.save(os.path.join(path, "cube.npz"))
    syn_color = np.random.default_rng(5).uniform(0, 255, (480, 640, 3)).astype(np.float32)
    np.savez(os.path.join(path, "inputs.npz"), cube_color=color, cube_depth=depth, syn_color=syn_color)


# ------------------------------------------------------- a rank's work ---

def _rank_main(path: str) -> None:
    """One rank of the world: every sharded case in sequence, its outputs
    (and each mesh's layout) into rank<r>.npz under `path`."""
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank, _pad_bank
    from linemod_tpu_torch.ops.detect_core import _pack
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state
    from linemod_tpu_torch.parallel.distributed import global_detection_mesh, initialize_distributed
    from linemod_tpu_torch.parallel.mesh import make_mesh
    from linemod_tpu_torch.parallel.sharded_match import (
        all_gather,
        all_true,
        make_sharded_matcher,
        shard_state,
        sharded_detect,
    )
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    dev = initialize_distributed(device="cpu", timeout_s=WORLD_TIMEOUT_S)
    rank = dist.get_rank()
    meshes = {
        "md": global_detection_mesh(),
        "t8": global_detection_mesh(dp=3),
        "t4": make_mesh(4, dp=1),
        "t2": make_mesh(2, dp=1),
    }
    out = {}
    me = torch.tensor([rank])
    for name, mesh in meshes.items():
        out[f"mesh/{name}"] = np.array([mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index])
        if mesh.active:
            for g in ("tp_group", "dp_group", "group"):
                out[f"mesh/{name}/{g}"] = all_gather(me, getattr(mesh, g)).flatten().numpy()
    # sharded_detect's retry decision: a fast matcher whose proof fails on
    # rank 5 alone must send every rank to the exact one
    class OneRankFails:
        mesh = meshes["md"]

        def __call__(self, colors, depths):
            return {"cut_exact": torch.tensor([rank != 5])}

    calls = []
    sharded_detect(OneRankFails(), lambda c, d: calls.append(1), None, None)
    out["retry/one_rank_fails"] = np.array(len(calls))
    out["retry/all_true"] = np.array(all_true(torch.tensor([True, True]), meshes["md"].group))

    inputs = np.load(os.path.join(path, "inputs.npz"))
    cube = TemplateBank.load(os.path.join(path, "cube.npz"))

    def state(bank, pad, **kw):
        return build_match_state(_pad_bank(bank, pad), MatchConfig(**kw), dev)

    def run(name, mesh, st, colors, depths=None, retry=False):
        if not mesh.active:
            return
        sst = shard_state(st, mesh)
        fast = make_sharded_matcher(sst, mesh)
        if retry:
            out[f"{name}/fast_cut_exact"] = fast(colors, depths)["cut_exact"].numpy()
            exact, calls = make_sharded_matcher(sst, mesh, exact_only=True), []

            def exact_spy(c, d):
                calls.append(1)
                return exact(c, d)

            got = sharded_detect(fast, exact_spy, colors, depths)
            out[f"{name}/retries"] = np.array(len(calls))
        else:
            got = fast(colors, depths)
        out.update({f"{name}/{k}": v.numpy() for k, v in got.items()})

    cc, cd = inputs["cube_color"][None], inputs["cube_depth"][None]
    run("equal", meshes["t8"], state(cube, 16, **CUBE_A), cc, cd)
    run("chunk", meshes["t8"], state(cube, 16, **CUBE_B), cc, cd)
    run("dp", meshes["md"], state(cube, 16, **CUBE_A),
        np.concatenate([cc, np.zeros_like(cc)]), np.concatenate([cd, np.zeros_like(cd)]))
    run("two_round", meshes["t8"], state(cube, 16, **CUBE_C), cc, cd)
    run("two_round_retry", meshes["t8"], state(cube, 40, **CUBE_C), cc, cd, retry=True)
    sc = inputs["syn_color"][None]
    syn = _synthetic_bank()
    for tp in (2, 4, 8):
        run(f"prefilter_tp{tp}", meshes[f"t{tp}"], state(syn, 8, **SYN, prefilter_sel=40, scan_chunk=16), sc)
    run("streaming", meshes["t4"], state(syn, 8, **SYN, scan_chunk=8), sc)
    run("prefilter_retry", meshes["t4"], state(_saturated_bank(), 8, **SAT, prefilter_sel=20, scan_chunk=16),
        sc, retry=True)
    run("multihost", meshes["md"], state(_multihost_bank(), 16, **MULTIHOST), *_multihost_frames())

    # the fixture frame with the committed bank (padded to 2,048) at tp 8
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    det = PoseDetection(TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")), cam, settings,
                        None, dev)
    color = det.recenter(read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color"))
    mesh = meshes["t8"]
    got = make_sharded_matcher(shard_state(det.state, mesh), mesh)(color[None])
    out["fixture/packed"] = _pack({k: v[0] for k, v in got.items() if k != "cut_exact"}).numpy()
    out["fixture/cut_exact"] = got["cut_exact"].numpy()

    np.savez(os.path.join(path, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ fixtures ---

@pytest.fixture(scope="module")
def world_procs(tmp_path_factory):
    """The inputs, then the 8 ranks started (not yet waited for)."""
    path = str(tmp_path_factory.mktemp("parallel"))
    torch.set_num_threads(2)
    _make_inputs(path)
    port = _free_port()
    procs = []
    for rank in range(N_RANKS):
        env = dict(os.environ)
        env.update(
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(N_RANKS), RANK=str(rank),
            LOCAL_RANK=str(rank % 4), LOCAL_WORLD_SIZE="4", OMP_NUM_THREADS="1",
            PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    yield path, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


def _single(bank, pad, color, depth=None, **kw):
    """The port's and JAX's single-device match_templates: ({key: array}, {key: array})."""
    import jax.numpy as jnp

    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu.ops.matching import match_templates as jax_match
    from linemod_tpu.pipeline.pose_detection import _pad_bank as jax_pad
    from linemod_tpu_torch.models.template_bank import _pad_bank
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state, match_templates

    depth = np.zeros(color.shape[:2], np.float32) if depth is None else depth
    state = build_match_state(_pad_bank(bank, pad), MatchConfig(**kw), "cpu")
    port = match_templates(state, torch.from_numpy(color), torch.from_numpy(depth))
    jbank = JaxBank(**{f.name: getattr(bank, f.name) for f in dataclasses.fields(JaxBank)})
    jstate = jax_build(jax_pad(jbank, pad), JaxConfig(**kw))
    ref = jax_match(jstate, jnp.asarray(color), jnp.asarray(depth))
    return {k: port[k].numpy() for k in KEYS}, {k: np.asarray(ref[k]) for k in KEYS}


@pytest.fixture(scope="module")
def refs(world_procs):
    """Single-device results of every case, computed while the ranks run."""
    from linemod_tpu_torch.models.template_bank import TemplateBank

    path, _ = world_procs
    inputs = np.load(os.path.join(path, "inputs.npz"))
    cube = TemplateBank.load(os.path.join(path, "cube.npz"))
    cc, cd, sc = inputs["cube_color"], inputs["cube_depth"], inputs["syn_color"]
    mh_colors, mh_depths = _multihost_frames()
    syn = _single(_synthetic_bank(), 8, sc, **SYN)
    return {
        "equal": _single(cube, 16, cc, cd, **CUBE_A),
        "chunk": _single(cube, 16, cc, cd, **CUBE_B),
        "dp_empty": _single(cube, 16, np.zeros_like(cc), np.zeros_like(cd), **CUBE_A),
        "two_round": _single(cube, 16, cc, cd, **CUBE_C),
        "two_round_retry": _single(cube, 40, cc, cd, **CUBE_C),
        "syn": syn,
        "prefilter_retry": _single(_saturated_bank(), 8, sc, **SAT),
        "multihost0": _single(_multihost_bank(), 16, mh_colors[0], mh_depths[0], **MULTIHOST),
        "multihost1": _single(_multihost_bank(), 16, mh_colors[1], mh_depths[1], **MULTIHOST),
    }


@pytest.fixture(scope="module")
def world(world_procs, refs):
    """Every rank's outputs: [rank] -> {name: array}. A rank that failed or
    timed out fails the tests with the tail of its output."""
    path, procs = world_procs
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the {N_RANKS}-rank world did not finish in {WORLD_TIMEOUT_S} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    return [dict(np.load(os.path.join(path, f"rank{r}.npz"))) for r in range(N_RANKS)]


def _ranks(name, world):
    """The ranks that ran case `name` (those of its mesh)."""
    return [r for r in range(N_RANKS) if f"{name}/valid" in world[r]]


def _assert_case(world, name, want, frame=0, n_ranks=None):
    """Case `name`'s frame `frame` on every rank that holds it equals the
    port's single-device result and JAX's, bit for bit."""
    port, jax_ref = want
    ranks = [r for r in _ranks(name, world) if world[r][f"{name}/valid"].shape[0] > frame]
    if n_ranks is not None:
        assert len(ranks) == n_ranks, ranks
    assert ranks
    for r in ranks:
        for k in KEYS:
            got = world[r][f"{name}/{k}"][frame]
            np.testing.assert_array_equal(got, port[k], err_msg=f"{name} rank {r} {k} vs port")
            np.testing.assert_array_equal(got, jax_ref[k], err_msg=f"{name} rank {r} {k} vs JAX")


# ------------------------------------------- tests/test_parallel.py ---

def test_sharded_match_equals_single(world, refs):
    assert refs["equal"][0]["valid"].sum() > 0
    _assert_case(world, "equal", refs["equal"], n_ranks=8)


def test_sharded_chunk_larger_than_shard(world, refs):
    """tp 8 over 16 templates with template_chunk 16: 2-template shards."""
    _assert_case(world, "chunk", refs["chunk"], n_ranks=8)


def test_sharded_batch_dp(world, refs):
    """dp 2 x tp 4: ranks 0-3 hold the object frame, which matches, and
    ranks 4-7 the empty frame, which does not."""
    assert refs["dp_empty"][0]["valid"].sum() == 0
    for r in range(N_RANKS):
        assert world[r]["dp/valid"].shape[0] == 1
        assert (world[r]["dp/valid"][0].sum() > 0) == (r < 4)
        for want in refs["equal" if r < 4 else "dp_empty"]:
            for k in KEYS:
                np.testing.assert_array_equal(world[r][f"dp/{k}"][0], want[k], err_msg=f"rank {r} {k}")


def test_two_round_cut_fast_path_equals_single(world, refs):
    """top_k 512 at tp 8: the local top-256, the merge and its proof."""
    for r in _ranks("two_round", world):
        assert world[r]["two_round/cut_exact"].all()
    _assert_case(world, "two_round", refs["two_round"], n_ranks=8)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_prefilter_cut_equals_single(world, refs, tp):
    """The distributed prefiltered cut (maxes, selection, slice rescan,
    merge) equals the single-device dense path with its proof holding."""
    name = f"prefilter_tp{tp}"
    for r in _ranks(name, world):
        assert world[r][f"{name}/cut_exact"].all()
    _assert_case(world, name, refs["syn"], n_ranks=tp)


def test_sharded_streaming_cut_equals_single(world, refs):
    """tp 4 -> 16-template shards, scan_chunk 8 -> 2 streamed chunks each."""
    _assert_case(world, "streaming", refs["syn"], n_ranks=4)


def test_sharded_prefilter_saturated_retry(world, refs):
    """Tied maxes defeat the prefilter's proof on the fast matcher; every
    rank retries on the exact one and gets the single-device result."""
    for r in _ranks("prefilter_retry", world):
        assert not world[r]["prefilter_retry/fast_cut_exact"].all()
    _assert_case(world, "prefilter_retry", refs["prefilter_retry"], n_ranks=4)


def test_two_round_cut_saturated_retry(world, refs):
    """All matches in shard 0 of the 40-template bank saturate its round-1
    top-m: the proof fails on every rank, and every rank retries."""
    for r in _ranks("two_round_retry", world):
        assert not world[r]["two_round_retry/fast_cut_exact"].all()
    _assert_case(world, "two_round_retry", refs["two_round_retry"], n_ranks=8)


def test_retry_decision_is_collective(world):
    """sharded_detect's decision is one MIN all-reduce over the mesh: a
    single rank's failed proof sends every rank to the exact matcher, and
    in both saturated cases every rank of the mesh retried once."""
    for r in range(N_RANKS):
        assert world[r]["retry/one_rank_fails"] == 1 and world[r]["retry/all_true"]
    for name, n in (("prefilter_retry", 4), ("two_round_retry", 8)):
        assert [int(world[r][f"{name}/retries"]) for r in _ranks(name, world)] == [1] * n


# ------------------------------------------ tests/test_multihost.py ---

def test_two_node_world_from_environment(world, refs):
    """WORLD_SIZE=8 with LOCAL_WORLD_SIZE=4 through initialize_distributed:
    global_detection_mesh() is dp 2 x tp 4, and each dp index's frame
    equals the single-device result on the 320x240 bank."""
    for r in range(N_RANKS):
        dp, tp, i, j = world[r]["mesh/md"]
        assert (dp, tp, i, j) == (2, 4, r // 4, r % 4)
        frame = "multihost0" if r < 4 else "multihost1"
        port, jax_ref = refs[frame]
        for k in KEYS:
            got = world[r][f"multihost/{k}"][0]
            np.testing.assert_array_equal(got, port[k], err_msg=f"rank {r} {k} vs port")
            np.testing.assert_array_equal(got, jax_ref[k], err_msg=f"rank {r} {k} vs JAX")


def test_fixture_frame_tp8_equals_golden(world):
    """The fixture frame, committed bank, tp 8: the K-th value is a 625-fold
    tie above threshold; the packed array equals JAX's."""
    want = np.load(TORCH_REF)["packed"]
    for r in range(N_RANKS):
        np.testing.assert_array_equal(world[r]["fixture/packed"], want, err_msg=f"rank {r}")
        assert world[r]["fixture/cut_exact"].all()


@pytest.mark.parametrize("name, tp, dp", MESHES)
def test_mesh_layouts(world, name, tp, dp):
    """Every mesh lays the first tp*dp ranks out as reshape(dp, tp); each
    rank's groups hold its row, its column and the whole mesh; the other
    ranks have no place in it."""
    grid = np.arange(tp * dp).reshape(dp, tp)
    for r in range(N_RANKS):
        got = world[r][f"mesh/{name}"]
        if r >= tp * dp:
            assert got.tolist() == [dp, tp, -1, -1]
            assert f"mesh/{name}/group" not in world[r]
            continue
        i, j = divmod(r, tp)
        assert got.tolist() == [dp, tp, i, j]
        np.testing.assert_array_equal(world[r][f"mesh/{name}/tp_group"], grid[i])
        np.testing.assert_array_equal(world[r][f"mesh/{name}/dp_group"], grid[:, j])
        np.testing.assert_array_equal(world[r][f"mesh/{name}/group"], grid.ravel())


_BOOT = r"""
import json, os, sys
import torch.distributed as dist
from linemod_tpu_torch.parallel.distributed import global_detection_mesh, initialize_distributed
dev = initialize_distributed(sys.argv[1], 1, 0, device="cpu", timeout_s=60)
again = initialize_distributed(device="cpu")
mesh = global_detection_mesh()
print(json.dumps({"device": str(dev), "again": str(again), "world": dist.get_world_size(),
                  "rank": dist.get_rank(), "backend": dist.get_backend(), "mesh": [mesh.dp, mesh.tp]}))
dist.destroy_process_group()
"""


def test_initialize_distributed_prefers_arguments():
    """Explicit arguments win over a torchrun environment that names another
    world (8 ranks, rank 5, a coordinator nobody serves); a second call is
    a no-op; the default mesh of a one-rank world is 1 x 1."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT="1", WORLD_SIZE="8", RANK="5",
               LOCAL_WORLD_SIZE="3", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _BOOT, f"127.0.0.1:{_free_port()}"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"device": "cpu", "again": "cpu", "world": 1, "rank": 0, "backend": "gloo", "mesh": [1, 1]}


def _fake_mesh(tp, index=0):
    """A mesh row of tp ranks as this rank would see it (no process group:
    the checks below raise before any collective)."""
    from linemod_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, tp, 0 if index >= 0 else -1, index, None, None, None)


def test_sharded_layer_rejects_bad_input():
    """top_k not a multiple of tp, a bank that does not split over tp, a
    rank outside the mesh, and a frame whose planes do not fit the state's
    geometry all raise ValueError."""
    from linemod_tpu_torch.models.template_bank import _pad_bank
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state
    from linemod_tpu_torch.parallel.sharded_match import _gathered_planes_band, make_sharded_matcher, shard_state

    state = build_match_state(_pad_bank(_synthetic_bank(), 8), MatchConfig(**SYN), "cpu")
    with pytest.raises(ValueError, match="multiple of tp"):
        make_sharded_matcher(state, _fake_mesh(3))
    with pytest.raises(ValueError, match="do not split over tp"):
        shard_state(state, _fake_mesh(3))
    with pytest.raises(ValueError, match="outside the mesh"):
        shard_state(state, _fake_mesh(2, index=-1))
    with pytest.raises(ValueError, match="outside the mesh"):
        make_sharded_matcher(state, _fake_mesh(2, index=-1))
    wide = torch.zeros((240, 1280, 3))  # a coarse level twice the state's width
    with pytest.raises(ValueError, match="state's geometry"):
        _gathered_planes_band([(wide, quantize_color_gradients)], 8, state.max_cells_coarse, _fake_mesh(2),
                              state.coarse_shape)


# ------------------------------------------------- ops/spread.py bands ---

BAND_SHAPES = [(2, 49), (8, 7), (5, 21)]


@pytest.fixture(scope="module")
def band_images():
    rng = np.random.default_rng(3)
    color = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    depth = rng.uniform(500, 700, (120, 160)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    return {"color": color, "depth": depth}


def _quantizers(modality):
    from linemod_tpu.ops.gradients import quantize_color_gradients as jax_color
    from linemod_tpu.ops.normals import quantize_normals as jax_normals
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.normals import quantize_normals

    return (quantize_color_gradients, jax_color) if modality == "color" else (quantize_normals, jax_normals)


@pytest.mark.parametrize("modality", ["color", "depth"])
@pytest.mark.parametrize("n_bands", [2, 4, 8])
@pytest.mark.parametrize("t, max_cells", BAND_SHAPES)
def test_band_planes_from_image_equals_jax(band_images, modality, n_bands, t, max_cells):
    """Every band, quantized from the clamped image slice, equals JAX's, and
    the bands reassemble into the port's full planes of the whole image."""
    import jax.numpy as jnp

    from linemod_tpu.ops.spread import band_planes_from_image as jax_band
    from linemod_tpu_torch.ops.spread import band_planes_from_image, linearized_response_planes

    img = band_images[modality]
    port_q, jax_q = _quantizers(modality)
    bands = []
    for b in range(n_bands):
        got = band_planes_from_image(torch.from_numpy(img), t, max_cells, b, n_bands, port_q).numpy()
        want = np.asarray(jax_band(jnp.asarray(img), t, max_cells, b, n_bands, jax_q))
        np.testing.assert_array_equal(got, want, err_msg=f"band {b}")
        bands.append(got)
    h, w = img.shape[0] - img.shape[0] % t, img.shape[1] - img.shape[1] % t
    full = linearized_response_planes(port_q(torch.from_numpy(img))[0][:h, :w], t, max_cells).numpy()
    np.testing.assert_array_equal(np.concatenate(bands, axis=3), full)


@pytest.mark.parametrize("n_bands", [2, 4, 8])
@pytest.mark.parametrize("t, max_cells", BAND_SHAPES)
def test_linearized_response_planes_band_equals_jax(band_images, n_bands, t, max_cells):
    """Bands of a quantized map (cropped inside) equal JAX's and reassemble
    into the full planes, as tests/test_parallel.py:74-100 checks for JAX."""
    import jax.numpy as jnp

    from linemod_tpu.ops.spread import linearized_response_planes_band as jax_band
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.spread import linearized_response_planes, linearized_response_planes_band

    quant = quantize_color_gradients(torch.from_numpy(band_images["color"]))[0]
    bands = []
    for b in range(n_bands):
        got = linearized_response_planes_band(quant, t, max_cells, b, n_bands).numpy()
        want = np.asarray(jax_band(jnp.asarray(quant.numpy()), t, max_cells, b, n_bands))
        np.testing.assert_array_equal(got, want, err_msg=f"band {b}")
        bands.append(got)
    h, w = quant.shape[0] - quant.shape[0] % t, quant.shape[1] - quant.shape[1] % t
    full = linearized_response_planes(quant[:h, :w], t, max_cells).numpy()
    np.testing.assert_array_equal(np.concatenate(bands, axis=3), full)


def test_band_rows_must_divide():
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.spread import band_planes_from_image, linearized_response_planes_band

    quant = torch.zeros((120, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not divisible"):
        linearized_response_planes_band(quant, 8, 7, 0, 3)  # 40 rows
    with pytest.raises(ValueError, match="not divisible"):
        band_planes_from_image(torch.zeros((120, 160, 3)), 8, 7, 0, 3, quantize_color_gradients)


def test_linearize_equals_jax():
    import jax.numpy as jnp

    from linemod_tpu.ops.spread import linearize as jax_linearize
    from linemod_tpu_torch.ops.spread import linearize

    resp = np.random.default_rng(4).integers(0, 5, (8, 48, 64), dtype=np.uint8)
    for t, mc in BAND_SHAPES[:2]:
        np.testing.assert_array_equal(
            linearize(torch.from_numpy(resp), t, mc).numpy(), np.asarray(jax_linearize(jnp.asarray(resp), t, mc))
        )


if __name__ == "__main__":
    _rank_main(sys.argv[1])
