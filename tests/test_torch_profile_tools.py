"""The port's measurement tools (`linemod_tpu_torch/tools/profile_*.py`,
`bigbank_bench.py`) on the CPU against the JAX package.

- `profile_stages`: its stage functions, composed on a small synthetic bank
  (32 templates, 160x120, top 64) and random frames, give `detect_frame`'s
  packed array bit for bit; its cut and fine-refine stages equal JAX's
  `candidate_cut` (the blocked cut) and `fine_refine` (the gather path) on
  the same numpy inputs; every stage runs on that state.
- `bigbank_bench`: the templates it plans for subdivisions 0-3 (1,800 to
  96,300) equal JAX's viewpoints x radii x in-plane angles with symmetry
  pruning off; its device byte count equals the state's tensors' nbytes;
  `--dual`, its cache name and config, and a dual bank's prefiltered frame
  against JAX's; the rows of bank_scale.json kept a (subdiv, dual).
- `profile_multimodel`: detections a class with two copies of a 256-row cut
  of the fixture bank equal JAX's `MultiModelPoseDetection.detect_all` on
  the fixture frame.
- Every tool's default `--device cuda` without a card stops naming
  `--device cpu`.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
TOOLS = ("profile_stages", "profile_detect", "profile_icp", "profile_multimodel", "bigbank_bench")


def _jax_state_parts(state):
    from linemod_tpu_torch.ops.matching import META_FIELDS, TENSOR_FIELDS

    arrays = {k: np.asarray(getattr(state, k)) for k in TENSOR_FIELDS}
    meta = {k: getattr(state, k) for k in META_FIELDS}
    meta["cfg"] = dataclasses.asdict(state.cfg)
    return arrays, meta


@pytest.fixture(scope="module")
def small_states():
    """One 32-template synthetic bank as JAX and port match states at
    160x120 with the production blocked cut on the JAX side
    (tests/test_torch_matching.py's)."""
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu_torch.ops.matching import match_state_from_numpy

    kw = dict(width=160, height=120, top_k=64, threshold=33.0, template_chunk=32)
    jstate = jax_build(jax_synthetic(32, seed=4, bbox_wh=48), JaxConfig(cut_block_rows=256, **kw))
    return jstate, match_state_from_numpy(*_jax_state_parts(jstate), "cpu")


def _frame(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (120, 160, 3)).astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stages_compose_into_detect_frame(small_states, seed):
    from linemod_tpu_torch.ops.detect_core import detect_frame
    from linemod_tpu_torch.tools.profile_stages import run_stages

    _, state = small_states
    color = _frame(seed)
    x = run_stages(state, color.float())
    want = detect_frame(state, color)
    assert 0 < want[:, 4].sum() < 64
    assert x["packed"].dtype == want.dtype and torch.equal(x["packed"], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cut_and_fine_stages_equal_jax(small_states, seed):
    from linemod_tpu.ops.matching import candidate_cut as jax_cut
    from linemod_tpu.ops.matching import fine_refine as jax_fine_refine
    from linemod_tpu_torch.tools.profile_stages import run_stages

    jstate, state = small_states
    x = run_stages(state, _frame(seed).float())
    want_cut = jax_cut(jstate.cfg, jnp.asarray(x["sim_c"].numpy()), state.coarse_shape[1], state.cfg.top_k)
    for got, want in zip(x["cut"], want_cut):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_fine = jax_fine_refine(jstate, jnp.asarray(x["fine_planes"].numpy()),
                                *(jnp.asarray(a.numpy()) for a in x["cut"][1:]))
    for got, want in zip(x["refined"], want_fine):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_stage_runs_and_the_full_rows_equal_the_composition(small_states):
    from linemod_tpu_torch.ops.matching import match_templates
    from linemod_tpu_torch.tools.profile_stages import STAGES, launches_a_call, run_stages

    _, state = small_states
    colorf = _frame(3).float()
    x = run_stages(state, colorf)
    outs = {name: fn(state, colorf, x) for name, _, _, fn in STAGES}
    assert len(outs) == len(STAGES) == 16
    full, given = outs["full match"], outs["match given planes"]
    want = match_templates(state, colorf)
    for key in want:
        assert torch.equal(full[key], want[key]) and torch.equal(given[key], want[key]), key
    fine, coarse = outs["planes, both levels"]
    assert torch.equal(fine, x["fine_planes"]) and torch.equal(coarse, x["coarse_planes"])
    # CPU tensors run the kernels' plain versions: no launch is counted
    assert launches_a_call(lambda: match_templates(state, colorf)) == dict.fromkeys(
        ("coarse_scores", "fine_scores", "coarse_max"), 0)


@pytest.mark.parametrize("subdiv,templates", [(0, 1800), (1, 6300), (2, 24300), (3, 96300)])
def test_bigbank_planned_templates_equal_jax(subdiv, templates):
    from linemod_tpu.config import load_settings as jax_settings
    from linemod_tpu.models.viewpoints import camera_view_points as jax_views
    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.tools.bigbank_bench import UNPRUNED, planned_templates

    path = os.path.join(EXAMPLE, "linemod_settings.yml")
    settings = dataclasses.replace(load_settings(path)[1], subdivisions=subdiv)
    jset = dataclasses.replace(jax_settings(path)[1], subdivisions=subdiv)
    want = sum(len(jax_views(float(r), subdiv, False, (0.0, 0.0, 0.0))) for r in jset.radii) * len(
        jset.in_plane_angles)
    assert not UNPRUNED.rotationally_symmetrical and UNPRUNED.planes_of_symmetry == (0.0, 0.0, 0.0)
    assert planned_templates(settings) == want == templates


def test_bigbank_state_bytes_are_its_tensors_nbytes():
    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops.matching import TENSOR_FIELDS
    from linemod_tpu_torch.tools.bigbank_bench import PREFILTER_SEL, SCAN_CHUNK, bigbank_state, state_device_bytes

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    state = bigbank_state(cam, make_synthetic_bank(100, seed=2, bbox_wh=64), "cpu")
    assert state.n_templates == SCAN_CHUNK and state.cfg.prefilter_sel == PREFILTER_SEL
    tensors = [getattr(state, k) for k in TENSOR_FIELDS] + [state.coarse_plan.feat, state.coarse_plan.starts]
    assert state.coarse_plan.off3 is state.off3_coarse
    assert state_device_bytes(state) == sum(t.numel() * t.element_size() for t in tensors)


def test_bigbank_dual_flag_and_cache_name():
    from linemod_tpu_torch.tools.bigbank_bench import cache_path, parse_args

    assert parse_args(["--dual"]).dual and not parse_args([]).dual
    assert parse_args(["--subdivs", "0", "--dual"]).subdivs == [0]
    assert cache_path("out", 2, True) == os.path.join("out", "bigbank_dual_s2.npz")
    assert cache_path("out", 3, False) == os.path.join("out", "bigbank_s3.npz")


def test_bigbank_match_config_of_a_dual_bank():
    """The JAX script's config for a dual bank: t_fine 5, the dual layout,
    the prefiltered cut over 1,024 of 4,096-template chunks."""
    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.tools.bigbank_bench import PREFILTER_SEL, SCAN_CHUNK, TOP_K, match_config

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    for dual, t_fine in ((True, 5), (False, 2)):
        cfg = match_config(cam, make_synthetic_bank(10, seed=1, dual_modality=dual))
        assert (cfg.dual_modality, cfg.t_fine, cfg.t_coarse) == (dual, t_fine, 8)
        assert (cfg.top_k, cfg.scan_chunk, cfg.prefilter_sel, cfg.template_chunk) == (TOP_K, SCAN_CHUNK,
                                                                                      PREFILTER_SEL, 256)
        assert (cfg.width, cfg.height) == (cam.width, cam.height)


@pytest.mark.parametrize("threshold", [None, 30.0], ids=["config", "threshold30"])
def test_bigbank_dual_frame_equals_jax(threshold):
    """A dual bank's bigbank_state (100 synthetic templates padded to 4,096)
    on the seed-0 random frame with a zero depth takes the prefiltered cut,
    and its packed array equals JAX's detect_frame_dual under the same
    MatchConfig on the CPU (the gather path): integers exact, similarities
    within 1e-4. A zero depth gives no normal responses, so at the config's
    threshold of 80% no row is valid; at 30% every row is (the color half
    scores up to ~37%)."""
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.ops.detect_core import detect_frame_dual as jax_detect_dual
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu.pipeline.pose_detection import _pad_bank as jax_pad
    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.models.template_bank import _pad_bank, make_synthetic_bank
    from linemod_tpu_torch.ops.detect_core import detect_frame
    from linemod_tpu_torch.ops.matching import build_match_state
    from linemod_tpu_torch.tools.bigbank_bench import SCAN_CHUNK, TOP_K, bigbank_state, frame_inputs, match_config

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = make_synthetic_bank(100, seed=2, bbox_wh=64, dual_modality=True)
    if threshold is None:
        state = bigbank_state(cam, bank, "cpu")
    else:
        cfg = dataclasses.replace(match_config(cam, bank), threshold=threshold)
        state = build_match_state(_pad_bank(bank, SCAN_CHUNK), cfg, "cpu")
    assert state.cfg.dual_modality and state.off3_coarse.shape[1] == 128 and state.n_templates == SCAN_CHUNK
    color, depth = frame_inputs(cam, bank, "cpu")
    assert color.dtype == torch.uint8 and depth.dtype == torch.float32 and not depth.any()
    got = detect_frame(state, color, depth).numpy()
    assert got.shape == (TOP_K + 1, 5) and got[-1, 0] == 1.0

    jcfg = JaxConfig(**dataclasses.asdict(state.cfg))
    jstate = jax_build(jax_pad(jax_synthetic(100, seed=2, bbox_wh=64, dual_modality=True), SCAN_CHUNK), jcfg)
    assert not jcfg.use_pallas
    want = np.asarray(jax_detect_dual(jstate, jnp.asarray(color.numpy()), jnp.asarray(depth.numpy())))
    assert want.shape == got.shape
    np.testing.assert_array_equal(got[:, [0, 1, 2, 4]], want[:, [0, 1, 2, 4]])
    assert np.abs(got[:, 3] - want[:, 3]).max() <= 1e-4
    valid = int(got[:-1, 4].sum())
    assert valid == 0 if threshold is None else valid > 0


def test_bank_scale_rows_kept_a_subdiv_and_modality():
    """bank_scale.json keeps one row a (subdiv, dual), sorted color first
    then by subdiv, as JAX's script keeps BANK_SCALE.json; a cached bank's
    row keeps the generation numbers of the row it replaces."""
    from linemod_tpu_torch.tools.bigbank_bench import merge_rows

    def row(subdiv, dual, gen=None, peak=None):
        return {"subdiv": subdiv, "dual_modality": dual, "generation_seconds": gen,
                "templates_per_second": None if gen is None else 100 / gen,
                "generation_phase_seconds": None if gen is None else {"scan": gen / 100},
                "generation_peak_bytes": peak}

    rows = merge_rows([], row(2, True, 5.0, 7))
    rows = merge_rows(rows, row(3, False, 9.0, 8))
    rows = merge_rows(rows, row(2, False, 4.0, 6))
    assert [(r["subdiv"], r["dual_modality"]) for r in rows] == [(2, False), (3, False), (2, True)]
    rows = merge_rows(rows, row(2, True))  # loaded from its cache
    assert rows[-1] == row(2, True, 5.0, 7) and len(rows) == 3
    rows = merge_rows(rows, row(2, False, 3.0, 5))  # generated anew
    assert rows[0] == row(2, False, 3.0, 5) and len(rows) == 3


def test_profiler_sessions_tells_each_call_by_its_kernel_name():
    """tools.profiler_sessions tells the fixed call's 20 records apart by
    their ATen kernels' names (rsqrt's holds sqrt's, abs's is a functor),
    and a record of no op (a guard's sleep kernel) by None."""
    from linemod_tpu_torch.tools import profiler_sessions as ps

    assert len(set(ps.OPS)) == 20 and ps.SESSIONS % (2 * len(ps.KINDS)) == 0
    for i, op in enumerate(ps.OPS):
        name = ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>>" if op == "abs"
                else f"void at::native::vectorized_elementwise_kernel<4, at::native::{op}_kernel_cuda(at::Tensor"
                     f"IteratorBase&)::{{lambda()#1}}>")
        assert ps.op_of(name) == i, op
    assert ps.op_of("spin_kernel(long)") is None


def test_bank_scale_written_after_each_subdiv(tmp_path, monkeypatch):
    """A run cut in a later subdiv has already written the rows of the
    subdivs it finished to bank_scale.json."""
    from linemod_tpu_torch.tools import bigbank_bench

    def run_subdiv(subdiv, device, out, dual):
        if subdiv == 3:
            raise KeyboardInterrupt  # the run cut during subdiv 3
        return {"subdiv": subdiv, "dual_modality": dual, "generation_seconds": 1.0}

    monkeypatch.setattr(bigbank_bench, "run_subdiv", run_subdiv)
    args = bigbank_bench.parse_args(["--subdivs", "2", "3", "--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(KeyboardInterrupt):
        bigbank_bench.run(args)
    with open(tmp_path / "bank_scale.json") as f:
        kept = json.load(f)
    assert kept["configs"] == [{"subdiv": 2, "dual_modality": False, "generation_seconds": 1.0}]


def _rows(bank, rows):
    """The bank cut to `rows` (either package's TemplateBank)."""
    return dataclasses.replace(bank, **{
        f.name: getattr(bank, f.name)[rows] for f in dataclasses.fields(bank)
        if isinstance(getattr(bank, f.name), np.ndarray)})


def test_multimodel_counts_equal_jax_detect_all():
    from linemod_tpu.config import load_model_properties as jax_props
    from linemod_tpu.config import load_settings as jax_settings
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.pipeline.multi_model import MultiModelPoseDetection as JaxMulti
    from linemod_tpu_torch.tools.fixture import COLOR_BANK, MODEL, load_fixture
    from linemod_tpu_torch.tools.profile_multimodel import class_copies, multi_detector, poses_per_class

    rows = slice(128, 384)  # holds the fixture frame's best templates (185-335)
    fx = load_fixture()
    det = multi_detector(_rows(fx.bank, rows), 2, fx.cam, fx.settings, fx.props, "cpu")
    got = poses_per_class(det, fx.color, fx.depth)
    jbanks = class_copies(_rows(JaxBank.load(COLOR_BANK), rows), 2)
    jcam, jset = jax_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    jdet = JaxMulti(jbanks, jcam, jset, dict.fromkeys(jbanks, jax_props(MODEL)))
    want = {c: len(p) for c, p in jdet.detect_all(fx.color, fx.depth).items()}
    assert list(got) == list(want) == ["lagergehaeuse.ply", "lagergehaeuse.ply_1"]
    assert got == want and sum(got.values()) > 0


@pytest.mark.parametrize("tool", TOOLS)
def test_default_device_without_a_card_names_the_cpu_flag(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    proc = subprocess.run([sys.executable, "-m", f"linemod_tpu_torch.tools.{tool}"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cpu" in proc.stderr
