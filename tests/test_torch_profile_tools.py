"""The port's measurement tools (`linemod_tpu_torch/tools/profile_*.py`,
`bigbank_bench.py`) on the CPU against the JAX package.

- `profile_stages`: its stage functions, composed on a small synthetic bank
  (32 templates, 160x120, top 64) and random frames, give `detect_frame`'s
  packed array bit for bit; its cut and fine-refine stages equal JAX's
  `candidate_cut` (the blocked cut) and `fine_refine` (the gather path) on
  the same numpy inputs; every stage runs on that state.
- `bigbank_bench`: the templates it plans for subdivisions 0-3 (1,800 to
  96,300) equal JAX's viewpoints x radii x in-plane angles with symmetry
  pruning off; its device byte count equals the state's tensors' nbytes.
- `profile_multimodel`: detections a class with two copies of a 256-row cut
  of the fixture bank equal JAX's `MultiModelPoseDetection.detect_all` on
  the fixture frame.
- Every tool's default `--device cuda` without a card stops naming
  `--device cpu`.
"""

import dataclasses
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
