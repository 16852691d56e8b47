"""The port's one-line bench (`linemod_tpu_torch/tools/bench.py`) on the CPU.

One bench run at one frame a stream (`--frames 1 --repeats 1 --warm 0`,
`--device cpu`), as a user runs it, in a process of its own: its last line
carries every key of `bench.py`'s result (read from bench.py's source with
`ast`, so a rename there shows here) and `device`; its gate's VSD and ADD
are within 1e-3 of the JAX package's `Benchmark` scores of JAX's golden pose
(`tests/goldens/img0_torch_ref.npz`, the pose both packages detect); the
root files bench.py and the JAX scripts write hash the same before and
after it, and it leaves nothing in its `--out` but its CPU baseline.
A variant made to raise ends the run non-zero with no result line; the
default `--device cuda` without a card stops naming `--device cpu`.
"""

import ast
import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
SMALL = ["--device", "cpu", "--frames", "1", "--repeats", "1", "--warm", "0"]
SCORE_ATOL = 1e-3
# files at the root of the repo that the JAX package's bench and scripts write
ROOT_PATTERNS = ("baseline_cpu.json", "BENCH_r*.json", "BANK_SCALE.json", "MULTIMODEL_PERF.json")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=REPO)


def _run(argv, timeout=600):
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def _root_digests() -> dict:
    paths = sorted(p for pat in ROOT_PATTERNS for p in glob.glob(os.path.join(REPO, pat)))
    digests = {}
    for p in paths:
        with open(p, "rb") as f:
            digests[os.path.basename(p)] = hashlib.sha256(f.read()).hexdigest()
    return digests


def reference_keys() -> set:
    """The keys of bench.py's result dict: its `result = {...}` literal and
    every `result["..."] = ...` assignment."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == "result" and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                  and target.value.id == "result"):
                keys.add(target.slice.value)
    return keys


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """(process, root digests before, after, --out) of one small CPU run."""
    out = tmp_path_factory.mktemp("bench_out")
    before = _root_digests()
    proc = _run(["-m", "linemod_tpu_torch.tools.bench", *SMALL, "--out", str(out)])
    return proc, before, _root_digests(), out


def _lines(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2])["detail"], json.loads(lines[-1])


def test_reference_keys_are_read_from_bench_py():
    keys = reference_keys()
    assert len(keys) == 10 and {"metric", "value", "vs_baseline", "device_fps", "dual_device_fps"} <= keys


def test_line_has_every_key_of_bench_py(bench_run):
    from linemod_tpu_torch.tools.bench import RESULT_KEYS

    detail, result = _lines(bench_run[0])
    assert set(result) == reference_keys() | {"device"} == set(RESULT_KEYS)
    assert result["device"] == "cpu" and result["unit"] == "frames/s"
    assert result["metric"] == "detector_fps_per_chip"
    # no device time on the CPU: the device rates are not measured there
    assert result["device_fps"] is None and result["dual_device_fps"] is None and detail["device_ms"] is None
    for key in set(RESULT_KEYS) - {"device_fps", "dual_device_fps"}:
        assert result[key] is not None, key
    assert min(result[k] for k in ("value", "vs_baseline", "disk_to_pose_fps", "host_post_ms", "icp_fps",
                                   "dual_fps")) > 0
    assert detail["headline"]["samples"] == 1 and detail["frames"] == 1
    assert detail["headline"]["fps_q1"] <= detail["headline"]["fps_median"] <= detail["headline"]["fps_q3"]
    assert set(detail["launches_a_frame"]) == {"coarse_scores", "fine_scores", "coarse_max"}


def test_gate_scores_equal_jax_benchmark(bench_run):
    """The bench's VSD and ADD of its pose against JAX's Benchmark scores of
    JAX's golden pose for the same frame."""
    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.pipeline.benchmark import Benchmark, read_ground_truth_pose
    from linemod_tpu.pipeline.pose_detection import PoseDetection
    from linemod_tpu.types import ObjectPose
    from linemod_tpu.utils.ply import load_ply
    from linemod_tpu_torch.utils.png import read_png

    detail, _ = _lines(bench_run[0])
    gate = detail["gate"]
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    det = PoseDetection(TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")), cam, settings,
                        load_model_properties(model))
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
    golden = np.load(os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz"))
    pose = ObjectPose(translation=golden["translation"], quaternion=golden["quaternion"])
    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    bench = Benchmark(load_ply(model), cam)
    vsd, add = float(bench.score_vsd(scene, gt, pose)), float(bench.score_add(gt, pose))
    assert gate["poses"] == 1 and gate["ok"]
    assert abs(gate["vsd"] - vsd) <= SCORE_ATOL and vsd < 0.3
    assert abs(gate["add"] - add) <= SCORE_ATOL and add <= 21.0


def test_root_files_unchanged_and_out_holds_the_baseline(bench_run):
    _, before, after, out = bench_run
    assert "baseline_cpu.json" in before and any(k.startswith("BENCH_r") for k in before)
    assert after == before
    assert os.listdir(out) == ["baseline_cpu.json"]
    with open(os.path.join(out, "baseline_cpu.json")) as f:
        cached = json.load(f)
    assert cached["key"]["frames"] == 1 and cached["cpu_fps"] > 0


def test_a_raising_variant_fails_the_run(tmp_path):
    """bench.py passes over a variant that raises (bench.py:127-128 for
    disk-to-pose); the port's bench ends with the error, a non-zero exit
    and no result line."""
    script = (
        "import sys\n"
        "from linemod_tpu_torch.tools import bench\n"
        "def boom(*args, **kwargs):\n"
        "    raise RuntimeError('the PNG sequence is unreadable')\n"
        "bench._frame_source = boom\n"
        "sys.exit(bench.main(sys.argv[1:]))\n"
    )
    proc = _run(["-c", script, *SMALL, "--out", str(tmp_path)])
    assert proc.returncode != 0
    assert "the PNG sequence is unreadable" in proc.stderr
    assert '"metric"' not in proc.stdout


def test_default_device_without_a_card_names_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    proc = _run(["-m", "linemod_tpu_torch.tools.bench"], timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cpu" in proc.stderr


def test_a_missing_committed_bank_raises(tmp_path):
    from linemod_tpu_torch.tools.fixture import load_bank

    with pytest.raises(FileNotFoundError, match="never generate"):
        load_bank(str(tmp_path / "lagergehaeuse.npz"))
