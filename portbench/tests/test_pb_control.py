"""The control: the plain reference computed in bfloat16, the precision
below the configuration's float32, put in the program's place, must come
out not correct. On the CPU at a small size here; at the cell's own size
on the card (`cuda`, through `python3 -m portbench.control`)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import control, harness, inputs
from portbench.tests.test_pb_faults import MODALITIES, run_small, small_cell


def _cell(name):
    manifest = inputs.load_json(inputs.repo_path("BENCHMARK.json"))
    return harness.load_cell(manifest, next(c for c in manifest["workloads"] if c["name"] == name))


@pytest.mark.parametrize("modality", MODALITIES)
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_control_fails_at_a_small_size(seed, modality):
    config, mix = small_cell(modality)
    dev = torch.device("cpu")
    out = run_small(modality, seconds=1.0, seed=seed)
    bank, pool, checked = out["inputs"]
    low = control.control_numbers(config, mix, bank, pool, out["run"].window, out["ref"], checked, dev)
    assert out["numbers"]["rows_off"] == 0 and low["compared"] == out["numbers"]["compared"]
    assert low["rows_off"] > harness.LIMITS["rows_off"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["shipped-96k.stream", "pruned-2k.stream"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size runs on the card")
    seeds = ["2147490001", "2147490002", "2147490003"]
    proc = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", cell, "--seconds", "3",
                           "--seeds", *seeds, "--control-seeds", *seeds], cwd=inputs.REPO,
                          capture_output=True, text=True, timeout=900, check=True)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert line["program"]["rows_off"] == 0 and line["control"]["rows_off"] > 0
