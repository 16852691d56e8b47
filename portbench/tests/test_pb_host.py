"""The run's process settings, in place before the measured window: the
thread pools fixed at one thread before numpy and torch are imported
(`run.fix_thread_pools`)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import inputs, run


def test_run_fixes_the_thread_pools_before_imports():
    """`python3 -m portbench.run` in a fresh process: the pools are fixed
    before numpy and torch are imported, so torch starts with one intra-op
    thread. No card here, so the run stops (exit 3) once torch is
    imported."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would go on past its settings")
    code = (
        "import json, os, sys\n"
        "from portbench import run\n"
        "fix = run.fix_thread_pools\n"
        "seen = []\n"
        "run.fix_thread_pools = lambda: seen.append(fix()) or seen[-1]\n"
        "rc = run.main(['--workload', 'pruned-2k.stream', '--seed', '1', '--seconds', '1'])\n"
        "import torch\n"
        "print(json.dumps({'rc': rc, 'seen': seen, 'threads': torch.get_num_threads(),\n"
        "                  'env': [os.environ.get(k) for k in run.THREAD_ENV]}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=inputs.REPO, capture_output=True, text=True,
                          timeout=300)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 3 and out["seen"] == [True]
    assert out["threads"] == run.THREADS == 1 and out["env"] == ["1"] * len(run.THREAD_ENV)
    assert "host: thread pools at 1, set before numpy and torch: True" in proc.stderr


def test_fix_thread_pools_says_when_it_comes_late(monkeypatch):
    for k in run.THREAD_ENV:
        monkeypatch.setenv(k, "8")
    assert run.fix_thread_pools() is False  # numpy and torch are loaded in this process
    assert all(os.environ[k] == "1" for k in run.THREAD_ENV)
