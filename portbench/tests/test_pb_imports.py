"""Nothing the harness runs imports JAX or the JAX package, and the plain
reference imports nothing of the program either; top-level module names
are compared whole (`linemod_tpu_torch` begins with `linemod_tpu`)."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import inputs, run

JAX = {"jax", "jaxlib", "flax", "linemod_tpu"}
PORT = "linemod_tpu_torch"


def _sources(sub=""):
    top = os.path.join(inputs.ROOT, sub)
    for dirpath, _, files in os.walk(top):
        if os.sep + "tests" in dirpath[len(inputs.ROOT):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, inputs.ROOT))
def test_harness_imports_no_jax(path):
    assert not _imported_tops(path) & JAX


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_no_program(path):
    assert not _imported_tops(path) & (JAX | {PORT})
    assert not _imported_tops(path) - {"numpy", "torch", "__future__", "dataclasses"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.match, portbench.reference.post; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=inputs.REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert PORT not in out and not set(out) & JAX


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "linemod_tpu_torch_fake", sys)
    assert "linemod_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "linemod_tpu.fake", sys)
    assert run.forbidden_modules() == ["linemod_tpu"]


def test_run_without_a_card_exits_without_a_result():
    """No CUDA card here: exit 3, nothing on stdout."""
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "pruned-2k.stream", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=inputs.REPO, capture_output=True, text=True,
                          timeout=120)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert proc.returncode == 3 and proc.stdout == ""
