"""The PyTorch port must run where JAX, OpenCV, PyYAML, PIL and the JAX
package are not installed: importing every module of `linemod_tpu_torch`
(in a fresh interpreter, with imports of those five blocked) must neither
need nor load them, and no source of the port or of chip_smoke.py (whose
phase-11 rank runs in its own interpreter) may import them. A name is blocked by its first dotted component, so
`linemod_tpu_torch` itself is not."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "cv2", "yaml", "PIL", "linemod_tpu")
preloaded = {m for m in BLOCKED if m in sys.modules}


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import linemod_tpu_torch

names = [m.name for m in pkgutil.walk_packages(linemod_tpu_torch.__path__, "linemod_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its phase-11 ranks run `chip_smoke.py --sharded-rank` in fresh interpreters
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and m.split(".")[0] not in preloaded)
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def test_port_imports_without_jax_cv2_yaml():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout)
    assert len(result["modules"]) >= 15, result["modules"]
    generation = {"linemod_tpu_torch." + m for m in (
        "models.template_bank", "models.viewpoints", "ops.extract", "pipeline.template_generator",
        "utils.mesh_io")}
    assert generation <= set(result["modules"]), generation - set(result["modules"])
    tooling = {"linemod_tpu_torch." + m for m in (
        "cli", "tools.accuracy_eval", "pipeline.synth_eval", "pipeline.sensors", "ops.registration", "utils.io",
        "utils.draw", "utils.profiling", "utils.refformat", "utils.yamlcv")}
    assert tooling <= set(result["modules"]), tooling - set(result["modules"])
    sharding = {"linemod_tpu_torch.parallel." + m for m in ("mesh", "distributed", "sharded_match")}
    assert sharding <= set(result["modules"]), sharding - set(result["modules"])
    ingest = {"linemod_tpu_torch." + m for m in ("utils.native", "utils.hostlib", "ops.detect_core")}
    assert ingest <= set(result["modules"]), ingest - set(result["modules"])
    capture = {"linemod_tpu_torch." + m for m in (
        "ops.aruco", "pipeline.aruco_capture", "utils.jpeg", "utils.pnp", "utils.yamlcv")}
    assert capture <= set(result["modules"]), capture - set(result["modules"])
    readers = {"linemod_tpu_torch.utils." + m for m in ("tiff", "bmp", "pnm", "imconvert", "png")}
    assert readers <= set(result["modules"]), readers - set(result["modules"])
    measurement = {"linemod_tpu_torch.tools." + m for m in (
        "bench", "fixture", "timing", "profile_stages", "profile_detect", "profile_icp", "profile_multimodel",
        "bigbank_bench")}
    assert measurement <= set(result["modules"]), measurement - set(result["modules"])
    assert result["loaded"] == []


_SOURCE_BLOCKED = ("jax", "jaxlib", "cv2", "yaml", "PIL", "linemod_tpu")


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "linemod_tpu_torch")):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def _blocked_imports(path):
    """(line, module) of each import statement in `path` whose module's first
    dotted name is blocked. Relative imports (`from . import`) are the port's
    own."""
    hits = []
    with open(path) as fh:
        for line in fh:
            words = line.replace(",", " ").split()
            if words[:1] == ["from"] and len(words) > 1:
                names = [words[1]]
            elif words[:1] == ["import"]:
                names = [w for w in words[1:] if w != "as"]
            else:
                continue
            hits += [(line, n) for n in names if n.split(".")[0] in _SOURCE_BLOCKED]
    return hits


def test_port_sources_never_import_jax():
    sources = list(_port_sources())
    assert len(sources) >= 20 and os.path.exists(sources[-1])
    # the scan of chip_smoke.py covers its phase-11 rank, which imports the
    # sharding modules in its own interpreter
    with open(sources[-1]) as fh:
        assert "\ndef sharded_rank(" in fh.read()
    assert {"mesh.py", "distributed.py", "sharded_match.py"} <= {
        os.path.basename(p) for p in sources if os.path.basename(os.path.dirname(p)) == "parallel"}
    for path in sources:
        assert _blocked_imports(path) == [], path


def test_blocked_import_scan_matches_whole_names(tmp_path):
    """The scan blocks `linemod_tpu` and its submodules, and only them."""
    src = tmp_path / "probe.py"
    src.write_text(
        "import linemod_tpu_torch.ops\nfrom linemod_tpu_torch import config\n"
        "from . import cuda_lib\nimport numpy as np, linemod_tpu.types\n"
        "from linemod_tpu.ops import postprocess\n    import jax.numpy as jnp\n"
    )
    assert [n for _, n in _blocked_imports(src)] == ["linemod_tpu.types", "linemod_tpu.ops", "jax.numpy"]
