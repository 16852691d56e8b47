"""The port's reference bank pair (`linemod_tpu_torch/utils/refformat.py`:
`linemod_templates.yml.gz` + `linemod_tempPosFile.bin`) and its YAML reader
(`utils/cvyaml.parse_yaml`) against the JAX package on the CPU.

The cases of `tests/test_refformat.py` through the port, the export equal
to JAX's text and bytes, and banks converted both ways between the two
packages (the quaternion is stored x, y, z, w in both). PyYAML reads the
fixture bank's 8 MB text in ~50 s, so JAX imports only slices of the
fixture banks; the port reads the whole text in a few seconds.

`tests/goldens/refpair_ref.npz` is JAX's export of the committed color bank
(the decompressed YAML text and the .bin bytes; gzip stamps an mtime, so
the text, not the .gz, is kept); `chip_smoke.py` imports it on the card.
Regenerate it with `env JAX_PLATFORMS=cpu python tests/test_torch_refformat.py`.
"""

import gzip
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
COLOR_BANK = os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")
DUAL_BANK = os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")
PAIR_REF = os.path.join(REPO, "tests", "goldens", "refpair_ref.npz")
YML, BIN = "linemod_templates.yml.gz", "linemod_tempPosFile.bin"
FIELDS = ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull")
DUAL_FIELDS = ("nfeat0", "nvalid0", "nfeat1", "nvalid1")


def read_pair(d) -> tuple:
    with gzip.open(os.path.join(d, YML), "rb") as f:
        text = f.read()
    with open(os.path.join(d, BIN), "rb") as f:
        return text, f.read()


def assert_banks_equal(a, b):
    assert a.class_id == b.class_id and a.dual_modality == b.dual_modality
    for f in FIELDS + (DUAL_FIELDS if a.dual_modality else ()):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def sliced(bank, n: int):
    """The first n templates of a bank (either package's TemplateBank)."""
    import copy

    out = copy.copy(bank)
    for f in FIELDS + (DUAL_FIELDS if bank.dual_modality else ()):
        setattr(out, f, getattr(bank, f)[:n])
    return out


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The fixture color bank exported by both packages, and the port's
    import of each."""
    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.utils.refformat import export_reference_bank as jax_export

    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.utils.refformat import export_reference_bank, import_reference_bank

    jax_dir, port_dir = tmp_path_factory.mktemp("jax_pair"), tmp_path_factory.mktemp("port_pair")
    jax_export(JaxBank.load(COLOR_BANK), str(jax_dir))
    bank = TemplateBank.load(COLOR_BANK)
    export_reference_bank(bank, str(port_dir))
    return {"bank": bank, "jax_dir": jax_dir, "port_dir": port_dir,
            "port_import": import_reference_bank(str(port_dir)),
            "import_of_jax": import_reference_bank(str(jax_dir))}


# -- the reference's cases (tests/test_refformat.py) ---------------------------

def test_fixture_bank_roundtrip_fields(pairs):
    bank, got = pairs["bank"], pairs["port_import"]
    assert got.class_id == bank.class_id
    assert got.num_templates == bank.num_templates
    np.testing.assert_array_equal(got.bbox, bank.bbox)
    np.testing.assert_array_equal(got.valid0, bank.valid0)
    np.testing.assert_array_equal(got.feat0[got.valid0], bank.feat0[bank.valid0])
    np.testing.assert_array_equal(got.feat1[got.valid1], bank.feat1[bank.valid1])
    np.testing.assert_allclose(got.z, bank.z, atol=1e-4)
    np.testing.assert_allclose(got.quat, bank.quat, atol=1e-6)
    np.testing.assert_allclose(got.median_depth, np.round(bank.median_depth))
    np.testing.assert_allclose(got.hull, bank.hull)


def test_fixture_bank_roundtrip_detection_identical(pairs):
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state, match_templates

    cfg = MatchConfig(top_k=64, template_chunk=256)
    color = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (480, 640, 3)).astype(np.float32))
    a = match_templates(build_match_state(pairs["bank"], cfg, "cpu"), color)
    b = match_templates(build_match_state(pairs["port_import"], cfg, "cpu"), color)
    for k in ("template_id", "x", "y", "similarity", "valid"):
        assert torch.equal(a[k], b[k]), k


def test_multi_class_pair_roundtrip(tmp_path):
    """Every model goes into one pair; a 2-class pair round-trips with its
    per-class template runs intact."""
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.utils.refformat import export_reference_banks, import_reference_banks

    a = make_synthetic_bank(6, seed=1)
    a.class_id = "a.ply"
    b = make_synthetic_bank(10, seed=2, bbox_wh=32)
    b.class_id = "b.ply"
    export_reference_banks([a, b], str(tmp_path))
    got = import_reference_banks(str(tmp_path))
    assert sorted(got) == ["a.ply", "b.ply"]
    for src in (a, b):
        dst = got[src.class_id]
        assert dst.num_templates == src.num_templates
        np.testing.assert_array_equal(dst.bbox, src.bbox)
        np.testing.assert_array_equal(dst.feat0[dst.valid0], src.feat0[src.valid0])
        np.testing.assert_allclose(dst.quat, src.quat, atol=1e-6)


def test_dual_bank_roundtrip(tmp_path):
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.utils.refformat import export_reference_bank, import_reference_bank

    bank = TemplateBank.load(DUAL_BANK)
    export_reference_bank(bank, str(tmp_path))
    got = import_reference_bank(str(tmp_path))
    assert got.dual_modality
    np.testing.assert_array_equal(got.nvalid0, bank.nvalid0)
    np.testing.assert_array_equal(got.nfeat0[got.nvalid0], bank.nfeat0[bank.nvalid0])
    np.testing.assert_array_equal(got.nfeat1[got.nvalid1], bank.nfeat1[bank.nvalid1])


def test_single_class_import_refuses_two_classes(tmp_path):
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.utils.refformat import export_reference_banks, import_reference_bank

    a, b = make_synthetic_bank(3, seed=1), make_synthetic_bank(4, seed=2)
    a.class_id, b.class_id = "a.ply", "b.ply"
    export_reference_banks([a, b], str(tmp_path))
    with pytest.raises(ValueError, match="2 classes"):
        import_reference_bank(str(tmp_path))


# -- against JAX ----------------------------------------------------------------

def test_export_equals_jax_and_golden(pairs):
    """The port's export of the fixture bank is JAX's: the YAML text and the
    .bin bytes, and both equal the committed golden."""
    text, blob = read_pair(pairs["port_dir"])
    assert (text, blob) == read_pair(pairs["jax_dir"])
    ref = np.load(PAIR_REF)
    assert text == ref["text"].tobytes() and blob == ref["bin"].tobytes()


def test_port_imports_jax_export(pairs):
    """JAX's pair, read by the port, is the port's own round trip."""
    assert_banks_equal(pairs["import_of_jax"], pairs["port_import"])


@pytest.mark.parametrize("path", [COLOR_BANK, DUAL_BANK], ids=["color", "dual"])
def test_jax_imports_port_export(tmp_path, path):
    """The port's pair of a 40-template slice, read by JAX, equals the
    port's import of it, array for array."""
    from linemod_tpu.utils.refformat import import_reference_bank as jax_import

    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.utils.refformat import export_reference_bank, import_reference_bank

    export_reference_bank(sliced(TemplateBank.load(path), 40), str(tmp_path))
    assert_banks_equal(jax_import(str(tmp_path)), import_reference_bank(str(tmp_path)))


def test_parse_yaml_equals_pyyaml(tmp_path):
    """parse_yaml reads what PyYAML reads (after the JAX package's sanitize):
    a two-class dual pair's text and the settings, model and pose files."""
    import yaml

    from linemod_tpu.utils.yamlcv import _sanitize

    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.utils.cvyaml import parse_yaml
    from linemod_tpu_torch.utils.refformat import export_reference_banks

    dual = sliced(TemplateBank.load(DUAL_BANK), 5)
    other = sliced(TemplateBank.load(DUAL_BANK), 3)
    other.class_id = "second.ply"
    export_reference_banks([dual, other], str(tmp_path))
    texts = [read_pair(tmp_path)[0].decode()]
    for name in ("linemod_settings.yml", "models/lagergehaeuse.yml", "benchmark/pose0.yml"):
        with open(os.path.join(EXAMPLE, name)) as f:
            texts.append(f.read())
    texts.append("a:\n- 1\n- [ 2, 3 ]\n- { b: x, c: \"y z\" }\nd:\n  - e: 4.5\n    f: 10.\n  -\n    g: -7\n")
    for text in texts:
        assert parse_yaml(text) == yaml.safe_load(_sanitize(text))


def jax_pair_reference() -> dict:
    """JAX's export of the committed color bank: text and .bin bytes."""
    import tempfile

    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.utils.refformat import export_reference_bank

    with tempfile.TemporaryDirectory() as d:
        export_reference_bank(TemplateBank.load(COLOR_BANK), d)
        text, blob = read_pair(d)
    return {"text": np.frombuffer(text, np.uint8), "bin": np.frombuffer(blob, np.uint8)}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    arrays = jax_pair_reference()
    np.savez_compressed(PAIR_REF, **arrays)
    print(f"wrote {PAIR_REF}: {arrays['text'].size} bytes of YAML, {arrays['bin'].size} of .bin")
