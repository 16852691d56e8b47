"""The port's command line (`python -m linemod_tpu_torch.cli`) and the
tooling behind it (`pipeline/sensors`, `utils/io`, `utils/png.write_png`,
`utils/draw`, `utils/profiling`, `utils/yamlcv`) against the JAX package on
the CPU.

`detect --benchmark --display` and `evaluate --gt yml` / `--gt linemod` run
through both CLIs on the fixture, once each in a module-scoped fixture, and
their printed lines must be equal once the wall-clock numbers are masked;
the overlay PNGs must be equal pixel for pixel. The cases of
`tests/test_cli.py` run through the port. `detect` and `evaluate --gt yml`
also run through both over two sequences of the other frame formats
(`tests/test_torch_imread.sequences`): the fixture as a progressive JPEG
with its depth as an LZW and a Deflate TIFF, and the fixture as a PPM and
a BMP with its depth as a 16-bit PGM.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
# wall-clock numbers in the printed lines
_TIMES = [(re.compile(r"in \d+\.\d ms"), "in <t> ms"),
          (re.compile(r"mean \d+\.\d ms \(\d+\.\d+ fps\)"), "mean <t> ms (<f> fps)")]


def masked(text: str) -> list:
    for pattern, repl in _TIMES:
        text = pattern.sub(repl, text)
    return text.splitlines()


def run_cli(main, argv, cwd=EXAMPLE) -> tuple:
    """(exit code, stdout, stderr) of main(argv) run in `cwd`."""
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


def linemod_sequence(root, ext: str = ".png") -> str:
    """One fixture frame in the public-LINEMOD layout (color0<ext>,
    depth0.dpt, tra0.tra / rot0.rot in the dataset's cm and unfixed frame),
    built as tests/test_cli.py builds its own. Returns the directory."""
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.utils.geometry import quat_to_mat, rotation_about_axis
    from linemod_tpu_torch.utils.io import save_depth_linemod_dataset
    from linemod_tpu_torch.utils.png import read_png, write_png

    seq = os.path.join(str(root), "benchmarkLINEMOD")
    os.makedirs(seq, exist_ok=True)
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    if ext == ".png":
        write_png(os.path.join(seq, "color0.png"), color)
    else:
        import cv2

        cv2.imwrite(os.path.join(seq, "color0" + ext), color)
    save_depth_linemod_dataset(os.path.join(seq, "depth0.dpt"), read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth"))
    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    rot_raw = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0).T @ quat_to_mat(gt.quaternion)
    with open(os.path.join(seq, "tra0.tra"), "w") as f:
        f.write("1 3\n" + " ".join(f"{v / 10.0:.6f}" for v in gt.translation) + "\n")
    with open(os.path.join(seq, "rot0.rot"), "w") as f:
        f.write("3 3\n" + "\n".join(" ".join(f"{v:.8f}" for v in row) for row in rot_raw) + "\n")
    return seq


def _argv(tmp, which):
    seq = os.path.join(str(tmp), "benchmarkLINEMOD")
    return {
        "detect": ["detect", "--model", "lagergehaeuse.ply", "--benchmark",
                   "--display", os.path.join(str(tmp), f"display_{which}")],
        "evaluate_yml": ["evaluate", "--model", "lagergehaeuse.ply", "--images", "benchmark/img%d.png",
                         "--depths", "benchmark/depth%d.png", "--gt", "yml", "--max-frames", "1"],
        "evaluate_linemod": ["evaluate", "--model", "lagergehaeuse.ply", "--images",
                             os.path.join(seq, "color%d.jpg"), "--depths", os.path.join(seq, "depth%d.dpt"),
                             "--gt", "linemod", "--max-frames", "1"],
        "detect_jpeg": ["detect", "--model", "lagergehaeuse.ply", "--images", os.path.join(seq, "color%d.jpg"),
                        "--depths", os.path.join(seq, "depth%d.dpt"), "--max-frames", "1"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each command through both CLIs: {command: {"jax"/"port": (rc, out, err)}}."""
    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main

    tmp = tmp_path_factory.mktemp("cli")
    linemod_sequence(tmp, ext=".jpg")
    out = {"tmp": tmp}
    for which, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        for name, argv in _argv(tmp, which).items():
            out.setdefault(name, {})[which] = run_cli(main, argv + extra)
    return out


# -- the reference's cases (tests/test_cli.py) ---------------------------------

def test_evaluate_yml_fixture(runs):
    rc, out, _ = runs["evaluate_yml"]["port"]
    assert rc == 0
    assert "VSD pass 100.0%" in out
    # lagergehaeuse is rotationally symmetric -> ADD-S selected
    assert "ADD-S pass 100.0%" in out


def test_evaluate_linemod_format(runs):
    rc, out, _ = runs["evaluate_linemod"]["port"]
    assert rc == 0
    assert "ADD-S pass 100.0%" in out


# -- the printed lines against JAX's --------------------------------------------

@pytest.mark.parametrize("command", ["detect", "evaluate_yml", "evaluate_linemod"])
def test_printed_lines_equal_jax(runs, command):
    (rc_j, out_j, err_j), (rc_p, out_p, err_p) = runs[command]["jax"], runs[command]["port"]
    assert rc_p == rc_j == 0
    assert masked(out_p) == masked(out_j)
    assert masked(out_p)[0].startswith("frame 0: ")


def test_detect_overlay_equals_jax(runs):
    """`--display` writes det0.png (write_png) equal to JAX's (cv2.imwrite)
    pixel for pixel; it is the fixture frame with the feature dots and the
    pose axes drawn."""
    import cv2

    from linemod_tpu_torch.utils.png import read_png

    port = os.path.join(str(runs["tmp"]), "display_port", "det0.png")
    want = cv2.imread(os.path.join(str(runs["tmp"]), "display_jax", "det0.png"))
    assert np.array_equal(read_png(port, "color"), want)
    assert np.array_equal(cv2.imread(port), want)
    assert not np.array_equal(want, read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color"))


@pytest.mark.parametrize("command", ["evaluate", "detect"])
def test_jpeg_sequence_equals_jax(runs, command):
    """Over the LINEMOD layout's JPEG frames (color0.jpg written by
    cv2.imwrite, depth0.dpt) both CLIs print the same lines: the port
    decodes the JPEG as cv2.imread does, bit for bit."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import load_frame

    run = runs["evaluate_linemod" if command == "evaluate" else "detect_jpeg"]
    (rc_j, out_j, _), (rc_p, out_p, _) = run["jax"], run["port"]
    assert rc_p == rc_j == 0
    assert masked(out_p) == masked(out_j)
    seq = os.path.join(str(runs["tmp"]), "benchmarkLINEMOD")
    color, _ = load_frame(os.path.join(seq, "color0.jpg"), os.path.join(seq, "depth0.dpt"))
    assert np.array_equal(color, cv2.imread(os.path.join(seq, "color0.jpg")))


@pytest.fixture(scope="module")
def format_runs(tmp_path_factory):
    """`detect` and `evaluate --gt yml` over both sequences through both
    CLIs: {(sequence, command): {"jax"/"port": (rc, out, err)}}."""
    from linemod_tpu.cli import main as jax_main
    from test_torch_imread import cli_argv, sequences

    from linemod_tpu_torch.cli import main as port_main

    out = {}
    for name, seq in sequences(str(tmp_path_factory.mktemp("formats"))).items():
        for command in ("detect", "evaluate"):
            for which, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
                out.setdefault((name, command), {})[which] = run_cli(main, cli_argv(command, seq) + extra)
    return out


@pytest.mark.parametrize("command", ["detect", "evaluate"])
@pytest.mark.parametrize("sequence", ["progressive", "lossless"])
def test_format_sequences_equal_jax(format_runs, sequence, command):
    """Over the progressive JPEG + TIFF frames and the PPM / BMP + PGM
    frames both CLIs print the same lines, which are the goldens'
    (tests/goldens/imread_ref.npz); the lossless ones are the PNG
    fixture's."""
    (rc_j, out_j, _), (rc_p, out_p, _) = format_runs[(sequence, command)]["jax"], format_runs[(sequence, command)]["port"]
    assert rc_p == rc_j == 0
    assert masked(out_p) == masked(out_j)
    assert masked(out_p) == list(np.load(os.path.join(REPO, "tests", "goldens", "imread_ref.npz"))[
        f"{sequence}_{command}_lines"])
    assert len(masked(out_p)) == 3 and masked(out_p)[1].startswith("frame 1: ")


def test_cuda_without_card_is_an_error(monkeypatch):
    """--device cuda (the default) with no card stops before any work and
    never falls back to the CPU."""
    from linemod_tpu_torch import cli
    from linemod_tpu_torch.tools import accuracy_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["detect", "--model", "lagergehaeuse.ply"], ["evaluate", "--model", "lagergehaeuse.ply"],
                 ["generate"], ["aruco", "--capture"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            run_cli(cli.main, argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        accuracy_eval.main(["--frames-per-mode", "1"])


@pytest.mark.parametrize("command", ["detect", "evaluate"])
def test_missing_bank_and_no_frames_exit_2(tmp_path, command):
    """A missing bank and an empty sequence: exit code 2 and JAX's error line."""
    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main

    for argv, wanted in (
        ([command, "--model", "lagergehaeuse.ply", "--banks", str(tmp_path)], "no bank at"),
        ([command, "--model", "lagergehaeuse.ply", "--images", str(tmp_path / "img%d.png"),
          "--depths", str(tmp_path / "depth%d.png")], "no input images"),
    ):
        rc_p, out_p, err_p = run_cli(port_main, argv + ["--device", "cpu"])
        rc_j, out_j, err_j = run_cli(jax_main, argv)
        assert rc_p == rc_j == 2 and err_p == err_j and wanted in err_p and out_p == out_j == ""


def test_detect_profile_stages(tmp_path):
    """--profile prints the program's spans of the frame (frame.submit,
    frame.collect and their parts) beside the detect call and the PNG
    decode, in StageTimer.summary's format."""
    from linemod_tpu_torch.cli import main

    rc, out, _ = run_cli(main, ["detect", "--model", "lagergehaeuse.ply", "--profile", "--device", "cpu"])
    assert rc == 0
    stages = {line.split()[0]: line for line in out.splitlines()[2:]}
    assert set(stages) == {
        "detect", "decode", "frame.submit", "submit.recenter", "submit.upload", "match.quantize",
        "match.planes", "match.cut", "match.refine", "match.pack", "frame.collect", "collect.copy",
        "collect.group", "collect.checks",
    }
    assert stages["detect"].endswith("x1") and stages["decode"].endswith("x2")
    assert stages["frame.submit"].endswith("x1") and stages["match.quantize"].endswith("x2")


@pytest.mark.parametrize("direction", ["port_imports_jax", "jax_imports_port"])
def test_convert_between_packages(tmp_path, direction):
    """`convert --to-reference` in one package and `--from-reference` in the
    other give the bank that the importing package's own round trip gives
    (a 40-template slice of the fixture bank: PyYAML reads the full pair in
    ~50 s)."""
    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main
    from linemod_tpu_torch.models.template_bank import TemplateBank

    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    for f in ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull"):
        setattr(bank, f, getattr(bank, f)[:40])
    src = str(tmp_path / "slice.npz")
    bank.save(src)
    exporter, importer = (jax_main, port_main) if direction == "port_imports_jax" else (port_main, jax_main)
    rc, out, _ = run_cli(exporter, ["convert", "--to-reference", str(tmp_path / "pair"), "--bank", src])
    assert rc == 0 and out.startswith("exported 40 templates -> ")
    rc, out, _ = run_cli(importer, ["convert", "--from-reference", str(tmp_path / "pair"),
                                    "--bank", str(tmp_path / "got.npz")])
    assert rc == 0 and out == f"imported 40 templates (lagergehaeuse.ply) -> {tmp_path / 'got.npz'}\n"
    run_cli(importer, ["convert", "--to-reference", str(tmp_path / "own"), "--bank", src])
    run_cli(importer, ["convert", "--from-reference", str(tmp_path / "own"), "--bank", str(tmp_path / "own.npz")])
    got, own = TemplateBank.load(str(tmp_path / "got.npz")), TemplateBank.load(str(tmp_path / "own.npz"))
    assert got.class_id == own.class_id and not got.dual_modality
    for f in ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull"):
        assert np.array_equal(getattr(got, f), getattr(own, f)), f
    with pytest.raises(SystemExit, match="exactly one"):
        run_cli(port_main, ["convert", "--bank", src])


# -- the tooling against JAX's ----------------------------------------------------

def test_dpt_bytes_equal_jax(tmp_path):
    from linemod_tpu.utils.io import load_depth_linemod_dataset as jax_load
    from linemod_tpu.utils.io import save_depth_linemod_dataset as jax_save

    from linemod_tpu_torch.utils.io import load_depth_linemod_dataset, save_depth_linemod_dataset

    depth = np.random.default_rng(3).integers(0, 65536, (37, 53), dtype=np.uint16)
    save_depth_linemod_dataset(str(tmp_path / "port.dpt"), depth)
    jax_save(str(tmp_path / "jax.dpt"), depth)
    assert (tmp_path / "port.dpt").read_bytes() == (tmp_path / "jax.dpt").read_bytes()
    assert np.array_equal(load_depth_linemod_dataset(str(tmp_path / "jax.dpt")), depth)
    assert np.array_equal(jax_load(str(tmp_path / "port.dpt")), depth)


@pytest.mark.parametrize("kind", ["color", "gray", "depth"])
def test_write_png_reads_back(tmp_path, kind):
    """write_png's files read back equal by the port's decoder and by
    cv2.imread."""
    import cv2

    from linemod_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(4)
    if kind == "color":
        img, flag = rng.integers(0, 256, (45, 67, 3), dtype=np.uint8), cv2.IMREAD_COLOR
    elif kind == "gray":
        img, flag = rng.integers(0, 256, (45, 67), dtype=np.uint8), cv2.IMREAD_UNCHANGED
    else:
        img, flag = rng.integers(0, 65536, (45, 67), dtype=np.uint16), cv2.IMREAD_ANYDEPTH
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img)
    assert np.array_equal(read_png(path, "color" if kind == "color" else "anydepth"), img)
    assert np.array_equal(cv2.imread(path, flag), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_file_sequence_source_equals_jax(tmp_path):
    """FileSequenceSource over PNG, JPEG and .dpt sequences gives JAX's
    frames; ArraySource replays its frames."""
    from linemod_tpu.pipeline.sensors import FileSequenceSource as JaxSource

    from linemod_tpu_torch.pipeline.sensors import ArraySource, FileSequenceSource

    bench = os.path.join(EXAMPLE, "benchmark")
    seq = linemod_sequence(tmp_path)
    linemod_sequence(tmp_path, ext=".jpg")
    for images, depths in ((os.path.join(bench, "img%d.png"), os.path.join(bench, "depth%d.png")),
                           (os.path.join(seq, "color%d.png"), os.path.join(seq, "depth%d.dpt")),
                           (os.path.join(seq, "color%d.jpg"), os.path.join(seq, "depth%d.dpt"))):
        got, want = list(FileSequenceSource(images, depths)), list(JaxSource(images, depths))
        assert len(got) == len(want) == 1
        for (c, d), (wc, wd) in zip(got, want):
            assert np.array_equal(c, wc) and np.array_equal(d, wd) and d.dtype == wd.dtype
    assert list(ArraySource(got)) == got


def test_overlays_equal_jax():
    """draw_coordinate_system and draw_features on the fixture frame give
    JAX's pixels, at the ground-truth pose and near the image border."""
    from linemod_tpu.utils.draw import draw_coordinate_system as jax_axes
    from linemod_tpu.utils.draw import draw_features as jax_features

    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.utils.draw import draw_coordinate_system, draw_features
    from linemod_tpu_torch.utils.png import read_png

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    pose = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    img = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    got, want = img.copy(), img.copy()
    for t, xy in ((5, (250, 200)), (700, (600, 450)), (1949, (-10, 3))):
        draw_features(got, bank.feat0[t], bank.valid0[t], xy)
        jax_features(want, bank.feat0[t], bank.valid0[t], xy)
    for length in (75.0, 400.0):
        draw_coordinate_system(got, cam, length, pose)
        jax_axes(want, cam, length, pose)
    assert np.array_equal(got, want) and not np.array_equal(got, img)


def test_stage_timer_summary_equals_jax():
    from linemod_tpu.utils.profiling import StageTimer as JaxTimer

    from linemod_tpu_torch.utils.profiling import StageTimer

    port, jax_timer = StageTimer(sync=False), JaxTimer(sync=False)
    for timer in (port, jax_timer):
        for name, seconds, n in (("detect", 0.0421, 3), ("detect.fetch", 0.0012, 3), ("decode", 0.25, 4)):
            timer.totals[name] += seconds
            timer.counts[name] += n
    assert port.summary() == jax_timer.summary()
    with port.stage("work"):
        sum(range(1000))
    assert port.counts["work"] == 1 and port.totals["work"] > 0.0


def test_stage_timer_sync_on_cpu_and_trace(tmp_path):
    """A synchronising timer on a CPU device needs no card; the spans
    recorded inside its stage fold into it."""
    from linemod_tpu_torch.utils.profiling import RECORDER, StageTimer, recording, span

    timer = StageTimer(sync=True, device="cpu")
    RECORDER.take()
    with recording(), timer.stage("matmul"), span("match.cut"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    timer.add_spans(RECORDER.take())
    assert timer.counts["matmul"] == 1 and timer.counts["match.cut"] == 1
    assert 0.0 < timer.totals["match.cut"] <= timer.totals["matmul"]


def test_write_yamlcv_equals_jax(tmp_path):
    from linemod_tpu.utils.yamlcv import write_yamlcv as jax_write

    from linemod_tpu_torch.utils.yamlcv import read_yamlcv, write_yamlcv

    data = {"rotMat": np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0, "position": [1.5, -2.0, 600.25],
            "flags": (True, False), "count": np.int32(3), "scale": 0.1, "name": "lagergehaeuse",
            "ids": np.arange(4)}
    write_yamlcv(str(tmp_path / "port.yml"), data)
    jax_write(str(tmp_path / "jax.yml"), data)
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "jax.yml").read_text()
    back = read_yamlcv(str(tmp_path / "port.yml"))
    assert np.array_equal(back["rotMat"], data["rotMat"]) and back["position"] == [1.5, -2.0, 600.25]


def test_generate_equals_jax(tmp_path):
    """`generate` through both CLIs on a small settings file (an OBJ cube at
    one radius, three in-plane angles, the icosahedron undivided; the file
    written with write_yamlcv) gives banks equal array for array."""
    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.utils.yamlcv import read_yamlcv, write_yamlcv

    models = tmp_path / "models"
    models.mkdir()
    half = 40.0
    verts = [(x, y, z) for x in (-half, half) for y in (-half, half) for z in (-half, half)]
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(models / "cube.obj", "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
        f.writelines(f"f {a+1} {b+1} {c+1}\n" for a, b, c in faces)
    write_yamlcv(str(models / "cube.yml"), {"planes of symmetry": [1, 1, 1]})
    settings = read_yamlcv(os.path.join(EXAMPLE, "linemod_settings.yml"))
    settings.update({"model folder": str(models) + "/", "model file ending": ".obj", "distance start": 600,
                     "distance stop": 600, "icosahedron subdivisions": 0, "in plane rotation starting angle": -45,
                     "in plane rotation stopping angle": 45, "in plane rotation angle step": 45})
    write_yamlcv(str(tmp_path / "settings.yml"), settings)
    banks, printed = {}, {}
    for which, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        rc, out, _ = run_cli(main, ["generate", "--settings", str(tmp_path / "settings.yml"),
                                    "--banks", str(tmp_path / which)] + extra, cwd=str(tmp_path))
        assert rc == 0
        banks[which] = TemplateBank.load(str(tmp_path / which / "cube.npz"))
        # the progress line and the summary, wall-clock seconds and the bank folder masked
        printed[which] = re.sub(r"\b[\d.]+s\b", "<s>", out.replace(str(tmp_path / which), "<banks>"))
    assert printed["port"] == printed["jax"] and "(9 templates, <s>)" in printed["port"]
    got, want = banks["port"], banks["jax"]
    assert got.num_templates == want.num_templates == 9 and got.class_id == want.class_id == "cube.obj"
    for f in ("feat0", "valid0", "feat1", "valid1", "bbox", "quat", "z", "median_depth", "hull"):
        assert getattr(got, f).dtype == getattr(want, f).dtype and np.array_equal(getattr(got, f), getattr(want, f)), f


# -- aruco and the pose files ------------------------------------------------------

def test_aruco_board_equals_jax(tmp_path):
    """`aruco --out` writes JAX's board image pixel for pixel (8-bit gray)
    and prints JAX's line."""
    import cv2

    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main

    rc_j, out_j, _ = run_cli(jax_main, ["aruco", "--out", str(tmp_path / "jax.png")])
    rc_p, out_p, _ = run_cli(port_main, ["aruco", "--out", str(tmp_path / "port.png")])
    assert rc_p == rc_j == 0 and out_p == out_j.replace("jax.png", "port.png")
    want = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert want.shape == got.shape == (1000, 720) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def _capture_sequence(root) -> str:
    """Two views of the printed board at the settings' camera (640x480, with
    its distortion ignored by the renderer) and a flat frame with no board,
    as a PNG sequence with flat depths."""
    import cv2

    from linemod_tpu_torch.config import load_settings
    from linemod_tpu_torch.ops.aruco import GridBoard
    from linemod_tpu_torch.pipeline.aruco_capture import board_view

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    board = GridBoard((5, 7), 120.0, 20.0).generate_image((720, 1000), 20)
    seq = os.path.join(str(root), "capture")
    os.makedirs(seq)
    views = [((0.1, -0.2, 0.05), (-340.0, -480.0, 4200.0)), None, ((0.3, 0.1, -0.2), (-300.0, -500.0, 4500.0))]
    for i, view in enumerate(views):
        frame = np.full((480, 640, 3), 128, np.uint8) if view is None else board_view(board, cam, *map(np.array, view))
        cv2.imwrite(os.path.join(seq, f"img{i}.png"), frame)
        cv2.imwrite(os.path.join(seq, f"depth{i}.png"), np.full((480, 640), 700 + i, np.uint16))
    return seq


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """`aruco --capture` over the board sequence through both CLIs:
    {"jax"/"port": (rc, out, err, out_dir)}."""
    from linemod_tpu.cli import main as jax_main

    from linemod_tpu_torch.cli import main as port_main

    tmp = tmp_path_factory.mktemp("aruco")
    seq = _capture_sequence(tmp)
    out = {}
    for which, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out_dir = os.path.join(str(tmp), which)
        argv = ["aruco", "--capture", "--images", os.path.join(seq, "img%d.png"),
                "--depths", os.path.join(seq, "depth%d.png"), "--out-dir", out_dir]
        out[which] = run_cli(main, argv + extra) + (out_dir,)
    return out


def test_aruco_capture_equals_jax(captures):
    """Both captures keep the two board frames (the flat frame is skipped),
    print the same line, and write images equal pixel for pixel and pose
    files that read back within the pose solvers' gap (the port's
    Levenberg-Marquardt runs to convergence; OpenCV's stops earlier:
    measured 1.5e-5 mm and 1e-8 here)."""
    import cv2

    from linemod_tpu.utils.yamlcv import read_yamlcv as jax_read

    (rc_j, out_j, _, dir_j), (rc_p, out_p, _, dir_p) = captures["jax"], captures["port"]
    assert rc_p == rc_j == 0
    assert out_j == f"captured 2 frames to {dir_j}\n" and out_p == f"captured 2 frames to {dir_p}\n"
    assert sorted(os.listdir(dir_p)) == sorted(os.listdir(dir_j)) == sorted(
        f"{k}{i}.{e}" for i in range(2) for k, e in (("img", "png"), ("depth", "png"), ("pose", "yml")))
    for i in range(2):
        for name, flag in ((f"img{i}.png", cv2.IMREAD_UNCHANGED), (f"depth{i}.png", cv2.IMREAD_UNCHANGED)):
            want, got = cv2.imread(os.path.join(dir_j, name), flag), cv2.imread(os.path.join(dir_p, name), flag)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        want, got = jax_read(os.path.join(dir_j, f"pose{i}.yml")), jax_read(os.path.join(dir_p, f"pose{i}.yml"))
        assert list(got) == list(want) == ["rotMat", "position"]
        np.testing.assert_allclose(got["rotMat"], want["rotMat"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["position"], want["position"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["benchmark/pose0.yml", "models/lagergehaeuse.yml", "linemod_settings.yml",
                                  "captured"])
def test_read_yamlcv_equals_jax(captures, name):
    """read_yamlcv returns JAX's dict: the same keys in the same order,
    scalars of the same type and value, matrices as equal float64 arrays."""
    from linemod_tpu.utils.yamlcv import read_yamlcv as jax_read

    from linemod_tpu_torch.utils.yamlcv import read_yamlcv

    path = os.path.join(captures["port"][3], "pose0.yml") if name == "captured" else os.path.join(EXAMPLE, name)

    def same(a, b):
        if isinstance(a, dict):
            return isinstance(b, dict) and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return isinstance(b, list) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
        return type(a) is type(b) and a == b

    want = jax_read(path)
    assert want and same(read_yamlcv(path), want)
