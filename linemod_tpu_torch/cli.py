"""Command-line entry points of the PyTorch port (counterpart of
`linemod_tpu/cli.py`, which stands in for the reference's three
executables, CMakeLists.txt:67-69: `Template_Generator` -> `generate`,
`Detector` -> `detect` and `evaluate`, `Arcuo_Benchmark` -> `aruco`).

The flags, defaults, printed lines and exit codes are the JAX package's,
and configuration comes from the same `linemod_settings.yml`. `--device`
(default `cuda`) picks the card; without one, `--device cuda` stops at once
with an error and never falls back to the CPU; `--device cpu` runs the
plain PyTorch versions of the kernels. `convert` runs on the host.

Usage:
    python -m linemod_tpu_torch.cli generate [--settings F] [--banks DIR]
    python -m linemod_tpu_torch.cli detect --model lagergehaeuse.ply \\
        [--images benchmark/img%d.png --depths benchmark/depth%d.png] \\
        [--benchmark] [--display OUT_DIR] [--profile]
    python -m linemod_tpu_torch.cli evaluate --model lagergehaeuse.ply \\
        [--images benchmarkLINEMOD/color%d.jpg --depths benchmarkLINEMOD/depth%d.dpt \\
         --gt linemod]   # or --gt yml for the reference's pose%d.yml capture format
    python -m linemod_tpu_torch.cli aruco --out board.png
    python -m linemod_tpu_torch.cli aruco --capture --images capture/img%d.png \\
        --depths capture/depth%d.png --out-dir benchmark
    python -m linemod_tpu_torch.cli convert --to-reference DIR --bank banks/m.npz

Color frames are PNG or JPEG, told apart by their leading bytes as
`cv2.imread` does (pipeline/sensors.py); depth frames PNG or `.dpt`.
`detect` reads a `%d` PNG sequence through the prefetching loader
(`_frame_source`), any other sequence a frame at a time. Not ported:
`detect --show` and `aruco --interactive` (a GUI-capable OpenCV) and
`aruco --images kinect` (libfreenect2 and USB).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch


def device_from_flag(name: str) -> torch.device:
    """The device a `--device` flag names; a CUDA device torch cannot see
    stops the program (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {name}: torch sees no CUDA device "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _load_bank(args):
    """(camera, settings, model path, bank) of --model, or None after
    printing the error."""
    from .config import load_settings
    from .models.template_bank import TemplateBank

    cam, settings = load_settings(args.settings)
    model_path = os.path.join(settings.model_folder, args.model)
    bank_path = os.path.join(args.banks, os.path.splitext(args.model)[0] + ".npz")
    if not os.path.exists(bank_path):
        print(f"error: no bank at {bank_path}; run generate first", file=sys.stderr)
        return None
    return cam, settings, model_path, TemplateBank.load(bank_path)


def _frame_source(images: str, depths: str, width: int, height: int):
    """(color, depth) frames of a numbered sequence. A `%d` pair of PNG
    templates goes through utils/native.NativeFrameLoader, which decodes
    frame i+1 on a background thread while frame i is detected; anything
    else (a `.dpt` depth, a single file) through FileSequenceSource, a frame
    at a time. A frame that fails to decode raises: there is no fallback."""
    from .pipeline.sensors import FileSequenceSource
    from .utils.native import NativeFrameLoader

    if "%" in images and images.endswith(".png") and depths.endswith(".png"):
        with NativeFrameLoader(images, depths, width, height) as loader:
            yield from loader
        return
    yield from FileSequenceSource(images, depths)


def cmd_generate(args):
    from .config import load_settings
    from .pipeline.template_generator import TemplateGenerator

    dev = device_from_flag(args.device)
    cam, settings = load_settings(args.settings)
    TemplateGenerator(cam, settings, out_dir=args.banks, device=dev).run()
    return 0


def cmd_detect(args):
    from .config import load_model_properties
    from .ops.icp import IcpRefiner
    from .ops.rasterizer import mesh_to_arrays
    from .pipeline.benchmark import Benchmark, read_ground_truth_pose
    from .pipeline.pose_detection import DetectionDebug, PoseDetection
    from .utils.draw import draw_coordinate_system, draw_features
    from .utils.mesh_io import load_mesh
    from .utils.png import write_png
    from .utils.profiling import RECORDER, StageTimer, maybe_stage, recording

    dev = device_from_flag(args.device)
    loaded = _load_bank(args)
    if loaded is None:
        return 2
    cam, settings, model_path, bank = loaded
    props = load_model_properties(model_path)
    mesh = load_mesh(model_path)
    marr = mesh_to_arrays(mesh, dev)
    icp = (
        IcpRefiner(mesh, cam, settings.icp_subsampling_factor, mesh_arrays=marr)
        if settings.use_icp
        else None
    )
    det = PoseDetection(bank, cam, settings, props, dev, mesh=mesh, icp=icp)
    bench = Benchmark(mesh, cam, dev) if args.benchmark else None
    # sync=False: wall-clock stages, with the program's spans of each frame
    # (frame.submit, frame.collect and their parts) folded in
    timer = StageTimer(sync=False) if args.profile else None

    frames = _frame_source(args.images, args.depths, cam.width, cam.height)
    i = -1
    times = []
    while True:
        with maybe_stage(timer, "decode"):
            frame = next(frames, None)
        if frame is None:
            break
        i += 1
        color, depth = frame
        t0 = time.time()
        dbg = DetectionDebug() if args.display else None
        with maybe_stage(timer, "detect"), recording() if timer else contextlib.nullcontext():
            poses = det.detect(color, depth, args.num_objects, debug=dbg)
        if timer:
            timer.add_spans(RECORDER.take())
        times.append(time.time() - t0)
        msg = f"frame {i}: {len(poses)} pose(s) in {times[-1]*1000:.1f} ms"
        if poses and bench is not None:
            with maybe_stage(timer, "benchmark"):
                gt = read_ground_truth_pose(
                    os.path.join(os.path.dirname(args.images % 0), f"pose{i}.yml")
                )
                scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
                err = bench.score_vsd(scene, gt, poses[0])
            bench.next_image()
            msg += f"  VSD error: {err:.3f}  ({bench.hodan_score:.0f}% correct)"
        elif bench is not None:
            bench.next_image()
        print(msg)
        if args.display and poses:
            with maybe_stage(timer, "display"):
                out = color.copy()
                # feature dots of every passing check (drawResponse analogue,
                # src/HighLevelLinemod.cpp:545-566) + pose axes
                for t, _, _, okc, okd, xy in dbg.checks:
                    if okc and okd:
                        draw_features(out, bank.feat0[t], bank.valid0[t], xy)
                for p in poses:
                    draw_coordinate_system(out, cam, 75.0, p)
                os.makedirs(args.display, exist_ok=True)
                write_png(os.path.join(args.display, f"det{i}.png"), out)
        if args.max_frames and i + 1 >= args.max_frames:
            break
    if i < 0:
        print("error: no input images", file=sys.stderr)
        return 2
    if times:
        print(
            f"{i + 1} frames, mean {np.mean(times)*1000:.1f} ms "
            f"({1.0/np.mean(times):.2f} fps)"
        )
    if timer:
        print(timer.summary())
    return 0


def cmd_evaluate(args):
    """Dataset evaluation with running pass rates (the reference's
    LINEMOD-dataset flow, detector.cpp:13,28 + src/Benchmark.cpp:40-131,
    196-251): VSD on every frame, plus ADD, or ADD-S when the model is
    rotationally symmetric or has symmetry planes (the ambiguous-pose
    variant, src/Benchmark.cpp:84-131)."""
    from .config import load_model_properties
    from .ops.metrics import OBJECT_DIAMETER
    from .pipeline.benchmark import Benchmark, read_ground_truth_linemod, read_ground_truth_pose
    from .pipeline.pose_detection import PoseDetection
    from .pipeline.sensors import frame_paths, load_frame
    from .utils.mesh_io import load_mesh

    dev = device_from_flag(args.device)
    loaded = _load_bank(args)
    if loaded is None:
        return 2
    cam, settings, model_path, bank = loaded
    props = load_model_properties(model_path)
    mesh = load_mesh(model_path)
    det = PoseDetection(bank, cam, settings, props, dev)
    bench = Benchmark(mesh, cam, dev)
    # a zero entry in planes_of_symmetry means no symmetry about that plane,
    # so only nonzero entries select ADD-S
    use_adds = props.rotationally_symmetrical or any(
        s != 0.0 for s in props.planes_of_symmetry
    )
    diameter = OBJECT_DIAMETER if args.diameter is None else args.diameter
    base = os.path.dirname(args.images % 0 if "%" in args.images else args.images)

    n = vsd_pass = pose_pass = detected = 0
    i = args.start
    while True:
        img_path, depth_path = frame_paths(args.images, args.depths, i)
        if not os.path.exists(img_path):
            break
        color, depth = load_frame(img_path, depth_path)
        if args.gt == "linemod":
            gt = read_ground_truth_linemod(
                os.path.join(base, f"tra{i}.tra"), os.path.join(base, f"rot{i}.rot")
            )
        else:
            gt = read_ground_truth_pose(os.path.join(base, f"pose{i}.yml"))
        poses = det.detect(color, depth, 1)
        n += 1
        msg = f"frame {i}: "
        if poses:
            detected += 1
            scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
            vsd = bench.score_vsd(scene, gt, poses[0])
            if use_adds:
                err = bench.score_adds(gt, poses[0], diameter)
                metric = "ADD-S"
            else:
                err = bench.score_add(gt, poses[0], diameter)
                metric = "ADD"
            vsd_pass += vsd < 0.3
            pose_pass += err <= diameter
            msg += f"VSD {vsd:.3f}  {metric} {err:.2f} mm"
        else:
            msg += "no detection"
        msg += (
            f"   running: VSD {100.0 * vsd_pass / n:.1f}%"
            f"  {'ADD-S' if use_adds else 'ADD'} {100.0 * pose_pass / n:.1f}%"
            f"  detected {100.0 * detected / n:.1f}%"
        )
        print(msg)
        i += 1
        if args.max_frames and n >= args.max_frames:
            break
    if n == 0:
        print("error: no input images", file=sys.stderr)
        return 2
    print(
        f"== {n} frames: VSD pass {100.0 * vsd_pass / n:.1f}%, "
        f"{'ADD-S' if use_adds else 'ADD'} pass {100.0 * pose_pass / n:.1f}%, "
        f"detection rate {100.0 * detected / n:.1f}%"
    )
    return 0


def cmd_convert(args):
    """Bank migration to/from the reference's on-disk pair."""
    from .models.template_bank import TemplateBank
    from .utils.refformat import export_reference_bank, import_reference_banks

    if bool(args.from_reference) == bool(args.to_reference):
        raise SystemExit("convert: pass exactly one of --from-reference / "
                         "--to-reference")
    if not args.bank:
        raise SystemExit("convert: --bank is required")
    if args.from_reference:
        banks = import_reference_banks(args.from_reference)
        if len(banks) == 1 and not os.path.isdir(args.bank):
            bank = next(iter(banks.values()))
            bank.save(args.bank)
            print(f"imported {bank.num_templates} templates "
                  f"({bank.class_id}) -> {args.bank}")
        else:
            # the reference pair holds every model; --bank is a directory
            os.makedirs(args.bank, exist_ok=True)
            for cid, bank in banks.items():
                stem = os.path.splitext(os.path.basename(cid))[0]
                path = os.path.join(args.bank, stem + ".npz")
                bank.save(path)
                print(f"imported {bank.num_templates} templates "
                      f"({cid}) -> {path}")
    else:
        bank = TemplateBank.load(args.bank)
        yml, binp = export_reference_bank(bank, args.to_reference)
        print(f"exported {bank.num_templates} templates -> {yml}, {binp}")
    return 0


def cmd_aruco(args):
    from .pipeline.aruco_capture import create_aruco_board

    if args.capture:
        # ground-truth dataset capture (the Arcuo_Benchmark loop,
        # src/Aruco.cpp:36-110): every board-detected frame is saved
        # headlessly; --interactive (the HUD) needs a GUI and raises
        from .config import load_settings
        from .pipeline.aruco_capture import capture_ground_truth, capture_ground_truth_interactive

        dev = device_from_flag(args.device)
        cam, _ = load_settings(args.settings)
        if args.images == "kinect":
            from .pipeline.sensors import Kinect2Source

            src = Kinect2Source()
        else:
            # a frame at a time: a capture's frames need not be the
            # settings' size, which the prefetching loader holds them to
            from .pipeline.sensors import FileSequenceSource

            src = FileSequenceSource(args.images, args.depths)
        if args.interactive:
            n = capture_ground_truth_interactive(src, cam, args.out_dir)
        else:
            n = capture_ground_truth(src, cam, args.out_dir, device=dev)
        print(f"captured {n} frames to {args.out_dir}")
        return 0
    create_aruco_board(args.out)
    print(f"wrote {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="linemod_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device (default cuda; cpu runs the kernels' plain versions)")

    g = sub.add_parser("generate", help="build template banks for all models")
    g.add_argument("--settings", default="linemod_settings.yml")
    g.add_argument("--banks", default="banks")
    device_flag(g)
    g.set_defaults(fn=cmd_generate)

    d = sub.add_parser("detect", help="run detection over an image sequence")
    d.add_argument("--settings", default="linemod_settings.yml")
    d.add_argument("--banks", default="banks")
    d.add_argument("--model", required=True)
    d.add_argument("--images", default="benchmark/img%d.png")
    d.add_argument("--depths", default="benchmark/depth%d.png")
    d.add_argument("--num-objects", type=int, default=1)
    d.add_argument("--benchmark", action="store_true")
    d.add_argument("--display", default="", help="directory for overlay images")
    d.add_argument("--max-frames", type=int, default=0)
    d.add_argument("--profile", action="store_true",
                   help="print a per-stage wall-clock breakdown at the end")
    device_flag(d)
    d.set_defaults(fn=cmd_detect)

    e = sub.add_parser(
        "evaluate", help="score detection over a dataset (VSD + ADD/ADD-S pass rates)"
    )
    e.add_argument("--settings", default="linemod_settings.yml")
    e.add_argument("--banks", default="banks")
    e.add_argument("--model", required=True)
    e.add_argument(
        "--images", default="benchmarkLINEMOD/color%d.jpg",
        help="frame template (reference layout: benchmarkLINEMOD/color%%d.jpg)",
    )
    e.add_argument(
        "--depths", default="benchmarkLINEMOD/depth%d.dpt",
        help=".dpt (LINEMOD raw) or 16-bit png depth template",
    )
    e.add_argument(
        "--gt", choices=["linemod", "yml"], default="linemod",
        help="ground-truth format: tra%%d.tra/rot%%d.rot or pose%%d.yml",
    )
    e.add_argument("--diameter", type=float, default=None,
                   help="ADD correctness diameter (default: reference constant)")
    e.add_argument("--start", type=int, default=0)
    e.add_argument("--max-frames", type=int, default=0)
    device_flag(e)
    e.set_defaults(fn=cmd_evaluate)

    a = sub.add_parser(
        "aruco", help="aruco board image / ground-truth dataset capture"
    )
    a.add_argument("--out", default="aruco_board.png")
    a.add_argument("--capture", action="store_true",
                   help="capture img/depth/pose ground-truth frames")
    a.add_argument("--interactive", action="store_true",
                   help="HUD capture loop (TAB=save, ESC=quit); needs a GUI")
    a.add_argument("--settings", default="linemod_settings.yml")
    a.add_argument("--images", default="capture/img%d.png",
                   help="frame source template, or 'kinect' for live capture")
    a.add_argument("--depths", default="capture/depth%d.png")
    a.add_argument("--out-dir", default="benchmark")
    device_flag(a)
    a.set_defaults(fn=cmd_aruco)

    c = sub.add_parser(
        "convert",
        help="convert banks between this framework's npz format and the "
             "reference's linemod_templates.yml.gz + linemod_tempPosFile.bin "
             "pair (src/HighLevelLinemod.cpp:256-320)",
    )
    c.add_argument("--from-reference", metavar="DIR",
                   help="directory holding the reference pair to import")
    c.add_argument("--to-reference", metavar="DIR",
                   help="directory to export the reference pair into")
    c.add_argument("--bank", help="npz bank path (import target / export source)")
    c.set_defaults(fn=cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
