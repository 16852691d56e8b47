"""The readings a cell's check limits are set from, on the card.

    python3 -m portbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...] [--control-seeds <n> ...]

For each of `--seeds`, in one process: the cell's inputs from the seed, a
short window of the program at the cell's own load, and the check's numbers
of the program against the plain reference (the lower readings). For each
of `--control-seeds`: the control, the plain reference computed in
bfloat16 (the precision below the configuration's float32) put in the
program's place, on the same frames and as many answers as the seed's
window compared, against the float32 reference (the upper readings). One
JSON line a seed; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

import torch

from portbench import harness, inputs


def control_numbers(config: dict, mix: dict, bank: dict, pool: list, window: harness.Window,
                    ref: dict, checked: list, device) -> dict:
    """The check's numbers of the bfloat16 reference in the program's place
    over the window's answers to the checked frames."""
    low, _ = harness.reference_frames(config, mix, bank, pool, checked, device, precision="bfloat16")

    def poses(k):
        return [types.SimpleNamespace(translation=t, quaternion=q, bounding_box=b) for t, q, b in low[k][1]]

    stand_in = harness.Window(
        sent=window.sent,
        answers=[poses(k) if k in low else [] for k in window.sent],
        packed=[low[k][0] if k in low else None for k in window.sent],
        seconds=window.seconds, latencies=[])
    return harness.compare(stand_in, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Lower and upper readings of a cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    manifest = inputs.load_json(os.path.join(inputs.REPO, "BENCHMARK.json"))
    cell = next(c for c in manifest["workloads"] if c["name"] == args.workload)
    config, mix = harness.load_cell(manifest, cell)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        t0 = time.perf_counter()
        out = harness.run_cell(config, mix, seed, args.seconds, False, device, t0,
                               log=lambda s: print(s, file=sys.stderr))
        line = {"workload": args.workload, "seed": seed, "program": out["numbers"]}
        if seed in args.control_seeds:
            bank, pool, checked = out["inputs"]
            line["control"] = control_numbers(config, mix, bank, pool, out["run"].window, out["ref"], checked,
                                              device)
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
