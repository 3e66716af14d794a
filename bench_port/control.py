"""The precision control of the logits check.

The control is the reference put in the program's place and computed one
precision below the configuration's bf16: every projection's activations
and weights rounded to float8 e4m3 (``reference/common.mm_fp8``). A control
run is a whole run of the cell (set-up, a window at the cell's own load,
the check) in which the fp8 reference's answers replace the program's for
the invocations the check samples, so the harness's own comparison judges
them; its ``correct`` has to come out false. For each seed it prints the
run's checks:

    python3 bench_port/control.py --workload falcon7b.longtail --seeds 1,2,3

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench_port import harness  # noqa: E402
from bench_port.reference import common  # noqa: E402


def fp8_answers(cell: harness.Cell, seed: int, chosen, device) -> dict:
    """The fp8 reference's answers to the invocations the check chose."""
    return harness.reference_answers(cell, seed, chosen, device, common.mm_fp8)


def run(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """One control run of ``cell``: the result line's object."""
    return harness.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                            substitute=fp8_answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    for s in args.seeds.split(","):
        r = run(cell, int(s), args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "correct": r["correct"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
