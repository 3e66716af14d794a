"""Run one cell of the port's benchmark on this machine's card.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``. Prints progress and the compared numbers on standard
error, and as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits 3 without a result when no CUDA
card is visible, and 4 when the process holds JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernels' build directory is the checkout's build/ (kernels/build.py);
# any other cache of torch's stays inside the checkout too
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench_port import guard, harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("no CUDA card is visible: nothing measured", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              T_START)
    found = guard.forbidden(sys.modules)
    if found:
        print(f"the process holds {found}: the run may not load JAX or the JAX "
              "package", file=sys.stderr)
        return 4
    for name, v in result["checks"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
