"""One run of one cell of the port's benchmark.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``rocnrdma_tpu_torch``)
and ``BENCHMARK.json``. It runs on the machine it is started on, on as
many cards as the cell asks for, and exits with code 2 and no result
where CUDA or those cards are missing. It prints the numbers that decide
``correct`` as the last lines of standard error and one JSON object as
the last line of standard output; see ``harness.py`` for the run and
``BENCHMARK.json`` for the cells and metrics.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel caches at fixed paths inside the checkout, set before torch is
# imported (the port's own nvcc builds go to rocnrdma_tpu_torch/_build/).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number of 0 or more")

    from benchmark import harness

    bench = harness.Bench()
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), T0, "cuda", chips)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
