"""Readings from which a cell's limits are set (not run by the
benchmark's own runs).

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 2 --seconds 2 [--out readings.jsonl]

For each seed, in one process, a run of the cell as ``run.py`` makes it
(:func:`benchmark.harness.run_cell`) with a short window at the cell's
own load; on the first ``--control-seeds`` seeds its check also reads
the control (the reference in fp8 in the program's place) and the
planted faults beside the program (``Driver.control``). One JSON line
per seed: the result, with ``run_s``, the time of the whole run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from benchmark import harness

    bench = harness.Bench()
    out = open(args.out, "a") if args.out else None
    t0 = T0
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, t0, "cuda",
                               control=j < args.control_seeds)
        rec = dict(res, workload=args.workload, seed=seed,
                   run_s=time.perf_counter() - t0)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
    found = harness.forbidden_modules()
    if found:
        print(f"refused: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
