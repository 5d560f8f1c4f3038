#!/usr/bin/env python3
"""Where the two-slice sync of the PyTorch port spends its time, on one
card: the ring alone by message size, and the llama3-1b data-parallel
step in each sync mode with the flight recorder on.

    python3 tools/torch_sync_probe.py [--repeats 2] [--sizes 4M,64M,1G]

Prints one JSON line per measurement, then the card's name and power
limit:

- ``ring``: ``rocnrdma_tpu_torch/tools/allreduce.py`` at world 2 in
  bf16, 5 iterations per run, for every size as two rank processes
  (their emu link negotiates as ``chip_smoke.py``'s path (d) does) and
  as two threads of one process, ``--repeats`` times in turns; the
  cross-process 64 MiB case also with ``TDR_TELEMETRY=1``, in turns
  with a run without, to size the recorder's cost;
- ``step``: ``examples/two_slice_dp_torch.py`` at path (d)'s shape
  (llama3-1b bf16, remat, batch 2 x seq 2048 per rank, one batch, emu
  engine), one warm step and 2 timed ones, with the recorder on, for
  the fused sync at the default 16 MiB staging chunk, the fused sync at
  a 256 MiB chunk (``TDR_STAGE_CHUNK``), the bucketed sync
  (``--overlap``) and the per-layer sync: per rank the mean step /
  grads / sync ms, the ring's time per step by native event
  (``telemetry.ring_phase_split``), the number of collectives per step
  and the overlap fractions.

Needs a CUDA card; runs from the root of a checkout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

ITERS = 5   # allreduce iterations per ring run
STEPS = 3   # train steps per sync mode, the first one warm


def step_means(ranks) -> list:
    out = []
    for lines in ranks:
        timed = [ln for ln in lines if ln.get("step", 0) > 1]
        tel = next(ln for ln in lines if "final_digest" in ln)
        tel = tel["telemetry_timed_steps"]
        n = len(timed)
        out.append({
            **{k: sum(ln[k] for ln in timed) / n
               for k in ("step_ms", "grads_ms", "sync_ms", "ring_ms")},
            "ring_split_ms_per_step": {k: v / n for k, v in
                                       tel["ring_split_ms"].items()},
            "collectives_per_step": tel["collectives"] / n,
            "overlap_fraction": tel["overlap_fraction"],
            "compute_overlap_fraction": tel["compute_overlap_fraction"],
            "telemetry_dropped": tel["telemetry_dropped"],
            "digests": [ln["digest"] for ln in lines if "digest" in ln]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--sizes", default="4M,16M,64M,256M,1G")
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        raise SystemExit("torch_sync_probe.py needs a CUDA card")
    for rep in range(args.repeats):
        for size in args.sizes.split(","):
            tool_args = ["--bytes", size, "--dtype", "bfloat16",
                         "--iters", str(ITERS)]
            rec, procs_tier = cs.allreduce_tool(tool_args)
            threads, threads_tier = cs.ring_threads(size, ITERS)
            cs.emit({"ring": size, "repeat": rep, "iters": ITERS,
                     "processes_bus_GBps": rec["bus_GBps"],
                     "processes_link_tier": procs_tier,
                     "threads_bus_GBps": threads,
                     "threads_link_tier": threads_tier})
        for tel in ("0", "1"):
            rec, tier = cs.allreduce_tool(
                ["--bytes", "64M", "--dtype", "bfloat16",
                 "--iters", str(ITERS)], env={"TDR_TELEMETRY": tel})
            cs.emit({"ring": "64M", "repeat": rep, "telemetry": tel,
                     "processes_bus_GBps": rec["bus_GBps"],
                     "processes_link_tier": tier})
    env = {"TDR_TELEMETRY": "1", "TDR_TELEMETRY_RING": str(1 << 21)}
    for label, extra, more in (("fused_16M", [], {}),
                               ("fused_256M", [],
                                {"TDR_STAGE_CHUNK": str(256 << 20)}),
                               ("overlap", ["--overlap"], {}),
                               ("per_layer", ["--per-layer"], {})):
        ranks = cs.run_two_slice(extra, STEPS, {**env, **more})
        cs.emit({"step": label, "steps": STEPS,
                 "by_rank": step_means(ranks)})
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
