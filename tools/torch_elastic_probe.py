#!/usr/bin/env python3
"""How path (f)'s recovery goes over repeated kills, on one card.

    python3 tools/torch_elastic_probe.py [--late 0,0,45]

Runs ``chip_smoke.py``'s path (f) flow once per entry of ``--late``:
llama3-1b bf16 two-slice data-parallel training (``examples/
two_slice_dp_torch.py`` at path (d)'s shape) under the port's
coordinator, every step checkpointed, rank 1 SIGKILLed in its 2nd sync
call and started again. An entry above 0 makes rank 0 enter that sync
call so many seconds late, so that its failed step meets a peer that
died before it posted.

Prints one JSON line per kill, then the card's name and power limit:
rank 0's failure (its postmortem's error), the seconds from the kill to
rank 0's resume, rank 0's rebuild and restore ms, the restarted rank's
rendezvous attempts and seconds from its start to its world, whether
every step's digests agree on both ranks, the kill's seconds in all,
and the stacks of every thread of a resuming rank, dumped every 30 s
while its trainer resumes (``faulthandler``; a resume shorter than 30 s
leaves only its start and end). Exits 1 if a kill did not recover.

Needs a CUDA card; runs from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from rocnrdma_tpu_torch.models import llama  # noqa: E402
from rocnrdma_tpu_torch.ops import _native  # noqa: E402


def one_kill(late_s: float) -> dict:
    ckpt = 3 * cs.grad_bytes(llama.LLAMA3_1B)
    root, _free = cs.checkpoint_root(2 * 2 * ckpt + (1 << 30))
    coord, addr = cs.start_coordinator()
    t0 = time.monotonic()
    try:
        outs, dead, started = cs.run_elastic(
            addr, root, late_s,
            env={"TDR_RESUME_STACKS": str(Path(root, "stacks"))})
        errors = [json.loads(f.read_text()).get("error") for f in sorted(
            Path(root, "postmortem").glob("*/incident-g*/rank0.json"))]
        stacks = [f.read_text() for f in sorted(Path(root).glob("stacks.*"))]
    finally:
        cs.stop(coord)
        shutil.rmtree(root, ignore_errors=True)
    r0, r1a, r1b = (cs.rank_lines(t) for t in outs)
    killed = next(ln["killed_monotonic"] for ln in r1a
                  if "killed_monotonic" in ln)
    resumed = next(ln for ln in r0 if ln.get("resumes"))
    first1 = next(ln for ln in r1b if "ready_monotonic" in ln)
    digests = {}
    for ln in r0 + r1a + r1b:
        if "digest" in ln:
            digests.setdefault(ln["step"], set()).add(ln["digest"])
    return {"late_s": late_s, "rank0_error": errors,
            "kill_to_resume_s": resumed["resume_monotonic"][0] - killed,
            "rebuild_ms": resumed["rebuild_ms"],
            "restore_ms": resumed["restore_ms"],
            "rank1_seen_dead_s": dead - killed,
            "rank1_rendezvous_attempts": first1["rendezvous_attempts"],
            "rank1_start_to_world_s": first1["world_ready_monotonic"]
            - started,
            "digests_equal_every_step": all(len(d) == 1
                                            for d in digests.values()),
            "kill_s": time.monotonic() - t0, "resume_stacks": stacks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--late", default="0,0,45",
                    help="rank 0's delay in seconds, one kill per entry")
    args = ap.parse_args()
    _native.build()
    ok = True
    for late in (float(x) for x in args.late.split(",")):
        try:
            res = one_kill(late)
        except Exception as e:  # a kill that did not recover
            res = {"late_s": late, "error": str(e)[-6000:]}
        ok = ok and res.get("digests_equal_every_step", False)
        print(json.dumps(res), flush=True)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
