"""The numbers that decide ``correct``, each against the limit of its
cell (``benchmark/limits/<cell>.json``).

Training: ``loss_gap``, the largest gap between the program's loss and
the reference's over the checked steps, in nats (read, and held to no
limit: no control or planted fault reads far enough above sound runs
to set one); ``grad_gap``, the worst
weight's gap between the program's first-step gradient norm and the
reference's; ``update_gap``, the worst weight's gap between the norms of
the change over the checked steps. A weight's gap is taken against the
larger of the reference's norm of that weight and of the median weight,
since some gradients are all but zero. Weights whose reference gradient
is under a thousandth of the median weight's are left out of
``update_gap``: AdamW moves them by round-off alone.

Serving: ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> float:
    names = list(want if keep is None else keep)
    med = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in names)


def train_numbers(prog: Dict[str, object],
                  ref: Dict[str, object]) -> Dict[str, float]:
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moved = [k for k, g in grads.items() if g >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                   ref["losses"])),
        "grad_gap": worst_leaf(prog["grad_norms"], grads),
        "update_gap": worst_leaf(prog["change"], ref["change"], moved),
    }


def served_numbers(gaps: Iterable[float]) -> Dict[str, float]:
    return {"logit_gap": max(gaps)}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float,
                                                               float]]]:
    """Whether every limited number is finite and within its limit, and
    the (name, number, limit) of each, in the limits' order. A limit
    with no number fails; a number with no limit is a reading, and is
    not judged."""
    rows = [(k, float(numbers.get(k, math.nan)), float(v))
            for k, v in limits.items()]
    ok = all(math.isfinite(x) and x <= lim for _, x, lim in rows)
    return ok, rows
