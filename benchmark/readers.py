"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``).

Each function takes the :class:`~benchmark.harness.Run` of a traced run
and returns the metric's value, or None where the run holds nothing to
read (no device trace, no launch of the port's kernels, or launches that
the cell's shapes do not account for). None leaves the metric out of the
result's line; a share is never reported as 0 for want of a reading.
"""

from __future__ import annotations

from typing import Optional

from benchmark import roofline as rl


def mfu_train(run) -> Optional[float]:
    """Model FLOPs of the window's steps over its time, as a share of
    the peak of the model's dtype."""
    win, shape = run.window, run.shape
    if not win["units"]:
        return None
    flops = sum(rl.train_step_flops(shape, u["b"], u["s"])
                for u in win["units"])
    return 100.0 * flops / win["elapsed"] / rl.PEAK_FLOPS[shape.dtype]


def mfu_generate(run) -> Optional[float]:
    """The least time the chip's peaks allow for every call of the
    window (each forward held to the larger of its FLOPs over the peak
    and its bytes over HBM), as a share of the window's time."""
    win, shape = run.window, run.shape
    if not win["units"]:
        return None
    need = sum(rl.generate_call_min_s(shape, u["b"], u["p"], u["new"],
                                      shape.dtype) for u in win["units"])
    return 100.0 * need / win["elapsed"]


def idle_share(run) -> Optional[float]:
    """1 - busy / wall of the traced segment."""
    seg = run.trace
    if not seg or seg["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])


def launches_per_unit(run) -> Optional[float]:
    """Device kernels per unit (step or call) of the traced segment."""
    seg = run.trace
    if not seg or not seg["kernels"]:
        return None
    return seg["kernels"] / len(seg["units"])


def _unit_bounds(shape, u: dict) -> Optional[float]:
    """Σ of the least times of the port's kernel launches in one unit,
    each from the shapes of its unit; None for a launch they do not
    account for."""
    n = u["launches"]
    dt, hd = shape.dtype, shape.head_dim
    h, kvh = shape.n_heads, shape.n_kv_heads
    if "s" in u:                                     # a train step
        rows = u["b"] * u["s"]
        bwd = rl.flash_bwd_bounds_s(u["b"], h, kvh, u["s"], hd, True, dt)
        return (n.get("rmsnorm_fwd", 0) * rl.rmsnorm_fwd_bound_s(
                    rows, shape.d_model, dt)
                + n.get("rmsnorm_bwd", 0) * rl.rmsnorm_bwd_bound_s(
                    rows, shape.d_model, dt)
                + n.get("flash_fwd", 0) * rl.flash_fwd_bound_s(
                    u["b"], h, kvh, u["s"], hd, True, dt)
                + n.get("flash_bwd_dkv", 0) * bwd["flash_bwd_dkv"]
                + n.get("flash_bwd_dq", 0) * bwd["flash_bwd_dq"])
    # A generate call: the prefill and new - 1 one-token steps, each
    # forward with the same norms; attention's kernel in the prefill only.
    b, p, new = u["b"], u["p"], u["new"]
    if any(n.get(k, 0) for k in ("rmsnorm_bwd", "flash_bwd_dkv",
                                 "flash_bwd_dq")):
        return None
    norms = n.get("rmsnorm_fwd", 0)
    if norms % new:
        return None
    per = norms // new
    return (per * (rl.rmsnorm_fwd_bound_s(b * p, shape.d_model, dt)
                   + (new - 1) * rl.rmsnorm_fwd_bound_s(b, shape.d_model, dt))
            + n.get("flash_fwd", 0) * rl.flash_fwd_bound_s(b, h, kvh, p, hd,
                                                           True, dt))


def kernels_roofline(run) -> Optional[float]:
    """Σ least time / Σ device time over every launch of the port's own
    kernels in the traced segment, the kernels matched by symbol."""
    seg = run.trace
    if not seg:
        return None
    spent = sum(v[0] for name, v in seg["ops"].items()
                if rl.kernel_of(name))
    bounds = [_unit_bounds(run.shape, u) for u in seg["units"]]
    if spent <= 0 or any(b is None for b in bounds) or not sum(bounds):
        return None
    return 100.0 * sum(bounds) / spent
