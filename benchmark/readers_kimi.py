"""Readers of the Kimi Linear cells (``metrics/<name>.decode-hybrid.py``),
on the arithmetic of :mod:`benchmark.roofline_kimi`.

Each takes the :class:`~benchmark.harness.Run` of a traced run and
returns the metric's value, or None where the run holds nothing to read
(no device trace, no launch of the kernel, launches that the cell's
shapes do not account for, or a program without the span). The sizes
come from the cell's configuration file, found by the run's name.
"""

from __future__ import annotations

from typing import Optional

from benchmark import roofline_kimi as rl
from benchmark.readers_mla import _config, _spent


def _kda_layers(cfg: dict) -> int:
    return len(cfg["linear_attn_config"]["kda_layers"])


def mfu_generate(run) -> Optional[float]:
    """The least time the chip's peaks allow for every call of the
    window (:func:`roofline_kimi.generate_call_min_s`), as a share of the
    window's time."""
    win = run.window
    if not win["units"]:
        return None
    cfg = _config(run)
    need = sum(rl.generate_call_min_s(cfg, u["b"], u["p"], u["new"],
                                      run.shape.dtype) for u in win["units"])
    return 100.0 * need / win["elapsed"]


def kda_roofline(run) -> Optional[float]:
    """K9's Σ least time over its launches / Σ device time of its symbol
    in the traced segment. A call launches it once a KDA layer in each of
    its ``new - 1`` decode steps (b sequences, one token) and once a KDA
    layer and row chunk of its prefill, which covers b sequences of p
    tokens in equal chunks of rows (the bound is linear in the rows);
    other counts are not accounted for."""
    seg = run.trace
    if not seg:
        return None
    cfg = _config(run)
    layers, dt, need = _kda_layers(cfg), run.shape.dtype, 0.0
    for u in seg["units"]:
        n = u["launches"].get("kda_recurrent", 0)
        chunks, rest = divmod(n - layers * (u["new"] - 1), layers)
        if rest or chunks < 1:
            return None
        need += layers * ((u["new"] - 1) * rl.kda_bound_s(cfg, u["b"], 1, dt)
                          + rl.kda_bound_s(cfg, u["b"], u["p"], dt))
    spent = _spent(run, rl.KDA_RECURRENT)
    return 100.0 * need / spent if spent > 0 and need > 0 else None


def mla_decode_roofline(run) -> Optional[float]:
    """K7's Σ least time over its launches / Σ device time of its
    symbols in the traced segment. A call launches it once an MLA layer in
    each of its ``new - 1`` decode steps, step j over ``p + j`` live
    positions; other counts are not accounted for."""
    seg = run.trace
    if not seg:
        return None
    cfg = _config(run)
    layers = cfg["num_hidden_layers"] - _kda_layers(cfg)
    need = 0.0
    for u in seg["units"]:
        if u["launches"].get("mla_decode", 0) != layers * (u["new"] - 1):
            return None
        need += layers * sum(
            rl.mla_decode_bound_s(cfg, u["b"], u["p"] + j, run.shape.dtype)
            for j in range(1, u["new"]))
    spent = _spent(run, rl.MLA_DECODE)
    return 100.0 * need / spent if spent > 0 and need > 0 else None


def moe_roofline(run) -> Optional[float]:
    """The grouped GEMMs' Σ least time (:func:`roofline_kimi.
    moe_gemm_bounds_s`) / Σ device time of their symbols in the traced
    segment. Each expert layer of a decode step launches each kernel once
    over the call's b tokens on the few-row instance; the rest of a
    unit's launches are the prefill's, b·p tokens a layer on the many-row
    instance. The rows and touched experts of each instance are the
    program's device counters (``moe_rows_<few|many>``,
    ``moe_experts_<few|many>``); a program without them reads None."""
    seg = run.trace
    if not seg:
        return None
    cfg = _config(run)
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    dt, need = run.shape.dtype, 0.0
    for u in seg["units"]:
        n = u["launches"]
        ups, downs = n.get("moe_gemm_up", 0), n.get("moe_gemm_down", 0)
        decode = moe_layers * (u["new"] - 1)
        chunks, rest = divmod(ups - decode, moe_layers)
        if ups != downs or rest or chunks < 1:
            return None
        if n.get("moe_gemm_many", 0) != 2 * chunks * moe_layers:
            return None
        few = (n.get("moe_rows_few", 0), n.get("moe_experts_few", 0))
        many = (n.get("moe_rows_many", 0), n.get("moe_experts_many", 0))
        if not (all(few) and all(many)):
            return None
        need += sum(rl.moe_gemm_bounds_s(cfg, decode * u["b"], *few, dt))
        need += sum(rl.moe_gemm_bounds_s(cfg, moe_layers * u["b"] * u["p"],
                                         *many, dt))
    spent = _spent(run, rl.MOE_GEMM)
    return 100.0 * need / spent if spent > 0 and need > 0 else None


def kda_ms(run) -> Optional[float]:
    """Device ms a call of the KDA mixers in its prefill: Σ ``dev_s`` of
    the program's ``kda.mix`` spans (the eager prefill's; the decode
    step's replays record none) over the segment's calls."""
    from benchmark.spans import _timed

    units = run.trace["units"] if run.trace else []
    spans = _timed("kda.mix")
    if not units or not spans:
        return None
    return 1e3 * sum(f["dev_s"] for f in spans) / len(units)
