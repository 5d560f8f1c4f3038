"""The expert layer's routing and its grouped SwiGLU: three hand-written
CUDA kernels (the grouped GEMMs and the combine) and their plain version.

No Pallas kernel stands behind them: the JAX package has no experts.
:func:`route` is DeepSeek-V3's ``noaux_tc`` selection with one group:
sigmoid scores in f32, the ``top_k`` of score + correction bias picked,
the picked scores normalised and scaled. :func:`grouped_swiglu` computes
every pick, none dropped: ``Σ_j w_j · SwiGLU_{e_j}(x)`` per token, and
adds the shared experts' output where the caller gives it.

On the card, with no host synchronisation (so the decode step captures
as a CUDA graph):

1. :func:`align` lays the picks out by expert, each expert's rows padded
   to a multiple of the block's rows ``BM``, in a buffer of a size fixed
   by the shapes alone (``rows + experts · (BM - 1)``, rounded up);
2. ``moe_gemm_up`` (``csrc/moe_gemm_up.cu``) takes, for each block of
   ``BM`` rows of one expert and a block of output columns, the rows'
   tokens' x against that expert's gate and up columns, and writes
   ``silu(gate) · up`` rounded to the model dtype;
3. ``moe_gemm_down`` (``csrc/moe_gemm_down.cu``) multiplies those rows by
   the expert's down projection and scales each row by its routing
   weight (f32, rounded once to the model dtype);
4. ``moe_combine`` (K8, ``csrc/moe_combine.cu``, :func:`combine`) sums
   each token's ``top_k`` rows in f32, in pick order, rounds once, and
   adds the shared experts' row as torch adds two bf16 tensors: one pass
   and one launch, bitwise :func:`combine_reference`'s gathers and f32
   adds.

Bound on H100: in a decode step (64 tokens, 6 picks, ~6 rows an expert)
bytes, every expert's weights read once; in a prefill chunk (~6,000 rows
an expert) operations. Two instances meet each: 16 rows a block on
mma.sync (``csrc/moe_gemm.cuh``) and 128 rows a block on TMA and wgmma,
persistent and warp-specialised (``csrc/moe_gemm_tc.cuh``).

:func:`grouped_swiglu` dispatches on the device: CUDA tensors launch the
kernels, CPU tensors run :func:`grouped_swiglu_reference`, a plain loop
over the experts with the same roundings; any other device raises, and
so does a shape or dtype the kernels do not take (there is no fallback).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _native

__all__ = ["route", "align", "count_held", "grouped_swiglu",
           "grouped_swiglu_reference", "block_rows", "gemm_up", "gemm_down",
           "combine", "combine_reference"]


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, d), router (d, E), bias (E,) f32 → the picked experts (N,
    top_k) int64 and their weights (N, top_k) f32: ``s = sigmoid(x ·
    router)`` in f32, picks ``top_k(s + bias)``, weights ``s`` of the
    picks over their sum, times ``scale``. The bias moves the picks, not
    the weights."""
    s = torch.sigmoid(x.float() @ router.float())
    ids = torch.topk(s + bias, top_k, dim=-1).indices
    w = s.gather(1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def grouped_swiglu_reference(x: torch.Tensor, ids: torch.Tensor,
                             wts: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, w_down: torch.Tensor,
                             add: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The plain version: a loop over the experts, each taking the
    tokens that picked it. Products in f32; ``silu(gate) · up`` rounded
    to x's dtype, each pick's weighted output rounded to x's dtype, the
    picks summed in f32 in pick order and rounded once, as the kernels
    round; then ``add``, if given, added in x's dtype."""
    n, k = ids.shape
    picks = torch.zeros(n, k, x.shape[1], dtype=x.dtype, device=x.device)
    for e in range(w_gate.shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok].float()
        h = (F.silu(xe @ w_gate[e].float()) * (xe @ w_up[e].float())
             ).to(x.dtype)
        o = (h.float() @ w_down[e].float()) * wts[tok, slot, None]
        picks[tok, slot] = o.to(x.dtype)
    acc = picks[:, 0].float()
    for j in range(1, k):
        acc = acc + picks[:, j].float()
    routed = acc.to(x.dtype)
    return routed if add is None else routed + add


# Rows a block of the kernels holds, for few rows an expert (a decode
# step: each expert's weights read by one block of rows) and for many (a
# prefill chunk: 128 x 256 wgmma tiles). The tiles themselves are the CUDA
# sources' (``Few``; ``moe_gemm_tc.cuh``'s ``kBM``, ``kBN``).
FEW_ROWS, MANY_ROWS = 16, 128
# The widths the kernels take: the model width d a multiple of 256 (the
# many-row down kernel's 256 columns), the expert width f of 128 (its up
# kernel's 128 gate and 128 up columns).
D_MULTIPLE, F_MULTIPLE = 256, 128
# The picks a token the combine takes (``csrc/moe_combine.cu``'s
# ``kMaxPicks``: one instance for each count).
MAX_PICKS = 8


def block_rows(rows: int, n_experts: int) -> int:
    """The kernels' rows a block for ``rows`` picks over ``n_experts``:
    16 for up to 32 an expert on average (a decode step), else 128."""
    return FEW_ROWS if rows <= 32 * n_experts else MANY_ROWS


def align(ids: torch.Tensor, n_experts: int, bm: int):
    """The picks (N, k) laid out by expert, on the device with no host
    synchronisation: ``dest`` (N, k), each pick's padded row;
    ``row_slot`` (cap,) int32, each padded row's pick (token · k + j),
    ``N · k`` for a padding row; ``block_expert`` (cap / bm,) int32, the
    expert of each block of ``bm`` rows, ``n_experts`` past the last.
    ``cap = N·k + n_experts·(bm - 1)`` rounded up to ``bm``, a size fixed
    by the shapes. A pick of id -1 (an expert another card holds) takes
    no row: its ``dest`` is -1 and no padded row names it."""
    flat = ids.reshape(-1)
    rows = flat.numel()
    dev = ids.device
    experts = torch.arange(n_experts, device=dev)
    # (E, rows): a scan along the innermost dimension, which the card
    # runs at memory speed (a scan along the outer one does not).
    onehot = (experts[:, None] == flat[None, :]).to(torch.int32)
    seen = onehot.cumsum(1, dtype=torch.int32)
    other = flat < 0
    at = flat.clamp(min=0)
    counts = seen[:, -1]
    padded = (counts + bm - 1) // bm * bm
    ends = padded.cumsum(0)
    # A pick's row: its expert's first row plus the picks of that expert
    # before it (seen counts itself); -1 for another card's pick.
    dest = ((ends - padded - 1)[at] + seen.gather(0, at[None, :])[0]
            ).masked_fill_(other, -1)
    cap = -(-(rows + n_experts * (bm - 1)) // bm) * bm
    # Indexing wraps a -1 to the spare slot past the end, which is cut off.
    row_slot = torch.full((cap + 1,), rows, dtype=torch.int32, device=dev)
    row_slot[dest] = torch.arange(rows, dtype=torch.int32, device=dev)
    block_expert = torch.searchsorted(
        ends, torch.arange(0, cap, bm, device=dev), right=True)
    return dest.view(ids.shape), row_slot[:cap], block_expert.to(torch.int32)


def count_held(ids: torch.Tensor, n_experts: int) -> None:
    """Add the picks of ``ids`` (N, k) that this card holds (id ≥ 0) and
    the held experts they touch to the device counters of the G1
    instance that computes them (``moe_rows_<few|many>``,
    ``moe_experts_<few|many>``, by :func:`block_rows`), which the
    benchmark's yardstick of the held experts reads. No synchronisation,
    so a graph replay counts too."""
    kind = ("few" if block_rows(ids.numel(), n_experts) == FEW_ROWS
            else "many")
    flat = ids.reshape(-1)
    _native.count_on_device(f"moe_rows_{kind}", (flat >= 0).sum())
    # Another card's -1 lands past the held experts.
    hit = torch.zeros(n_experts + 1, dtype=torch.int64, device=ids.device)
    hit.index_fill_(0, flat.remainder(n_experts + 1), 1)
    _native.count_on_device(f"moe_experts_{kind}", hit[:n_experts].sum())


def _check(x, ids, wts, w_gate, w_up, w_down, add=None) -> None:
    e, d, f = w_gate.shape
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} does not match the experts' "
                         f"input width {d}")
    if w_up.shape != (e, d, f) or w_down.shape != (e, f, d):
        raise ValueError(f"expert weights {tuple(w_gate.shape)}/"
                         f"{tuple(w_up.shape)}/{tuple(w_down.shape)} do not "
                         "stack as (E, d, f), (E, d, f), (E, f, d)")
    if ids.shape != wts.shape or ids.shape[0] != x.shape[0]:
        raise ValueError(f"picks {tuple(ids.shape)} and weights "
                         f"{tuple(wts.shape)} do not match x's rows")
    if x.dtype != torch.bfloat16 or any(
            w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"grouped GEMM kernels take bfloat16, got {x.dtype} "
                        f"and {w_gate.dtype}")
    if add is not None and (add.shape != x.shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError(f"add {tuple(add.shape)} {add.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    if ids.shape[1] > MAX_PICKS:
        raise ValueError(f"the combine takes at most {MAX_PICKS} picks a "
                         f"token, got {ids.shape[1]}")
    if d % D_MULTIPLE or f % F_MULTIPLE:
        raise ValueError(f"grouped GEMM kernels take a model width that is "
                         f"a multiple of {D_MULTIPLE} and an expert width "
                         f"that is a multiple of {F_MULTIPLE}, got {d} and "
                         f"{f}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"grouped GEMM kernels read {name} in 16-byte "
                             f"vectors: its rows must be unit-stride, "
                             f"16-byte aligned and 16-byte apart; got "
                             f"strides {t.stride()}")


def gemm_up(x, row_slot, block_expert, top_k, w_gate, w_up, h) -> None:
    """The gate and up GEMM over :func:`align`'s layout into ``h`` (cap,
    f): ``silu(x[tok] · w_gate[e]) · (x[tok] · w_up[e])`` for each padded
    row, zeros for a padding row. One launch of ``moe_gemm_up``, and of
    the many-row instance where ``h``'s rows are laid out in its blocks."""
    e, d, f = w_gate.shape
    cap = row_slot.numel()
    bm = cap // block_expert.numel()
    _native.count("moe_gemm_up")
    if bm == MANY_ROWS:
        _native.count("moe_gemm_many")
    rc = _native.library("moe_gemm_up").moe_gemm_up(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(),
        row_slot.data_ptr(), block_expert.data_ptr(), x.shape[0] * top_k,
        top_k, e, cap, d, f, bm, x.stride(0), w_gate.stride(0),
        w_gate.stride(1), h.stride(0), _native.stream_handle(x.device))
    _native.check("moe_gemm_up", rc)


def gemm_down(h, block_expert, row_w, w_down, out) -> None:
    """The down GEMM into ``out`` (cap, d): ``row_w[r] · (h[r] ·
    w_down[e])`` for each padded row. One launch of ``moe_gemm_down``, and
    of the many-row instance where the rows are laid out in its blocks."""
    e, f, d = w_down.shape
    cap = h.shape[0]
    bm = cap // block_expert.numel()
    _native.count("moe_gemm_down")
    if bm == MANY_ROWS:
        _native.count("moe_gemm_many")
    rc = _native.library("moe_gemm_down").moe_gemm_down(
        h.data_ptr(), w_down.data_ptr(), out.data_ptr(), row_w.data_ptr(),
        block_expert.data_ptr(), e, cap, f, d, bm, h.stride(0),
        w_down.stride(0), w_down.stride(1), out.stride(0),
        _native.stream_handle(h.device))
    _native.check("moe_gemm_down", rc)


def combine_reference(out: torch.Tensor, dest: torch.Tensor,
                      add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain combine: each token's rows ``out[dest[t, j]]`` gathered,
    widened to f32 and summed in pick order, rounded once to out's dtype
    (a pick of ``dest`` -1, another card's expert, reads as zeros); then
    ``add``, if given, added in out's dtype."""
    def row(j):
        rows = out.index_select(0, dest[:, j].clamp(min=0)).float()
        return rows.masked_fill(dest[:, j, None] < 0, 0.0)

    acc = row(0)
    for j in range(1, dest.shape[1]):
        acc += row(j)
    routed = acc.to(out.dtype)
    return routed if add is None else routed + add


def combine(out: torch.Tensor, dest: torch.Tensor,
            add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 over the down GEMM's rows ``out`` (cap, d) and :func:`align`'s
    ``dest`` (N, k), -1 for no row: (N, d), bitwise
    :func:`combine_reference`. One launch
    of ``moe_combine`` on CUDA tensors; CPU tensors run the plain
    version."""
    if _native.device_type(out, "moe combine") == "cpu":
        return combine_reference(out, dest, add)
    n, k = dest.shape
    d = out.shape[1]
    if add is not None:
        add = add.contiguous()
    res = torch.empty((n, d), dtype=out.dtype, device=out.device)
    _native.count("moe_combine")
    rc = _native.library("moe_combine").moe_combine(
        out.data_ptr(), dest.contiguous().data_ptr(),
        None if add is None else add.data_ptr(), res.data_ptr(), n, k, d,
        out.stride(0), _native.stream_handle(out.device))
    _native.check("moe_combine", rc)
    return res


def _launch(x, ids, wts, w_gate, w_up, w_down, add) -> torch.Tensor:
    n, k = ids.shape
    e, d, f = w_gate.shape
    dest, row_slot, block_expert = align(ids, e, block_rows(n * k, e))
    cap = row_slot.numel()
    # Each padded row's routing weight, 0 for a padding row; another
    # card's pick (-1) writes the spare slot past the end.
    row_w = torch.zeros(cap + 1, dtype=torch.float32, device=x.device)
    row_w[dest.reshape(-1)] = wts.reshape(-1).float()
    row_w = row_w[:cap]
    h = torch.empty((cap, f), dtype=x.dtype, device=x.device)
    out = torch.empty((cap, d), dtype=x.dtype, device=x.device)
    gemm_up(x, row_slot, block_expert, k, w_gate, w_up, h)
    gemm_down(h, block_expert, row_w, w_down, out)
    return combine(out, dest, add)


def grouped_swiglu(x: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ_j wts[:, j] · SwiGLU_{ids[:, j]}(x)`` for x (N, d), the picks
    ``ids`` (N, k) and their f32 weights ``wts`` (N, k), over the experts'
    stacked weights w_gate, w_up (E, d, f) and w_down (E, f, d), plus
    ``add`` (N, d) if given (the shared experts' output), added after the
    sum's rounding. Returns (N, d) in x's dtype.

    A pick of id -1 is of an expert another card holds (the weights are
    this card's): it is computed nowhere here and adds nothing (no row in
    :func:`align`, the GEMMs or K8).

    CUDA tensors: :func:`align` and the three CUDA kernels. CPU tensors:
    :func:`grouped_swiglu_reference`."""
    if _native.device_type(x, "grouped swiglu") == "cpu":
        return grouped_swiglu_reference(x, ids, wts, w_gate, w_up, w_down,
                                        add)
    _check(x, ids, wts, w_gate, w_up, w_down, add)
    if x.shape[0] == 0:
        routed = torch.zeros_like(x)
        return routed if add is None else routed + add
    return _launch(x.contiguous(), ids, wts, w_gate, w_up, w_down, add)
