"""Cross-slice allreduce of a tree of torch tensors over the RDMA ring.

Counterpart of the fused path of ``rocnrdma_tpu/collectives/jax_shim.py``
(``CrossSliceAllReduce.__call__``): the data-parallel trainer averages
its gradients across slices through this shim, over a ``RingWorld`` on
the native engine. A tree is nested dicts (flattened in sorted-key
order), lists and tuples (in sequence) whose leaves are torch tensors or
numpy arrays — ``jax.tree_util``'s rule, so a tree shaped like the flax
parameter tree flattens in the JAX package's leaf order, and a torch
rank and a JAX rank agree on one schedule.

Data path per tree, in preference order (the JAX shim's three paths):

  1. **Exporter-owned host memory** (numpy arrays, or CPU tensors when
     the exporter owns memory rather than adopting it, as
     ``FakeHBMExporter`` does): pinned, registered over its dma-buf,
     adopted by the ring, and reduced in place, adjacent leaves
     coalesced into one ring op. Zero staged bytes.
  2. **Adopted CPU tensors** (with a ``CUDAExporter``): each contiguous
     CPU tensor is adopted, registered and reduced in place — zero
     staged bytes. The input tensors are consumed: after the call they
     hold the reduced value.
  3. **Staged groups**, one per dtype, for every other leaf — **CUDA
     tensors always**: the native ring folds on the host CPU, so device
     memory is copied into one pinned host tensor per dtype (registered
     with the ring once), reduced there, and copied back into the leaf
     in place, the mean taken in the leaf's own dtype. Every staged byte
     is charged to ``collectives.staging``.

Schedule order (the SPMD contract across ranks): coalesced path-1
regions (by VA), path-2 regions in tree order, then the staged groups
in first-occurrence dtype order. The schedule description hashed into
the digest ring-exchange is byte-identical to the JAX shim's for the
same tree (dtype names are numpy's: ``float32``, ``bfloat16``).

Overlap (the JAX shim's bucketed path): ``start(tree)`` gathers each
staged **bucket** (a segment of ``bucket_bytes``, by default the staged
path's ``TDR_STAGE_CHUNK``) into its ring-registered slice of the
pinned staging tensor — every bucket's D2H copy is enqueued up front,
one event each — and launches the bucket's ``allreduce_async`` the
moment its bytes have landed, so bucket k rides the wire while bucket
k+1 is gathered; ``finish()`` waits the handles in submission order and
writes each bucket back into its leaves. ``overlap=True`` routes the
plain call through ``start().finish()``. With ``TDR_WIRE_DTYPE=bf16``
or ``int8`` (or ``wire_dtype=``), float32 staged buckets ride the wire
compressed with per-rank error feedback, the arithmetic bitwise the
JAX shim's numpy formulas. ``per_layer=True`` adds
``start_layered(plan)``: the trainer pushes each layer bucket's
gradients from inside the backward (post-accumulate-grad hooks) and
``finish(tree)`` writes the reduced values back.

Every staged leaf is gathered before any write-back into a tensor that
occurs in the group again (tied leaves), so each occurrence contributes
its local value, as the JAX shim's fresh outputs do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.hbm.cuda import tensor_regions
from rocnrdma_tpu_torch.hbm.registry import (HbmError, MemoryExporter,
                                             RegistrationManager, as_ndarray)
from rocnrdma_tpu_torch.serving.stream import TransferEngine, stream_depth
from rocnrdma_tpu_torch.transport.engine import (ENGINE_VERBS, RED_SUM,
                                                 dtype_name, ring_chunk_bytes)
from rocnrdma_tpu_torch.utils.trace import trace

# Bound on cached zero-copy registrations (see the JAX shim).
_REG_CACHE_MAX = 128

# Adjacent exporter leaves merge across dead gaps up to this many bytes.
_COALESCE_GAP_MAX = 512

# Seconds a per-layer sync waits for a bucket that was never pushed.
_POST_WAIT_S = 600.0

# Stand-in leaf for a digest built from an abstract plan
# (``_sched_describe`` reads only the size of a staged leaf).
_SizeLeaf = namedtuple("_SizeLeaf", "size")

TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "int32": torch.int32, "int64": torch.int64,
                "bfloat16": torch.bfloat16, "uint8": torch.uint8,
                "int8": torch.int8}


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of ``tree`` in ``jax.tree_util`` order — dict keys sorted,
    lists and tuples in sequence, ``None`` an empty subtree — and the
    function that builds the same structure from a new leaf list."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        elif node is not None:
            leaves.append(node)

    walk(tree)

    def unflatten(new: List[Any]):
        it = iter(new)

        def build(node):
            if isinstance(node, dict):
                built = {k: build(node[k]) for k in sorted(node)}
                return {k: built[k] for k in node}
            if isinstance(node, (list, tuple)):
                items = [build(x) for x in node]
                if isinstance(node, list):
                    return items
                return (type(node)(*items) if hasattr(node, "_fields")
                        else tuple(items))
            return None if node is None else next(it)

        return build(tree)

    return leaves, unflatten


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)


def _storage_key(leaf) -> Optional[Tuple[str, int]]:
    """The memory a tensor leaf writes back into (None for a numpy leaf,
    which gets a fresh output)."""
    if not isinstance(leaf, torch.Tensor):
        return None
    return str(leaf.device), leaf.untyped_storage().data_ptr()


def _itemsize(dtype_str: str) -> int:
    return torch.empty((), dtype=TORCH_DTYPES[dtype_str]).element_size()


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A torch view of a host numpy array (bf16 arrays through their
    uint16 bits: torch cannot read ml_dtypes' bfloat16)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _span_tensor(va: int, count: int, dtype_str: str) -> torch.Tensor:
    """A CPU tensor viewing ``count`` elements of host memory at ``va``
    (the exporter owns the memory's lifetime)."""
    nbytes = count * _itemsize(dtype_str)
    buf = (ctypes.c_char * max(nbytes, 1)).from_address(va)
    return torch.frombuffer(buf, dtype=TORCH_DTYPES[dtype_str],
                            count=count)


class CrossSliceAllReduce:
    """Callable allreduce over trees of torch tensors (or numpy arrays).

    ``mean=True`` divides by the world size after the sum — the
    gradient averaging of the data-parallel trainer. All ranks must
    call with trees of identical structure, dtypes, shapes and
    residency (the SPMD contract of the JAX shim); the digest exchange
    before any ring op fails fast where they differ. A buffer appearing
    more than once in the tree (tied weights) reduces once on the
    in-place paths."""

    def __init__(self, world: RingWorld,
                 exporter: Optional[MemoryExporter] = None,
                 mean: bool = False, overlap: bool = False,
                 bucket_bytes: Optional[int] = None,
                 wire_dtype: Optional[str] = None,
                 per_layer: bool = False):
        self.world = world
        self.exporter = exporter
        self.mean = mean
        # per_layer implies overlap: the wire machinery is the bucketed
        # path's.
        self.per_layer = bool(per_layer)
        self.overlap = bool(overlap) or self.per_layer
        # None = the staged path's TDR_STAGE_CHUNK, so the default
        # overlap plan IS the fused plan (same segments, same digest).
        self.bucket_bytes = None if bucket_bytes is None else \
            int(bucket_bytes)
        wire = wire_dtype if wire_dtype is not None else \
            os.environ.get("TDR_WIRE_DTYPE", "")
        if wire in ("", "f32", "float32", None):
            wire = None
        elif wire not in ("bf16", "int8"):
            raise ValueError(f"TDR_WIRE_DTYPE={wire!r}: only 'bf16' or "
                             "'int8' (or unset) is supported")
        if wire and not self.overlap:
            raise ValueError(f"wire_dtype={wire} requires overlap=True "
                             "(compression rides the bucketed path)")
        self.wire_dtype = wire
        # Persistent per-dtype staging tensors, registered with the
        # ring once; pinned when a CUDA leaf stages through them.
        self._staging: Dict[str, torch.Tensor] = {}
        # Overlap-path state: per-dtype compressed wire tensors, f32
        # error-feedback residuals (host-only, never registered), and
        # the ring-registered bucket-slice VAs per staging key.
        self._wire_staging: Dict[str, torch.Tensor] = {}
        self._residuals: Dict[str, torch.Tensor] = {}
        self._slice_regs: Dict[str, Dict[int, int]] = {}
        # Zero-copy registration cache: (va, nbytes) -> Registration.
        self._regs: Dict[Tuple[int, int], Any] = {}
        self._regmgr: Optional[RegistrationManager] = None
        self._stage_ex: Optional[ThreadPoolExecutor] = None
        # The one FIFO worker that posts per-layer buckets (so the
        # autograd thread never blocks on the ring), and the copy
        # stream per device their D2H copies run on.
        self._post_ex: Optional[ThreadPoolExecutor] = None
        self._copy_streams: Dict[str, Any] = {}
        self._engine = TransferEngine(depth=0, name="xslice")
        self._step_token: Optional[int] = None
        # Host seconds of the last call's staged phases: the gather
        # (D2H into the pinned buffer), the ring allreduce, and the
        # scatter (H2D back into the leaves, synchronised). On the
        # overlap paths they are what the caller waits for: ``start``
        # (gather, compress, launch), ``finish``'s wait on the handles,
        # and its write-back.
        self.last_split: Dict[str, float] = {}

    # -------------------------------------------------- zero-copy path

    def _device_leaf(self, leaf) -> Optional[Tuple[int, int]]:
        """(va, nbytes) when ``leaf`` is host memory the exporter owns
        (path 1): a C-contiguous numpy array, or a contiguous CPU
        tensor when the exporter is not an adopting one (adopting
        exporters take CPU tensors on path 2)."""
        if self.exporter is None:
            return None
        if isinstance(leaf, np.ndarray):
            if not leaf.flags["C_CONTIGUOUS"] or leaf.nbytes == 0:
                return None
            va, nbytes = leaf.ctypes.data, leaf.nbytes
        elif (isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
              and getattr(self.exporter, "adopt_region", None) is None):
            if not leaf.is_contiguous() or leaf.numel() == 0:
                return None
            va, nbytes = leaf.data_ptr(), leaf.numel() * leaf.element_size()
        else:
            return None
        if self.exporter.is_device_address(va, nbytes):
            return va, nbytes
        return None

    def _ensure_registered(self, va: int, nbytes: int) -> None:
        """Front-load the pin + MR + ring adoption for a region (cached;
        repeat calls are dictionary hits)."""
        reg = self._regs.get((va, nbytes))
        if reg is not None and reg.ctx.revoked:
            # Owner freed the memory while registered: drop the dead
            # entry first, then unwind best-effort; re-registration
            # below fails in acquire, surfacing the lifetime bug.
            del self._regs[(va, nbytes)]
            try:
                self.world.ring.drop_buffer(va)
            except Exception:
                pass
            try:
                self._regmgr.deregister(reg)
            except HbmError:
                pass
            reg = None
        if reg is not None:
            return
        if self._regmgr is None:
            self._regmgr = RegistrationManager(self.world.engine,
                                               self.exporter)
        # A same-VA entry of another size is superseded right below.
        for key in [k for k in self._regs if k[0] == va and k[1] != nbytes]:
            self._drop_cached(key, forget_adoption=False)
        reg = self._regmgr.register(va, nbytes)  # dma-buf preferred
        self.world.ring.adopt_mr(va, reg.mr)
        self._regs[(va, nbytes)] = reg
        trace.event("xslice.zero_copy_reg", va=va, bytes=nbytes)

    def _drop_cached(self, key: Tuple[int, int],
                     forget_adoption: bool = True) -> None:
        """Tear down one cached registration (ring binding, MR, pin, and
        for adopting exporters the adoption record)."""
        reg = self._regs.pop(key)
        try:
            self.world.ring.drop_buffer(key[0])
        except Exception:
            pass
        try:
            self._regmgr.deregister(reg)
        except HbmError:
            pass
        forget = getattr(self.exporter, "forget", None)
        if forget_adoption and forget is not None:
            try:
                forget(key[0])
            except HbmError:
                pass  # another registration still pins the range

    def _evict_cache(self, used: set) -> None:
        over = len(self._regs) - _REG_CACHE_MAX
        if over <= 0:
            return
        for key in [k for k in self._regs if k not in used][:over]:
            self._drop_cached(key)
            trace.event("xslice.zero_copy_evict", va=key[0], bytes=key[1])

    def _tensor_leaf_regions(self, leaf):
        """[(va, nbytes, tensor)] for a tensor leaf reduced in place on
        path 2, or None (→ staged). Needs an adopting exporter
        (``CUDAExporter``); each region is adopted, holding the tensor
        until ``unhold``."""
        if self.exporter is None or not isinstance(leaf, torch.Tensor):
            return None
        adopt = getattr(self.exporter, "adopt_region", None)
        if adopt is None:
            return None
        regions = tensor_regions(leaf)
        if not regions:
            return None
        for va, nbytes, buf in regions:
            adopt(va, nbytes, owner=buf)
        return regions

    def _zero_copy(self, leaf, va: int, nbytes: int,
                   op: int = RED_SUM) -> None:
        """Allreduce a registered host region in place."""
        self._ensure_registered(va, nbytes)
        self.world.allreduce(leaf, op)
        self._apply_mean(leaf)

    def _coalesce(self, regions):
        """Merge adjacent same-dtype exporter regions (sorted by VA)
        into single ring ops: [(va, nbytes, leaf)] → [(va, nbytes,
        buffer_to_reduce)]. Gaps merge only where the exporter proves
        them dead."""
        regions = sorted(regions, key=lambda t: t[0])
        merged = []
        run = None  # [va, end, dtype name, leaves]
        for va, nbytes, leaf in regions:
            if run is not None and va < run[1]:
                raise HbmError(
                    f"overlapping device leaves at {va:#x} (in-place "
                    "reduction over overlapping regions is ill-defined)")
            gap = va - run[1] if run is not None else 0
            dt = dtype_name(leaf)
            if (run is not None and dt == run[2]
                    and (gap == 0
                         or (0 < gap <= _COALESCE_GAP_MAX
                             and self.exporter.is_gap_dead(run[1], va)))
                    and (va + nbytes - run[0]) % _itemsize(dt) == 0
                    and self.exporter.is_device_address(
                        run[0], va + nbytes - run[0])):
                run[1] = va + nbytes
                run[3].append(leaf)
            else:
                if run is not None:
                    merged.append(run)
                run = [va, va + nbytes, dt, [leaf]]
        if run is not None:
            merged.append(run)

        out = []
        for va, end, dt, leaves in merged:
            if len(leaves) == 1:
                leaf = leaves[0]
                out.append((va, end - va, leaf.view(-1)
                            if isinstance(leaf, torch.Tensor) else leaf))
            elif any(isinstance(x, torch.Tensor) for x in leaves):
                out.append((va, end - va,
                            _span_tensor(va, (end - va) // _itemsize(dt),
                                         dt)))
            else:
                out.append((va, end - va, as_ndarray(
                    va, ((end - va) // leaves[0].dtype.itemsize,),
                    leaves[0].dtype)))
        return out

    # ------------------------------------------------------- main path

    def __call__(self, tree):
        if self.overlap:
            # One code path: the plain call of an overlap shim is
            # start + finish (identical results).
            return self.start(tree).finish()
        with trace.span("xslice.sync", rank=self.world.rank):
            return self._sync(tree)

    def _sched_describe(self, leaves, coalesced, tensor_ops, groups,
                        schunk: int, wire: Optional[str]) -> str:
        """The SPMD schedule description every rank must agree on,
        hashed into the digest ``check_schedule`` exchanges. Term for
        term the JAX shim's, so a torch rank and a JAX rank with the
        same tree produce the same string."""
        wfb = int(
            getattr(self.world, "left_qp", None) is not None
            and self.world.left_qp.has_send_foldback
            and self.world.right_qp.has_send_foldback
            and os.environ.get("TDR_NO_WAVE_FB", "0") in ("", "0"))
        sched = [f"world={self.world.world}",
                 f"chunk={ring_chunk_bytes()}",
                 f"schunk={schunk}",
                 f"mean={int(self.mean)}", f"wfb={wfb}",
                 f"seal={getattr(self.world, 'seal_config', '')}"]
        chan = int(getattr(self.world, "channels", 1) or 1)
        if chan != 1:
            sched.append(f"chan={chan}")
        ctl_stamp = getattr(self.world, "control_stamp", "")
        if ctl_stamp:
            sched.append(ctl_stamp)
        topo_stamp = getattr(self.world, "topology_stamp", "")
        if topo_stamp:
            sched.append(topo_stamp)
        health_stamp = getattr(self.world, "health_stamp", "")
        if health_stamp:
            sched.append(health_stamp)
        dl_ms = os.environ.get("TDR_COLL_DEADLINE_MS", "")
        if dl_ms:
            try:
                dl = int(dl_ms)
            except ValueError:
                dl = 0
            if dl > 0:
                sched.append(f"dl={dl}")
        left_qp = getattr(self.world, "left_qp", None)
        if left_qp is not None and not left_qp.has_recv_reduce:
            sched.append("norr=1")
        sched += [f"z:{nbytes}:{dtype_name(arr)}"
                  for _, nbytes, arr in coalesced]
        sched += [f"j:{nbytes}:{dtype_name(buf)}"
                  for _, nbytes, buf in tensor_ops]
        # Per-leaf sizes, not just the sum.
        sched += [
            "s:{}:{}".format(d, ",".join(str(_numel(leaves[i]))
                                         for i in idxs))
            for d, idxs in groups.items()]
        if wire:
            sched.append(f"wire={wire}")
        if self._step_token is not None:
            sched.append(f"step:{self._step_token}")
        return " ".join(sched)

    def _classify(self, leaves):
        """Partition leaves into the op plan: coalesced path-1 regions,
        path-2 regions in tree order, staged groups keyed by dtype in
        first-occurrence order. Aliased buffers reduce once.
        Classifying adopts path-2 tensors (held until unhold) — callers
        own the cleanup on failure."""
        staged_idx: List[int] = []
        dev_regions: List[Tuple[int, int, Any]] = []
        tensor_ops: List[Tuple[int, int, Any]] = []
        seen: set = set()
        n_zero_copy = 0
        for i, leaf in enumerate(leaves):
            dev = self._device_leaf(leaf)
            if dev is not None:
                n_zero_copy += 1
                if dev in seen:
                    continue
                seen.add(dev)
                dev_regions.append((dev[0], dev[1], leaf))
                continue
            regions = self._tensor_leaf_regions(leaf)
            if regions is not None:
                n_zero_copy += 1
                for va, nbytes, buf in regions:
                    if (va, nbytes) in seen:
                        continue  # tied leaves: reduce once, in place
                    seen.add((va, nbytes))
                    tensor_ops.append((va, nbytes, buf))
                continue
            staged_idx.append(i)
        coalesced = self._coalesce(dev_regions)
        groups: Dict[str, List[int]] = {}
        for i in staged_idx:
            groups.setdefault(dtype_name(leaves[i]), []).append(i)
        return staged_idx, coalesced, tensor_ops, groups, n_zero_copy

    def _write_back(self, leaf, piece: torch.Tensor):
        """The reduced ``piece`` of a staged leaf, the mean taken in the
        leaf's dtype: a tensor leaf is written in place (a CUDA one by a
        ``non_blocking`` copy on the current stream), a numpy leaf comes
        back as a fresh array, as the JAX shim returns it."""
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(piece.view(leaf.shape), non_blocking=leaf.is_cuda)
            self._apply_mean(leaf)
            return leaf
        fresh = np.empty(np.shape(leaf), dtype=leaf.dtype)
        _host_tensor(fresh).view(-1).copy_(piece)
        self._apply_mean(fresh)
        return fresh

    def _apply_mean(self, arr) -> None:
        """Divide a reduced buffer by the world size, in its own dtype
        (integers floor-divide)."""
        if not self.mean:
            return
        w = self.world.world
        if isinstance(arr, np.ndarray):
            arr = _host_tensor(arr)
        if arr.is_floating_point():
            arr.div_(w)
        else:
            torch.div(arr, w, rounding_mode="floor", out=arr)

    def _sync(self, tree):
        leaves, unflatten = tree_flatten(tree)
        if not leaves:
            return tree
        out: List[Any] = list(leaves)
        used_keys: set = set()
        self.last_split = {"gather_s": 0.0, "ring_s": 0.0, "scatter_s": 0.0}
        (staged_idx, coalesced, tensor_ops, groups,
         n_zero_copy) = self._classify(leaves)
        # Fail fast on SPMD divergence BEFORE posting any ring op.
        describe = self._sched_describe(leaves, coalesced, tensor_ops,
                                        groups, self._stage_chunk(),
                                        wire=None)
        unhold = getattr(self.exporter, "unhold", None)
        # A pinning engine (verbs) pins physical pages: a warm-cached MR
        # over a freed-then-recycled VA would DMA into stale pages, so
        # registrations there are torn down every step.
        pinning = self.world.engine.kind == ENGINE_VERBS
        try:
            check = getattr(self.world, "check_schedule", None)
            if check is not None:
                check(hashlib.sha256(describe.encode()).digest(), describe)
            self._step_token = None

            for va, nbytes, arr in coalesced:
                self._zero_copy(arr, va, nbytes)
                used_keys.add((va, nbytes))
            for va, nbytes, buf in tensor_ops:
                self._zero_copy(buf.view(-1), va, nbytes)
                if pinning:
                    self._drop_cached((va, nbytes))
                else:
                    used_keys.add((va, nbytes))
                    if unhold is not None:
                        unhold(va)
        except BaseException:
            if unhold is not None:
                for va, _, _ in tensor_ops:
                    try:
                        unhold(va)
                    except Exception:
                        pass
            if pinning:
                for va, nbytes, _ in tensor_ops:
                    if (va, nbytes) in self._regs:
                        try:
                            self._drop_cached((va, nbytes))
                        except Exception:
                            pass
            raise

        for dtype_str, idxs in groups.items():
            self._staged_group(leaves, out, dtype_str, idxs)
        self._evict_cache(used_keys)
        trace.event("xslice.allreduce", leaves=len(leaves),
                    zero_copy=n_zero_copy, staged=len(staged_idx))
        return unflatten(out)

    # ------------------------------------------ bucketed overlap path

    def start(self, tree):
        """Backward-overlap sync: launch every ring op nonblocking and
        return a pending object whose ``finish()`` waits the handles
        and writes the results back (the JAX shim's ``start``).

        Staged leaves are packed into buckets (segments of
        ``bucket_bytes``); every bucket's D2H copy is enqueued at once,
        each with its own event, and each bucket's allreduce is launched
        the moment its event has fired, so bucket k rides the wire while
        bucket k+1 lands. Path-1 and path-2 regions launch in place. The
        op sequence is the fused plan's at the default bucket size (same
        digest), and handles run in submission order, so the results
        are bitwise the fused path's. Nothing is written back before
        ``finish()``, so every leaf (a tied one included) is gathered
        before any write-back. Verbs (pinning) engines defer to the
        fused path at ``finish()``."""
        if self.world.engine.kind == ENGINE_VERBS:
            return _DeferredSync(self, tree)
        leaves, unflatten = tree_flatten(tree)
        if not leaves:
            return _DoneSync(tree)
        t0 = time.perf_counter()
        (staged_idx, coalesced, tensor_ops, groups,
         n_zero_copy) = self._classify(leaves)
        describe = self._sched_describe(leaves, coalesced, tensor_ops,
                                        groups, self._bucket_chunk(),
                                        wire=self.wire_dtype)
        unhold = getattr(self.exporter, "unhold", None)
        ops: List[tuple] = []  # execution-ordered plan entries
        launched: List[Any] = []
        used_keys: set = set()
        with trace.span("xslice.sync_start", rank=self.world.rank,
                        leaves=len(leaves)):
            try:
                check = getattr(self.world, "check_schedule", None)
                if check is not None:
                    check(hashlib.sha256(describe.encode()).digest(),
                          describe)
                self._step_token = None
                for va, nbytes, arr in coalesced:
                    self._ensure_registered(va, nbytes)
                    h = self._engine.submit(
                        lambda a=arr: self.world.allreduce_async(a))
                    launched.append(h)
                    ops.append(("zc", h, arr, va))
                    used_keys.add((va, nbytes))
                for va, nbytes, buf in tensor_ops:
                    view = buf.view(-1)
                    self._ensure_registered(va, nbytes)
                    h = self._engine.submit(
                        lambda v=view: self.world.allreduce_async(v))
                    launched.append(h)
                    ops.append(("adopted", h, view, va))
                    used_keys.add((va, nbytes))
                for dtype_str, idxs in groups.items():
                    self._start_staged_group(leaves, dtype_str, idxs, ops,
                                             launched)
            except BaseException:
                # Nothing may stay on the wire or stay held when the
                # error reaches the caller's recovery.
                for h in launched:
                    try:
                        h.wait()
                    except Exception:
                        pass
                if unhold is not None:
                    for va, _, _ in tensor_ops:
                        try:
                            unhold(va)
                        except Exception:
                            pass
                raise
        self.last_split = {"gather_s": time.perf_counter() - t0,
                           "ring_s": 0.0, "scatter_s": 0.0}
        on_card = any(isinstance(leaves[i], torch.Tensor)
                      and leaves[i].is_cuda for i in staged_idx)
        return _PendingSync(self, leaves, unflatten, ops, used_keys,
                            n_zero_copy, len(staged_idx), on_card)

    def _start_staged_group(self, leaves, dtype_str: str, idxs: List[int],
                            ops: List[tuple], launched: List[Any]) -> None:
        """Bucketed nonblocking launch of one dtype group: enqueue every
        bucket's gather, then per bucket wait for its bytes, compress
        (f32 with a wire dtype) and start its ring op."""
        itemsize = _itemsize(dtype_str)
        sizes = [_numel(leaves[i]) for i in idxs]
        total = int(sum(sizes))
        on_card = any(isinstance(leaves[i], torch.Tensor)
                      and leaves[i].is_cuda for i in idxs)
        buf = self._stage(dtype_str, total, pinned=on_card)
        compress = self.wire_dtype is not None and dtype_str == "float32"
        q8 = compress and self.wire_dtype == "int8"
        wbuf = self._stage_wire(dtype_str, total) if compress else None
        res = self._residual(dtype_str, total) if compress else None
        # Per-bucket int8 scales: set by a bucket's produce, read by its
        # launch (the engine runs produce before launch).
        scales: Dict[int, float] = {}
        staging.add(total * itemsize * 2)  # D2H + H2D round trip
        trace.event("xslice.staged_group", dtype=dtype_str,
                    bytes=total * itemsize, leaves=len(idxs),
                    wire=self.wire_dtype or dtype_str)
        segs = self._segment_plan(
            idxs, sizes, max(1, self._bucket_chunk() // itemsize))
        # Front-load every bucket slice's MR before the first launch
        # (registration takes the ring lock the async driver holds while
        # a collective runs). The int8 schedule stages through the
        # ring's own scratch and needs none.
        reg_key = ("w:" if compress else "s:") + dtype_str
        target = wbuf if compress else buf
        if not q8:
            for o, n, _members in segs:
                self._register_slice(reg_key, target[o:o + n])
        landed = [self._gather_into(buf, o, [leaves[i] for i in members])
                  for o, _n, members in segs]

        def bucket_produce(o: int, n: int, k: int) -> None:
            with trace.span("xslice.bucket_gather", seg=k,
                            lane=(k % 14) + 1, rank=self.world.rank,
                            bytes=n * itemsize):
                if landed[k] is not None:
                    landed[k].synchronize()
                if compress:
                    scales[k] = self._compress(buf[o:o + n], wbuf[o:o + n],
                                               res[o:o + n])

        def launch(o: int, n: int, k: int):
            if q8:
                # The q8 allreduce dequantizes the sum straight into the
                # f32 staging slice the write-back reads.
                return self.world.allreduce_q8_async(
                    wbuf[o:o + n], scales[k], buf[o:o + n])
            return self.world.allreduce_async(target[o:o + n])

        for k, (o, n, members) in enumerate(segs):
            # yield_cpu: let the ring's driver get the bucket on the wire
            # before the next produce competes for the core.
            h = self._engine.submit(
                lambda o=o, n=n, k=k: launch(o, n, k),
                produce=lambda o=o, n=n, k=k: bucket_produce(o, n, k),
                yield_cpu=True, tag=("seg", k))
            launched.append(h)
            ops.append(("seg", h, (dtype_str, o, n, list(members),
                                   compress, k)))

    @staticmethod
    def _gather_into(buf: torch.Tensor, o: int, leaves) -> Optional[Any]:
        """Copy ``leaves`` back to back into ``buf`` from element ``o``:
        host leaves synchronously, CUDA leaves by ``non_blocking``
        copies on the current stream. Returns the event that fires when
        the CUDA copies have landed (None when there were none)."""
        card = False
        for leaf in leaves:
            n = _numel(leaf)
            dst = buf[o:o + n]
            if isinstance(leaf, torch.Tensor):
                card = card or leaf.is_cuda
                dst.copy_(leaf.reshape(-1), non_blocking=leaf.is_cuda)
            else:
                dst.copy_(_host_tensor(np.ascontiguousarray(leaf)).reshape(-1))
            o += n
        if not card:
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    def _compress(self, seg: torch.Tensor, wseg: torch.Tensor,
                  res: torch.Tensor) -> float:
        """Error feedback on one f32 host bucket: add last step's
        residual, round ``seg`` into the wire slice ``wseg`` and keep
        the new rounding error in ``res``. int8 quantizes against the
        bucket's absmax (scale = absmax / 127, returned) in numpy, the
        JAX shim's formula operation for operation, so a torch rank and
        a JAX rank round alike bit for bit; bf16 rounds to nearest even,
        as ``ml_dtypes`` does."""
        s, r = seg.numpy(), res.numpy()
        s += r
        if self.wire_dtype == "int8":
            w = wseg.numpy()
            absmax = float(np.max(np.abs(s))) if s.size else 0.0
            scale = absmax / 127.0
            if scale > 0.0:
                np.rint(s / scale, casting="unsafe", out=w)
            else:
                w[...] = 0
            np.subtract(s, w.astype(np.float32) * scale, out=r)
            return scale
        wseg.copy_(seg)
        torch.sub(seg, wseg.float(), out=res)
        return 0.0

    # ---------------------------------------- per-layer backward path

    def start_layered(self, plan: List[Tuple[str, List[Tuple[int, str]]]]):
        """Open a per-layer overlapped sync for one training step (the
        JAX shim's ``start_layered``).

        ``plan`` lists one bucket per layer parameter subtree in tree
        order, ``(key, [(numel, dtype_str), ...])``; it is hashed into
        the schedule digest before any wire work. The trainer's
        gradient hooks call ``push(idx, leaves)`` as the backward
        produces each bucket, and the trainer ``wait_posted()`` once the
        backward is done; ``finish(tree)`` waits every handle and
        writes the reduced values into the leaves of ``tree``. Buckets
        go on the wire in the reverse of the plan's order, whatever
        order they are pushed in: the order a JAX rank's ordered taps
        deliver them in, and so the same on every rank."""
        if self.world.engine.kind == ENGINE_VERBS:
            return _LayeredDeferred(self)
        return _LayeredSync(self, plan)

    def _layered_describe(self, plan) -> str:
        """The shared base terms for the plan's per-leaf sizes plus an
        ``lplan=`` term naming the bucket boundaries."""
        fake: List[Any] = []
        groups: Dict[str, List[int]] = {}
        for _key, leaves in plan:
            for size, dtype_str in leaves:
                groups.setdefault(dtype_str, []).append(len(fake))
                fake.append(_SizeLeaf(int(size)))
        base = self._sched_describe(fake, [], [], groups,
                                    self._bucket_chunk(),
                                    wire=self.wire_dtype)
        lplan = ",".join(f"{key}:{len(leaves)}" for key, leaves in plan)
        return base + " lplan=" + lplan

    def _copy_stream(self, device) -> Any:
        """The side stream per-layer D2H copies run on (one per device)."""
        key = str(device)
        stream = self._copy_streams.get(key)
        if stream is None:
            stream = self._copy_streams[key] = torch.cuda.Stream(device)
        return stream

    def _post_worker(self) -> ThreadPoolExecutor:
        if self._post_ex is None:
            self._post_ex = ThreadPoolExecutor(1,
                                               thread_name_prefix="tdr-post")
        return self._post_ex

    # ---------------------------------------------- staged pipeline

    def _staged_group(self, leaves, out, dtype_str: str,
                      idxs: List[int]) -> None:
        """Gather → ring → scatter for one dtype group.

        CUDA leaves are copied into the pinned staging tensor with
        ``non_blocking`` copies on the current stream, and a CUDA event
        is synchronised before the ring reads the bytes; the scatter
        copies each reduced piece back into its leaf in place and takes
        the mean there, in the leaf's dtype; the group ends by
        synchronising those copies, so the next gather never overwrites
        a piece still being read. Host leaves go through the same
        buffer: CPU tensors are written back in place, numpy leaves
        come back as fresh arrays (as the JAX shim returns them). Ring
        ops run in segment order — the plan is a pure function of the
        digest-checked leaf sizes and TDR_STAGE_CHUNK."""
        itemsize = _itemsize(dtype_str)
        sizes = [_numel(leaves[i]) for i in idxs]
        total = int(sum(sizes))
        on_card = any(isinstance(leaves[i], torch.Tensor)
                      and leaves[i].is_cuda for i in idxs)
        buf = self._stage(dtype_str, total, pinned=on_card)
        staging.add(total * itemsize * 2)  # D2H + H2D round trip
        trace.event("xslice.staged_group", dtype=dtype_str,
                    bytes=total * itemsize, leaves=len(idxs))
        segs = self._segment_plan(idxs, sizes,
                                  max(1, self._stage_chunk() // itemsize))
        split = self.last_split

        def gather(seg, k):
            t0 = time.perf_counter()
            with trace.span("xslice.stage_gather", seg=k,
                            rank=self.world.rank, bytes=seg[1] * itemsize):
                done = self._gather_into(buf, seg[0],
                                         [leaves[i] for i in seg[2]])
                if done is not None:
                    done.synchronize()
            split["gather_s"] += time.perf_counter() - t0

        def ring_op(seg, k):
            t0 = time.perf_counter()
            with trace.span("xslice.stage_ring", seg=k,
                            rank=self.world.rank, bytes=seg[1] * itemsize):
                self.world.allreduce(buf[seg[0]:seg[0] + seg[1]], RED_SUM)
            split["ring_s"] += time.perf_counter() - t0

        # A tensor that occurs again later in the group (a tied leaf)
        # is written back only after every segment has been gathered:
        # an earlier write-back would feed the reduced value into a
        # later segment's gather, summing the leaf twice.
        keys = [_storage_key(leaves[i]) for i in idxs]
        tied = {k for k in keys if k is not None and keys.count(k) > 1}
        deferred: List[Tuple[int, int]] = []

        def scatter(seg, k):
            t0 = time.perf_counter()
            with trace.span("xslice.stage_scatter", seg=k,
                            rank=self.world.rank, bytes=seg[1] * itemsize):
                o = seg[0]
                for i in seg[2]:
                    n = _numel(leaves[i])
                    if _storage_key(leaves[i]) in tied:
                        deferred.append((i, o))
                    else:
                        out[i] = self._write_back(leaves[i], buf[o:o + n])
                    o += n
            split["scatter_s"] += time.perf_counter() - t0

        pipelined = (len(segs) > 1
                     and os.environ.get("TDR_STAGE_PIPELINE", "0")
                     not in ("", "0")
                     and os.environ.get("TDR_NO_STAGE_PIPELINE", "0")
                     in ("", "0"))
        if not pipelined:
            for k, seg in enumerate(segs):
                gather(seg, k)
                ring_op(seg, k)
                scatter(seg, k)
        else:
            # Ring ops on one worker in segment order; this thread
            # gathers segment k+1 and scatters finished segments while
            # segment k is on the wire.
            ex = self._stage_ex
            if ex is None:
                ex = self._stage_ex = ThreadPoolExecutor(
                    1, thread_name_prefix="tdr-stage")
            self._engine.pipeline(
                segs, produce=gather,
                launch=lambda seg, k: ex.submit(ring_op, seg, k),
                consume=lambda _res, seg, k: scatter(seg, k),
                depth=stream_depth(3))
        t0 = time.perf_counter()
        for i, o in deferred:
            out[i] = self._write_back(leaves[i],
                                      buf[o:o + _numel(leaves[i])])
        if on_card:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        split["scatter_s"] += time.perf_counter() - t0

    @staticmethod
    def _segment_plan(idxs: List[int], sizes: List[int],
                      chunk_elems: int) -> List[Tuple[int, int, List[int]]]:
        """Batch consecutive leaves into segments of >= chunk_elems
        elements: [(start_elem, n_elems, member_leaf_indices)]."""
        segs: List[Tuple[int, int, List[int]]] = []
        start, size, members = 0, 0, []
        off = 0
        for i, sz in zip(idxs, sizes):
            members.append(i)
            size += sz
            off += sz
            if size >= chunk_elems:
                segs.append((start, size, members))
                start, size, members = off, 0, []
        if size:
            segs.append((start, size, members))
        return segs

    @staticmethod
    def _stage_chunk() -> int:
        env = os.environ.get("TDR_STAGE_CHUNK", "")
        if env:
            try:
                v = int(env)
                if v >= 4096:
                    return v
            except ValueError:
                pass
        return 16 << 20

    def _bucket_chunk(self) -> int:
        """Bucket size in bytes on the overlap paths: ``bucket_bytes``,
        else the fused path's stage chunk (so the default overlap plan
        is the fused plan)."""
        return self.bucket_bytes or self._stage_chunk()

    def _stage(self, dtype_str: str, count: int,
               pinned: bool) -> torch.Tensor:
        """The persistent staging tensor of a dtype, ring-registered
        once. It is replaced (its bucket slices and then the tensor
        unregistered first) when it is too small, or when a CUDA leaf
        needs it pinned."""
        buf = self._staging.get(dtype_str)
        if buf is None or buf.numel() < count or (pinned
                                                  and not buf.is_pinned()):
            if buf is not None:
                self._unregister(buf, "s:" + dtype_str)
            buf = torch.empty(count, dtype=TORCH_DTYPES[dtype_str],
                              pin_memory=pinned)
            self._staging[dtype_str] = buf
            self.world.ring.register_buffer(buf)
        return buf

    def _unregister(self, buf: torch.Tensor, key: str) -> None:
        """Drop a staging tensor's bucket-slice MRs, then its own (the
        first slice shares the tensor's base address)."""
        dropped = set()
        for va in self._slice_regs.pop(key, {}):
            dropped.add(va)
            try:
                self.world.ring.drop_buffer(va)
            except Exception:
                pass  # the ring may already be torn down
        if buf.data_ptr() not in dropped:
            self.world.ring.unregister_buffer(buf)

    def _register_slice(self, key: str, view: torch.Tensor) -> None:
        """Front-load the ring registration of one bucket slice, so a
        steady-state launch posts work requests only."""
        regs = self._slice_regs.setdefault(key, {})
        va, nbytes = view.data_ptr(), view.numel() * view.element_size()
        if regs.get(va, 0) >= nbytes:
            return
        self.world.ring.register_buffer(view)
        regs[va] = nbytes

    def _stage_wire(self, dtype_str: str, count: int) -> torch.Tensor:
        """The persistent compressed wire tensor of a dtype group. A
        bf16 one is ring-registered (the ring folds it in place); an
        int8 one is plain host memory (the q8 schedule stages through
        the ring's scratch)."""
        wdt = torch.int8 if self.wire_dtype == "int8" else torch.bfloat16
        buf = self._wire_staging.get(dtype_str)
        if buf is not None and (buf.dtype != wdt or buf.numel() < count):
            if buf.dtype != torch.int8:
                self._unregister(buf, "w:" + dtype_str)
            buf = None
        if buf is None:
            buf = torch.empty(count, dtype=wdt)
            self._wire_staging[dtype_str] = buf
            if wdt != torch.int8:
                self.world.ring.register_buffer(buf)
        return buf

    def _residual(self, dtype_str: str, count: int) -> torch.Tensor:
        """Per-rank error-feedback accumulator of a compressed group,
        host-only; zeroed when the group's size changes."""
        res = self._residuals.get(dtype_str)
        if res is None or res.numel() != count:
            res = torch.zeros(count, dtype=torch.float32)
            self._residuals[dtype_str] = res
        return res

    def set_step_token(self, step: int) -> None:
        """Stamp the NEXT schedule-digest exchange with the training
        step (and the transport seals with it): ranks at different
        steps fail the digest instead of averaging different batches."""
        self._step_token = int(step)
        stamp = getattr(self.world, "set_seal_step", None)
        if stamp is not None:
            stamp(step)

    def reset_transport_cache(self) -> None:
        """Forget ring-bound state after ``RingWorld.rebuild()``: staging
        tensors re-register and cached registrations re-pin on next
        use. Error-feedback residuals are rank-local training state and
        survive."""
        self._staging.clear()
        self._wire_staging.clear()
        self._slice_regs.clear()
        for key in list(self._regs):
            try:
                self._drop_cached(key)
            except Exception:
                pass
        trace.event("xslice.cache_reset")

    def close(self) -> None:
        """Release the registrations (unadopt from the ring, then
        unpin). Call before tearing down the world."""
        self._engine.close()
        for ex in (self._stage_ex, self._post_ex):
            if ex is not None:
                ex.shutdown(wait=True)
        self._stage_ex = self._post_ex = None
        for key in list(self._regs):
            self._drop_cached(key, forget_adoption=False)
        if self._regmgr is not None:
            self._regmgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _drain(handles) -> None:
    """Wait every handle, ignoring failures: nothing may stay on the
    wire when an error reaches the caller's recovery."""
    for h in handles:
        try:
            h.wait()
        except Exception:
            pass


class _DoneSync:
    """Pending object of a sync that completed at start (empty tree)."""

    def __init__(self, result):
        self._result = result

    def finish(self):
        return self._result


class _DeferredSync:
    """Pending object of the verbs (pinning) degrade: the fused sync
    runs at ``finish()``; per-step MR teardown cannot outlive an async
    handle."""

    def __init__(self, shim: CrossSliceAllReduce, tree):
        self._shim = shim
        self._tree = tree

    def finish(self):
        shim, tree = self._shim, self._tree
        self._tree = None
        with trace.span("xslice.sync", rank=shim.world.rank):
            return shim._sync(tree)


class _PendingSync:
    """In-flight bucketed sync (``CrossSliceAllReduce.start``).

    ``finish()`` waits the handles in submission order, writing bucket
    k back into its leaves as soon as its wire work has landed while
    later buckets are still in flight, and returns the reduced tree; it
    ends synchronised, as the staged path does. On a failure the
    remaining handles are drained and adopted tensors released before
    the first error re-raises."""

    def __init__(self, shim: CrossSliceAllReduce, leaves, unflatten, ops,
                 used_keys, n_zero_copy: int, n_staged: int,
                 on_card: bool):
        self._shim = shim
        self._leaves = leaves
        self._out: List[Any] = list(leaves)
        self._unflatten = unflatten
        self._ops = ops
        self._used_keys = used_keys
        self._n_zero_copy = n_zero_copy
        self._n_staged = n_staged
        self._on_card = on_card
        self._result = None
        self._done = False

    def _scatter(self, dtype_str: str, o: int, n: int, members: List[int],
                 compress: bool, k: int, coll: int = 0) -> None:
        shim = self._shim
        buf = shim._staging[dtype_str]
        with trace.span("xslice.bucket_scatter", seg=k, lane=(k % 14) + 1,
                        rank=shim.world.rank,
                        bytes=n * _itemsize(dtype_str), coll=coll):
            if compress and shim.wire_dtype == "bf16":
                # The reduced bf16 wire bytes back into the f32 slice
                # (the q8 allreduce already dequantized into it).
                buf[o:o + n].copy_(shim._wire_staging[dtype_str][o:o + n])
            off = o
            for i in members:
                size = _numel(self._leaves[i])
                self._out[i] = shim._write_back(self._leaves[i],
                                                buf[off:off + size])
                off += size

    def finish(self):
        """Wait every handle in submission order, write back, and
        return the reduced tree. Idempotent after success."""
        if self._done:
            return self._result
        shim = self._shim
        unhold = getattr(shim.exporter, "unhold", None)
        split = shim.last_split
        with trace.span("xslice.sync_finish", rank=shim.world.rank):
            for idx, op in enumerate(self._ops):
                try:
                    t0 = time.perf_counter()
                    op[1].wait()
                    t1 = time.perf_counter()
                    split["ring_s"] += t1 - t0
                    if op[0] == "seg":
                        self._scatter(*op[2], coll=op[1].coll)
                    else:
                        shim._apply_mean(op[2])
                        if op[0] == "adopted" and unhold is not None:
                            unhold(op[3])
                    split["scatter_s"] += time.perf_counter() - t1
                except BaseException:
                    later = self._ops[idx + 1:]
                    _drain(o[1] for o in later)
                    if unhold is not None:
                        for o in [op] + later:
                            if o[0] == "adopted":
                                try:
                                    unhold(o[3])
                                except Exception:
                                    pass
                    self._done = True
                    raise
            t0 = time.perf_counter()
            if self._on_card:
                torch.cuda.current_stream().synchronize()
            split["scatter_s"] += time.perf_counter() - t0
            self._done = True
            shim._evict_cache(self._used_keys)
            trace.event("xslice.allreduce", leaves=len(self._leaves),
                        zero_copy=self._n_zero_copy, staged=self._n_staged)
            self._result = self._unflatten(self._out)
        return self._result


class _LayeredDeferred:
    """Per-layer pending object of the verbs (pinning) degrade: pushes
    are ignored and ``finish(tree)`` runs the fused sync."""

    def __init__(self, shim: CrossSliceAllReduce):
        self._shim = shim

    def push(self, idx: int, leaves) -> None:
        pass  # the fused sync at finish() reduces the whole tree

    def wait_posted(self) -> None:
        pass  # nothing is posted before finish()

    def finish(self, tree):
        with trace.span("xslice.sync", rank=self._shim.world.rank):
            return self._shim._sync(tree)


class _LayeredSync:
    """In-flight per-layer sync (``CrossSliceAllReduce.start_layered``).

    ``push(idx, leaves)`` copies bucket ``idx``'s gradients into its
    slices of the staging tensors — from a CUDA leaf by a
    ``non_blocking`` copy on a side stream that first waits on the
    stream that produced the gradient, so the caller (autograd's device
    thread, inside a post-accumulate-grad hook) never blocks — and
    hands the bucket to the shim's one FIFO worker. The worker waits
    for the copy, compresses (a wire dtype on f32), and posts the
    bucket's allreduces. It posts buckets in the reverse of the plan's
    order, holding a bucket pushed early until its turn: the order is a
    function of the plan, never of thread timing, and it is the order a
    JAX rank's ordered taps deliver in, so mixed rings agree.

    ``push`` never raises: the first failure is kept and re-raised from
    ``finish()`` after every launched handle has been drained."""

    def __init__(self, shim: CrossSliceAllReduce, plan):
        self._shim = shim
        self._plan = plan
        self._cv = threading.Condition()
        self._arrived = [False] * len(plan)
        self._handles: List[tuple] = []  # (segment, handle), posted order
        self._err: Optional[BaseException] = None
        self._order = list(reversed(range(len(plan))))
        self._next = 0             # position in _order (worker-owned)
        self._landed: Dict[int, Any] = {}   # idx -> copy event (worker)
        self._stage_s = 0.0

        describe = shim._layered_describe(plan)
        check = getattr(shim.world, "check_schedule", None)
        if check is not None:
            check(hashlib.sha256(describe.encode()).digest(), describe)
        shim._step_token = None

        # Within each bucket, consecutive same-dtype leaves form one
        # segment; segments pack bucket-major into the per-dtype staging
        # tensors, so the layout (and the residual addressing) is the
        # same every step.
        self._segs: List[List[tuple]] = []
        #   per bucket: (dtype_str, off, n, [leaf sizes], [leaf indices])
        totals: Dict[str, int] = {}
        gidx = 0
        for _key, leaves in plan:
            bucket_segs: List[tuple] = []
            cur = None
            for size, dtype_str in leaves:
                size = int(size)
                if cur is not None and cur[0] == dtype_str:
                    cur[2] += size
                    cur[3].append(size)
                    cur[4].append(gidx)
                else:
                    if cur is not None:
                        bucket_segs.append(tuple(cur))
                    cur = [dtype_str, totals.get(dtype_str, 0), size,
                           [size], [gidx]]
                gidx += 1
                totals[dtype_str] = totals.get(dtype_str, 0) + size
            if cur is not None:
                bucket_segs.append(tuple(cur))
            self._segs.append(bucket_segs)
        self._n_leaves = gidx

        # Front-load the staging tensors (pinned where a card could
        # stage into them), slice MRs and, for compressed f32, the wire
        # tensor and residual: a steady-state push posts work only.
        pinned = torch.cuda.is_available()
        self._bufs: Dict[str, torch.Tensor] = {}
        self._wbufs: Dict[str, torch.Tensor] = {}
        self._res: Dict[str, torch.Tensor] = {}
        q8 = shim.wire_dtype == "int8"
        for dtype_str, total in totals.items():
            buf = shim._stage(dtype_str, total, pinned=pinned)
            self._bufs[dtype_str] = buf
            compress = shim.wire_dtype is not None and dtype_str == "float32"
            if compress:
                self._wbufs[dtype_str] = shim._stage_wire(dtype_str, total)
                self._res[dtype_str] = shim._residual(dtype_str, total)
            staging.add(total * _itemsize(dtype_str) * 2)  # D2H + H2D
            if not (compress and q8):
                target = self._wbufs[dtype_str] if compress else buf
                reg_key = ("w:" if compress else "s:") + dtype_str
                for segs in self._segs:
                    for dt, off, n, _sz, _gi in segs:
                        if dt == dtype_str:
                            shim._register_slice(reg_key,
                                                 target[off:off + n])
        trace.event("xslice.layered_open", buckets=len(plan),
                    leaves=self._n_leaves, wire=shim.wire_dtype or "f32")

    def push(self, idx: int, leaves) -> None:
        """Stage bucket ``idx``'s gradient leaves (tree order) and hand
        it to the posting worker. Never raises; failures surface from
        ``finish()``."""
        shim = self._shim
        landed = None
        t0 = time.perf_counter()
        try:
            if self._err is None:
                segs = self._segs[idx]
                nbytes = sum(n * _itemsize(dt) for dt, _o, n, _s, _g in segs)
                with trace.span("xslice.layer_stage", bucket=idx,
                                lane=(idx % 14) + 1, rank=shim.world.rank,
                                bytes=nbytes):
                    landed = self._stage_bucket(segs, leaves)
        except BaseException as e:  # noqa: BLE001 — re-raised at finish
            if self._err is None:
                self._err = e
        self._stage_s += time.perf_counter() - t0
        try:
            shim._post_worker().submit(self._post, idx, landed)
        except BaseException as e:  # noqa: BLE001 — re-raised at finish
            if self._err is None:
                self._err = e
            with self._cv:
                self._arrived[idx] = True
                self._cv.notify_all()

    def _stage_bucket(self, segs, leaves) -> Optional[Any]:
        """Copy a bucket's leaves into their staging slices; returns
        the event its CUDA copies complete on (None for host leaves,
        copied synchronously)."""
        pairs = []
        li = 0
        for dt, off, n, sizes, _gidxs in segs:
            o = off
            for sz in sizes:
                pairs.append((leaves[li], self._bufs[dt][o:o + sz]))
                o += sz
                li += 1
        cuda = [t for t, _ in pairs
                if isinstance(t, torch.Tensor) and t.is_cuda]
        if not cuda:
            for leaf, dst in pairs:
                src = (leaf if isinstance(leaf, torch.Tensor)
                       else _host_tensor(np.ascontiguousarray(leaf)))
                dst.copy_(src.reshape(-1))
            return None
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(cuda[0].device))
        stream = self._shim._copy_stream(cuda[0].device)
        stream.wait_event(produced)
        with torch.cuda.stream(stream):
            for leaf, dst in pairs:
                dst.copy_(leaf.reshape(-1), non_blocking=True)
            for leaf in cuda:
                # The caching allocator must not hand the gradient's
                # memory to another tensor before this copy has read it.
                leaf.record_stream(stream)
            copied = torch.cuda.Event()
            copied.record(stream)
        return copied

    def _post(self, idx: int, landed) -> None:
        """Worker: note bucket ``idx`` as staged, then post every bucket
        whose turn has come, in the plan's reverse order."""
        self._landed[idx] = landed
        while (self._next < len(self._order)
               and self._order[self._next] in self._landed):
            b = self._order[self._next]
            self._next += 1
            try:
                if self._err is None:
                    if self._landed[b] is not None:
                        self._landed[b].synchronize()
                    self._launch(b)
            except BaseException as e:  # noqa: BLE001 — re-raised later
                if self._err is None:
                    self._err = e
            finally:
                with self._cv:
                    self._arrived[b] = True
                    self._cv.notify_all()

    def _launch(self, b: int) -> None:
        shim = self._shim
        for seg in self._segs[b]:
            dt, off, n = seg[0], seg[1], seg[2]
            buf = self._bufs[dt][off:off + n]
            if shim.wire_dtype is not None and dt == "float32":
                wbuf = self._wbufs[dt][off:off + n]
                scale = shim._compress(buf, wbuf,
                                       self._res[dt][off:off + n])
                if shim.wire_dtype == "int8":
                    h = shim.world.allreduce_q8_async(wbuf, scale, buf)
                else:
                    h = shim.world.allreduce_async(wbuf)
            else:
                h = shim.world.allreduce_async(buf)
            self._handles.append((seg, h))

    def wait_posted(self) -> None:
        """Block until every bucket has been posted or has failed. A
        bucket still missing after ``_POST_WAIT_S`` (a gradient hook did
        not fire) raises, the posted handles drained."""
        with self._cv:
            ok = self._cv.wait_for(lambda: all(self._arrived),
                                   timeout=_POST_WAIT_S)
        if not ok:
            missing = [i for i, a in enumerate(self._arrived) if not a]
            _drain(h for _s, h in self._handles)
            raise RuntimeError(
                f"layered sync: buckets {missing} never delivered "
                "gradients (a gradient hook did not fire)")

    def finish(self, tree):
        """Wait for every bucket to be posted and every handle to land
        (posted order), write the reduced values into the leaves of
        ``tree`` (tensors in place, numpy leaves as fresh arrays) and
        return the reduced tree, synchronised."""
        shim = self._shim
        leaves, unflatten = tree_flatten(tree)
        if len(leaves) != self._n_leaves:
            raise ValueError(
                f"layered finish: template tree has {len(leaves)} "
                f"leaves but the plan staged {self._n_leaves}")
        out: List[Any] = list(leaves)
        t0 = time.perf_counter()
        ring_s = scatter_s = 0.0
        with trace.span("xslice.sync_finish", rank=shim.world.rank):
            self.wait_posted()
            if self._err is not None:
                _drain(h for _s, h in self._handles)
                raise self._err
            gather_s = time.perf_counter() - t0
            on_card = False
            for hi, (seg, h) in enumerate(self._handles):
                dt, off, n, sizes, gidxs = seg
                t1 = time.perf_counter()
                try:
                    h.wait()
                except BaseException:
                    _drain(h2 for _s, h2 in self._handles[hi + 1:])
                    raise
                t2 = time.perf_counter()
                ring_s += t2 - t1
                buf = self._bufs[dt]
                if shim.wire_dtype == "bf16" and dt == "float32":
                    buf[off:off + n].copy_(self._wbufs[dt][off:off + n])
                o = off
                for sz, gi in zip(sizes, gidxs):
                    on_card = on_card or (isinstance(leaves[gi], torch.Tensor)
                                          and leaves[gi].is_cuda)
                    out[gi] = shim._write_back(leaves[gi], buf[o:o + sz])
                    o += sz
                scatter_s += time.perf_counter() - t2
            t1 = time.perf_counter()
            if on_card:
                torch.cuda.current_stream().synchronize()
            scatter_s += time.perf_counter() - t1
            shim.last_split = {"stage_s": self._stage_s,
                               "gather_s": gather_s, "ring_s": ring_s,
                               "scatter_s": scatter_s}
            trace.event("xslice.allreduce", leaves=self._n_leaves,
                        zero_copy=0, staged=self._n_leaves,
                        layered=len(self._plan))
            return unflatten(out)
