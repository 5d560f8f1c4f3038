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

Not ported yet (ROADMAP Queue 1 item 2b): the bucketed ``start`` /
``finish`` overlap path, the bf16 / int8 wire with error feedback, and
``per_layer`` delivery; asking for any of them (or running with
``TDR_WIRE_DTYPE`` set) raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import time
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
                                                 _NUMPY_DTYPE_MAP, dtype_name,
                                                 ring_chunk_bytes)
from rocnrdma_tpu_torch.utils.trace import trace

# Bound on cached zero-copy registrations (see the JAX shim).
_REG_CACHE_MAX = 128

# Adjacent exporter leaves merge across dead gaps up to this many bytes.
_COALESCE_GAP_MAX = 512

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
        wire = wire_dtype if wire_dtype is not None else \
            os.environ.get("TDR_WIRE_DTYPE", "")
        for asked, what in ((overlap, "overlap=True (bucketed start/finish)"),
                            (bucket_bytes is not None, "bucket_bytes"),
                            (wire not in ("", "f32", "float32"),
                             f"wire dtype {wire!r} (TDR_WIRE_DTYPE)"),
                            (per_layer, "per_layer=True")):
            if asked:
                raise NotImplementedError(
                    f"CrossSliceAllReduce {what} is not ported to "
                    "rocnrdma_tpu_torch yet (ROADMAP.md Queue 1, item 2b)")
        self.world = world
        self.exporter = exporter
        self.mean = mean
        # Persistent per-dtype staging tensors, registered with the
        # ring once; pinned when a CUDA leaf stages through them.
        self._staging: Dict[str, torch.Tensor] = {}
        # Zero-copy registration cache: (va, nbytes) -> Registration.
        self._regs: Dict[Tuple[int, int], Any] = {}
        self._regmgr: Optional[RegistrationManager] = None
        self._stage_ex: Optional[ThreadPoolExecutor] = None
        self._engine = TransferEngine(depth=0, name="xslice")
        self._step_token: Optional[int] = None
        # Host seconds of the last call's staged phases: the gather
        # (D2H into the pinned buffer), the ring allreduce, and the
        # scatter (H2D back into the leaves, synchronised).
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
                o = seg[0]
                card = False
                for i in seg[2]:
                    leaf = leaves[i]
                    n = _numel(leaf)
                    dst = buf[o:o + n]
                    if isinstance(leaf, torch.Tensor):
                        card = card or leaf.is_cuda
                        dst.copy_(leaf.reshape(-1), non_blocking=leaf.is_cuda)
                    else:
                        dst.copy_(_host_tensor(
                            np.ascontiguousarray(leaf)).reshape(-1))
                    o += n
                if card:
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
            split["gather_s"] += time.perf_counter() - t0

        def ring_op(seg, k):
            t0 = time.perf_counter()
            with trace.span("xslice.stage_ring", seg=k,
                            rank=self.world.rank, bytes=seg[1] * itemsize):
                self.world.allreduce(buf[seg[0]:seg[0] + seg[1]], RED_SUM)
            split["ring_s"] += time.perf_counter() - t0

        def scatter(seg, k):
            t0 = time.perf_counter()
            with trace.span("xslice.stage_scatter", seg=k,
                            rank=self.world.rank, bytes=seg[1] * itemsize):
                o = seg[0]
                for i in seg[2]:
                    leaf = leaves[i]
                    n = _numel(leaf)
                    piece = buf[o:o + n]
                    o += n
                    if isinstance(leaf, torch.Tensor):
                        leaf.copy_(piece.view(leaf.shape),
                                   non_blocking=leaf.is_cuda)
                        self._apply_mean(leaf)
                        out[i] = leaf
                    else:
                        fresh = np.empty(np.shape(leaf), dtype=leaf.dtype)
                        _host_tensor(fresh).view(-1).copy_(piece)
                        self._apply_mean(fresh)
                        out[i] = fresh
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
        if on_card:
            t0 = time.perf_counter()
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

    def _stage(self, dtype_str: str, count: int,
               pinned: bool) -> torch.Tensor:
        """The persistent staging tensor of a dtype, ring-registered
        once. It is replaced (and the old one unregistered first) when
        it is too small, or when a CUDA leaf needs it pinned."""
        buf = self._staging.get(dtype_str)
        if buf is None or buf.numel() < count or (pinned
                                                  and not buf.is_pinned()):
            if buf is not None:
                self.world.ring.unregister_buffer(buf)
            buf = torch.empty(count, dtype=TORCH_DTYPES[dtype_str],
                              pin_memory=pinned)
            self._staging[dtype_str] = buf
            self.world.ring.register_buffer(buf)
        return buf

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
        use."""
        self._staging.clear()
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
        if self._stage_ex is not None:
            self._stage_ex.shutdown(wait=True)
            self._stage_ex = None
        for key in list(self._regs):
            self._drop_cached(key, forget_adoption=False)
        if self._regmgr is not None:
            self._regmgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
