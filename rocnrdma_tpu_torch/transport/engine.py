"""ctypes bindings to the native transport engine (libtdr.so): the
port's own copy of ``rocnrdma_tpu/transport/engine.py``.

This is the Python face of the userspace half of the stack: MR
registration, RC queue pairs, one-sided WRITE/READ, two-sided
SEND/RECV, completions, MR revocation, and the native ring allreduce.
The library is built from this package's own copy of the native
sources, ``rocnrdma_tpu_torch/native`` (byte-identical to the JAX
package's, so a torch rank and a JAX rank speak one wire format), at
first use, by ``make`` under an exclusive ``flock`` on
``rocnrdma_tpu_torch/_build/libtdr.lock`` (concurrent test workers
race on the first build). It has no build-time dependencies: the verbs
backend dlopens libibverbs at runtime, and machines without NICs get
the emulated backend. ``TDR_NATIVE_LIB``, read at import, names another
artifact to load in its place (the ASan+UBSan ``libtdr_san.so`` that
``make -C rocnrdma_tpu_torch/native sanitize`` builds); then nothing is
built, and a path that does not exist raises ``TransportError``.

Buffers are C-contiguous numpy arrays or contiguous **CPU** torch
tensors (the address is ``data_ptr()``). A CUDA tensor is refused: the
ring folds on the host CPU, so device memory reaches it only through a
staged host copy (``collectives.torch_shim``) or, for one-sided
transfers, through a dma-buf MR (``Engine.reg_dmabuf_mr``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import re
import subprocess
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from rocnrdma_tpu_torch.utils.trace import trace

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
# TDR_NATIVE_LIB points at an alternative artifact (the sanitized
# libtdr_san.so built by `make sanitize`); default is the on-demand
# production build.
_NATIVE_LIB = os.environ.get("TDR_NATIVE_LIB") or None
_LIB_PATH = os.path.abspath(_NATIVE_LIB) if _NATIVE_LIB else \
    os.path.join(_NATIVE_DIR, "libtdr.so")
_BUILD_LOCK = os.path.join(_PKG_DIR, "_build", "libtdr.lock")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# Engine kinds
ENGINE_EMU = 0
ENGINE_VERBS = 1

# Completion statuses
WC_SUCCESS = 0
WC_REM_ACCESS_ERR = 1
WC_LOC_ACCESS_ERR = 2
WC_FLUSH_ERR = 3
WC_GENERAL_ERR = 4
# Seal verification failed at land time and the per-chunk retransmit
# budget is exhausted (or a stale-incarnation frame was fenced).
WC_INTEGRITY_ERR = 5

# Access flags
ACCESS_LOCAL = 0
ACCESS_REMOTE_WRITE = 1
ACCESS_REMOTE_READ = 2

# Opcodes
OP_WRITE, OP_READ, OP_SEND, OP_RECV = 0, 1, 2, 3

# Datatypes / reduce ops for the ring
DT_F32, DT_F64, DT_I32, DT_I64, DT_BF16, DT_U8 = 0, 1, 2, 3, 4, 5
DT_I8 = 6  # int8 wire compression; reduces only via allreduce_q8
RED_SUM, RED_MAX, RED_MIN = 0, 1, 2

# Ring schedules (tdr_ring_last_schedule)
SCHED_NONE, SCHED_GENERIC, SCHED_FUSED2, SCHED_FUSED2_FB, SCHED_WAVEFRONT = \
    0, 1, 2, 3, 4
SCHED_Q8 = 5

# Connection flags (tdr_listen_tier/tdr_connect_tier).
_CONN_FORCE_STREAM = 1

_NUMPY_DTYPE_MAP = {
    "float32": DT_F32,
    "float64": DT_F64,
    "int32": DT_I32,
    "int64": DT_I64,
    "bfloat16": DT_BF16,
    # Byte transport only (alltoall / all_gather / broadcast); the
    # reducing collectives reject it engine-side (no fold semantics).
    "uint8": DT_U8,
    # Quantized wire payload: reduces only through the scale-carrying
    # q8 schedule (Ring.allreduce_q8); plain reducing collectives
    # reject it engine-side (a scale-less int8 sum overflows).
    "int8": DT_I8,
}


def dtype_name(array) -> str:
    """numpy's name of the dtype of a numpy array or a torch tensor
    (``float32``, ``bfloat16``, ...): the name the dtype map, the
    schedule digests and the JAX package use."""
    name = str(array.dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _itemsize(array) -> int:
    return (array.element_size() if isinstance(array, torch.Tensor)
            else array.itemsize)


def buffer_args(array, what: str) -> Tuple[int, int, int]:
    """(address, element count, byte count) of a C-contiguous numpy
    array or a contiguous CPU torch tensor. Anything else raises a
    :class:`TransportError`; a CUDA tensor in particular, because the
    ring folds on the host CPU (its data MR must be CPU-addressable)."""
    import numpy as np

    if isinstance(array, np.ndarray):
        if not array.flags["C_CONTIGUOUS"]:
            raise TransportError(f"{what} requires a C-contiguous numpy "
                                 "array")
        return array.ctypes.data, array.size, array.nbytes
    if isinstance(array, torch.Tensor):
        if array.device.type != "cpu":
            raise TransportError(
                f"{what}: a {array.device.type} tensor cannot reach the "
                "transport directly — the ring folds on the host CPU, so "
                "device memory must be staged into a CPU tensor first "
                "(collectives.torch_shim does)")
        if not array.is_contiguous():
            raise TransportError(f"{what} requires a contiguous CPU tensor")
        n = array.numel()
        return array.data_ptr(), n, n * array.element_size()
    raise TransportError(f"{what} requires a C-contiguous numpy array or a "
                         f"contiguous CPU torch tensor, not {type(array)}")


class Wc(ctypes.Structure):
    _fields_ = [
        ("wr_id", ctypes.c_uint64),
        ("status", ctypes.c_int32),
        ("opcode", ctypes.c_int32),
        ("len", ctypes.c_uint64),
    ]


class TelEventC(ctypes.Structure):
    """Mirror of the native tdr_tel_event (40 bytes, fixed layout)."""

    _fields_ = [
        ("ts_ns", ctypes.c_uint64),
        ("type", ctypes.c_uint16),
        ("engine", ctypes.c_uint16),
        ("qp", ctypes.c_uint32),
        ("id", ctypes.c_uint64),
        ("arg", ctypes.c_uint64),
        # Collective trace id (0 = none; bit 63 = ring auto-assigned).
        ("coll", ctypes.c_uint64),
    ]


def _build_library() -> None:
    """Bring ``libtdr.so`` up to date with the native sources. ``make``
    rebuilds only what changed; the exclusive ``flock`` makes
    concurrent processes (test workers, the ranks of one job) wait for
    the first build instead of racing it. Two jobs at most: a wider first
    build starves the timing-sensitive ring tests that run beside it. TUNE=native is safe here: the build
    always runs on the machine that executes the library (the repo
    ships no .so)."""
    os.makedirs(os.path.dirname(_BUILD_LOCK), exist_ok=True)
    with open(_BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            proc = subprocess.run(
                ["make", "-s", "-j2", "-C", _NATIVE_DIR, "TUNE=native"],
                capture_output=True, text=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if proc.returncode != 0:
        raise TransportError(
            f"building {_LIB_PATH} failed:\n{proc.stdout}{proc.stderr}")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if _NATIVE_LIB is None:
            _build_library()
        elif not os.path.exists(_LIB_PATH):
            # No fallback to the production build: that would hide
            # which library ran.
            raise TransportError(
                f"TDR_NATIVE_LIB={_NATIVE_LIB!r}: no such file "
                f"({_LIB_PATH})")
        lib = ctypes.CDLL(_LIB_PATH)
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    P = ctypes.c_void_p
    lib.tdr_last_error.restype = ctypes.c_char_p
    lib.tdr_copy_pool_workers.restype = ctypes.c_size_t
    lib.tdr_copy_counters.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.tdr_engine_open.restype = P
    lib.tdr_engine_open.argtypes = [ctypes.c_char_p]
    lib.tdr_engine_close.argtypes = [P]
    lib.tdr_engine_kind.restype = ctypes.c_int
    lib.tdr_engine_kind.argtypes = [P]
    lib.tdr_engine_name.restype = ctypes.c_char_p
    lib.tdr_engine_name.argtypes = [P]
    lib.tdr_engine_set_qp_limit.restype = None
    lib.tdr_engine_set_qp_limit.argtypes = [P, ctypes.c_int]
    lib.tdr_engine_qp_limit.restype = ctypes.c_int
    lib.tdr_engine_qp_limit.argtypes = [P]
    lib.tdr_engine_qp_live.restype = ctypes.c_int
    lib.tdr_engine_qp_live.argtypes = [P]
    lib.tdr_reg_mr.restype = P
    lib.tdr_reg_mr.argtypes = [P, P, ctypes.c_size_t, ctypes.c_int]
    lib.tdr_reg_dmabuf_mr.restype = P
    lib.tdr_reg_dmabuf_mr.argtypes = [
        P, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_uint64, ctypes.c_int,
    ]
    lib.tdr_dereg_mr.argtypes = [P]
    for fn in ("tdr_mr_lkey", "tdr_mr_rkey"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [P]
    for fn in ("tdr_mr_addr", "tdr_mr_len"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [P]
    lib.tdr_mr_invalidate.argtypes = [P]
    lib.tdr_listen.restype = P
    lib.tdr_listen.argtypes = [P, ctypes.c_char_p, ctypes.c_int]
    lib.tdr_listen_timeout.restype = P
    lib.tdr_listen_timeout.argtypes = [P, ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int]
    lib.tdr_listen_tier.restype = P
    lib.tdr_listen_tier.argtypes = [P, ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.tdr_connect_tier.restype = P
    lib.tdr_connect_tier.argtypes = [P, ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.tdr_fault_plan_clauses.restype = ctypes.c_int
    lib.tdr_fault_plan_hits.restype = ctypes.c_uint64
    lib.tdr_fault_plan_hits.argtypes = [ctypes.c_int]
    lib.tdr_fault_plan_seen.restype = ctypes.c_uint64
    lib.tdr_fault_plan_seen.argtypes = [ctypes.c_int]
    lib.tdr_fault_plan_reset.restype = None
    lib.tdr_crc32c.restype = ctypes.c_uint32
    lib.tdr_crc32c.argtypes = [P, ctypes.c_size_t, ctypes.c_uint32]
    lib.tdr_seal_counters.restype = None
    lib.tdr_seal_counters.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.tdr_seal_counters_reset.restype = None
    lib.tdr_seal_retry_budget.restype = ctypes.c_int
    lib.tdr_seal_context.restype = None
    lib.tdr_seal_context.argtypes = [P, ctypes.c_uint64, ctypes.c_uint64]
    lib.tdr_qp_has_seal.restype = ctypes.c_int
    lib.tdr_qp_has_seal.argtypes = [P]
    lib.tdr_connect.restype = P
    lib.tdr_connect.argtypes = [P, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.tdr_qp_close.argtypes = [P]
    lib.tdr_post_write.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_size_t, ctypes.c_uint64,
    ]
    lib.tdr_post_read.argtypes = lib.tdr_post_write.argtypes
    lib.tdr_post_send.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64,
    ]
    lib.tdr_post_recv.argtypes = lib.tdr_post_send.argtypes
    lib.tdr_post_recv_reduce.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64,
    ]
    lib.tdr_qp_has_recv_reduce.restype = ctypes.c_int
    lib.tdr_qp_has_recv_reduce.argtypes = [P]
    lib.tdr_post_send_foldback.argtypes = lib.tdr_post_send.argtypes
    lib.tdr_qp_has_send_foldback.restype = ctypes.c_int
    lib.tdr_qp_has_send_foldback.argtypes = [P]
    lib.tdr_poll.restype = ctypes.c_int
    lib.tdr_poll.argtypes = [P, ctypes.POINTER(Wc), ctypes.c_int, ctypes.c_int]
    lib.tdr_ring_create.restype = P
    lib.tdr_ring_create.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int]
    lib.tdr_ring_create_channels.restype = P
    lib.tdr_ring_create_channels.argtypes = [
        P, ctypes.POINTER(P), ctypes.POINTER(P), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tdr_ring_channels.restype = ctypes.c_int
    lib.tdr_ring_channels.argtypes = [P]
    lib.tdr_ring_chunk_bytes.restype = ctypes.c_size_t
    lib.tdr_ring_chunk_bytes.argtypes = []
    lib.tdr_ring_set_coll.restype = None
    lib.tdr_ring_set_coll.argtypes = [P, ctypes.c_uint64]
    lib.tdr_fold_pool_workers.restype = ctypes.c_size_t
    lib.tdr_qp_has_seal_payload.restype = ctypes.c_int
    lib.tdr_qp_has_seal_payload.argtypes = [P]
    lib.tdr_qp_has_coll_id.restype = ctypes.c_int
    lib.tdr_qp_has_coll_id.argtypes = [P]
    lib.tdr_qp_has_wire_q8.restype = ctypes.c_int
    lib.tdr_qp_has_wire_q8.argtypes = [P]
    lib.tdr_qp_probe.restype = ctypes.c_int
    lib.tdr_qp_probe.argtypes = [P, ctypes.c_int]
    lib.tdr_qp_set_link.restype = None
    lib.tdr_qp_set_link.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
    lib.tdr_ring_register.restype = ctypes.c_int
    lib.tdr_ring_register.argtypes = [P, P, ctypes.c_size_t]
    lib.tdr_ring_unregister.restype = ctypes.c_int
    lib.tdr_ring_unregister.argtypes = [P, P]
    lib.tdr_ring_adopt_mr.restype = ctypes.c_int
    lib.tdr_ring_adopt_mr.argtypes = [P, P, P]
    lib.tdr_qp_has_fused2.restype = ctypes.c_int
    lib.tdr_qp_has_fused2.argtypes = [P]
    lib.tdr_qp_rr_window.restype = ctypes.c_size_t
    lib.tdr_qp_rr_window.argtypes = [P]
    lib.tdr_ring_last_schedule.restype = ctypes.c_int
    lib.tdr_ring_last_schedule.argtypes = [P]
    lib.tdr_ring_allreduce.restype = ctypes.c_int
    lib.tdr_ring_allreduce.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
    ]
    lib.tdr_ring_start.restype = P
    lib.tdr_ring_start.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
    ]
    lib.tdr_ring_start_reduce_scatter.restype = P
    lib.tdr_ring_start_reduce_scatter.argtypes = \
        lib.tdr_ring_start.argtypes
    lib.tdr_ring_start_all_gather.restype = P
    lib.tdr_ring_start_all_gather.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.tdr_ring_allreduce_q8.restype = ctypes.c_int
    lib.tdr_ring_allreduce_q8.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_float, P,
    ]
    lib.tdr_ring_start_q8.restype = P
    lib.tdr_ring_start_q8.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_float, P,
    ]
    lib.tdr_ring_owned_segment.restype = ctypes.c_int
    lib.tdr_ring_owned_segment.argtypes = [
        P, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.tdr_ring_test.restype = ctypes.c_int
    lib.tdr_ring_test.argtypes = [P]
    lib.tdr_ring_wait.restype = ctypes.c_int
    lib.tdr_ring_wait.argtypes = [P, ctypes.c_int]
    lib.tdr_ring_op_error.restype = ctypes.c_char_p
    lib.tdr_ring_op_error.argtypes = [P]
    lib.tdr_ring_op_done.restype = ctypes.c_int
    lib.tdr_ring_op_done.argtypes = [P]
    lib.tdr_ring_op_free.restype = None
    lib.tdr_ring_op_free.argtypes = [P]
    lib.tdr_ring_reduce_scatter.restype = ctypes.c_int
    lib.tdr_ring_reduce_scatter.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.tdr_ring_all_gather.restype = ctypes.c_int
    lib.tdr_ring_all_gather.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.tdr_ring_broadcast.restype = ctypes.c_int
    lib.tdr_ring_broadcast.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.tdr_ring_reduce.restype = ctypes.c_int
    lib.tdr_ring_reduce.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tdr_ring_alltoall.restype = ctypes.c_int
    lib.tdr_ring_alltoall.argtypes = [
        P, P, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.tdr_ring_destroy.argtypes = [P]
    # Flight recorder (telemetry.cc): event ring, histograms, and the
    # unified counter registry.
    lib.tdr_tel_enabled.restype = ctypes.c_int
    lib.tdr_tel_reset.restype = None
    lib.tdr_tel_now_ns.restype = ctypes.c_uint64
    lib.tdr_tel_drain.restype = ctypes.c_int
    lib.tdr_tel_drain.argtypes = [ctypes.POINTER(TelEventC), ctypes.c_int]
    lib.tdr_tel_recorded.restype = ctypes.c_uint64
    lib.tdr_tel_dropped.restype = ctypes.c_uint64
    lib.tdr_tel_event_name.restype = ctypes.c_char_p
    lib.tdr_tel_event_name.argtypes = [ctypes.c_int]
    lib.tdr_tel_hist_count.restype = ctypes.c_int
    lib.tdr_tel_hist_name.restype = ctypes.c_char_p
    lib.tdr_tel_hist_name.argtypes = [ctypes.c_int]
    lib.tdr_tel_hist_read.restype = None
    lib.tdr_tel_hist_read.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.tdr_tel_hist_fine_buckets.restype = ctypes.c_int
    lib.tdr_tel_hist_fine_upper.restype = ctypes.c_uint64
    lib.tdr_tel_hist_fine_upper.argtypes = [ctypes.c_int]
    lib.tdr_tel_hist_read_fine.restype = ctypes.c_int
    lib.tdr_tel_hist_read_fine.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.tdr_progress_shards.restype = ctypes.c_int
    lib.tdr_progress_shards.argtypes = [ctypes.c_int]
    lib.tdr_tel_engine_id.restype = ctypes.c_int
    lib.tdr_tel_engine_id.argtypes = [P]
    lib.tdr_tel_qp_id.restype = ctypes.c_int
    lib.tdr_tel_qp_id.argtypes = [P]
    lib.tdr_counter_count.restype = ctypes.c_int
    lib.tdr_counter_name.restype = ctypes.c_char_p
    lib.tdr_counter_name.argtypes = [ctypes.c_int]
    lib.tdr_counters_read.restype = ctypes.c_int
    lib.tdr_counters_read.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_int]


# Completion statuses that signal a TRANSIENT condition — a peer died
# or a connection dropped (flush), a wedge/injected fault (general),
# or detected-and-uncorrectable payload corruption (integrity — the
# per-chunk retransmit budget already failed to heal it, so the next
# rung of the ladder is a world rebuild): the world can be rebuilt and
# the operation retried. Access errors (REM/LOC) are
# lifetime/programming bugs; retrying cannot fix them.
_RETRYABLE_STATUSES = frozenset({WC_FLUSH_ERR, WC_GENERAL_ERR,
                                 WC_INTEGRITY_ERR})
_WC_STATUS_RE = re.compile(r"status (\d+)")
# Message markers for error paths that carry no WC status: stalls and
# connection loss are transient; everything unrecognized is fatal by
# default (recovery must be opted into by evidence, not guessed).
_RETRYABLE_MARKERS = (
    "timeout",            # poll/accept/connect deadlines — a wedge
    "connection down",    # post against a dead QP
    "fault injected",     # TDR_FAULT_PLAN transient
    "stale ring generation",  # fenced previous-incarnation traffic
    "never connected",    # rendezvous peer missing
    "ring destroyed",     # teardown raced a pending async handle
    "deadline exceeded",  # hard per-collective deadline
    "peer hung",          # probe sent, no pong — wedged peer process
)


def _classify_retryable(message: str, status: Optional[int]) -> bool:
    if status is not None:
        return status in _RETRYABLE_STATUSES
    low = message.lower()
    return any(marker in low for marker in _RETRYABLE_MARKERS)


class TransportError(RuntimeError):
    """Transport failure with an error taxonomy.

    ``status`` is the WC status the failure surfaced with (parsed from
    the native message when not passed explicitly); ``retryable`` says
    whether the condition is transient — peer death, connection drop,
    stall deadline, injected fault — i.e. whether tearing the world
    down and rebuilding it (``RingWorld.rebuild``) can succeed. Access
    errors, schedule mismatches, and misuse are fatal: ``retryable``
    is False and the elastic layer re-raises them.
    """

    def __init__(self, message: str, status: Optional[int] = None,
                 retryable: Optional[bool] = None):
        super().__init__(message)
        text = str(message)
        if status is None:
            m = _WC_STATUS_RE.search(text)
            if m:
                status = int(m.group(1))
        self.status = status
        self.retryable = (_classify_retryable(text, status)
                          if retryable is None else bool(retryable))

    @property
    def kind(self) -> str:
        """Coarse failure class: ``"integrity"`` for detected payload
        corruption / stale-incarnation fences (retryable via the
        elastic ladder), ``"hung"`` for a peer that stopped answering
        probes while its connection stayed up (distinct from a
        conn-drop: the process exists but is wedged — postmortems
        should look at the PEER, not the wire), ``"transport"`` for
        everything else."""
        low = str(self).lower()
        if self.status == WC_INTEGRITY_ERR or "integrity" in low:
            return "integrity"
        if "peer hung" in low:
            return "hung"
        return "transport"


def copy_pool_workers() -> int:
    """Worker count of the native parallel copy/reduce pool (the
    emulated NIC's DMA-engine array; TDR_COPY_THREADS overrides)."""
    return int(_load().tdr_copy_pool_workers())


def fold_pool_workers() -> int:
    """Worker count of the fold-offload pool (TDR_FOLD_THREADS): the
    threads that run the ring's scratch-window folds off the poll
    loop. 0 = folds run inline (1-core hosts or the knob set to 0)."""
    return int(_load().tdr_fold_pool_workers())


def ring_chunk_bytes() -> int:
    """EFFECTIVE ring chunk size in bytes (TDR_RING_CHUNK override or
    the native built-in default) — the value schedule digests hash:
    the raw env string would hide a changed built-in default."""
    return int(_load().tdr_ring_chunk_bytes())


def ring_channels_default() -> int:
    """The channel count RingWorld uses when TDR_RING_CHANNELS is
    unset (clamped to [1, 16])."""
    env = os.environ.get("TDR_RING_CHANNELS", "")
    try:
        v = int(env) if env else 4
    except ValueError:
        v = 4
    return max(1, min(v, 16))


def progress_shards(channels: Optional[int] = None) -> int:
    """Resolved progress-shard count for a ring with ``channels``
    channels, as the NATIVE layer parses TDR_PROGRESS_SHARDS (the
    schedule digest never carries this — progress sharding is
    per-process execution strategy). 0 = the legacy single-poll loop
    (forced by TDR_PROGRESS_SHARDS=0, and the default on 1-core
    hosts); otherwise one dedicated poll thread per channel group."""
    ch = ring_channels_default() if channels is None else int(channels)
    return int(_load().tdr_progress_shards(ch))


def copy_counters() -> Tuple[int, int]:
    """(nt_bytes, plain_bytes) moved via the streaming vs cached copy
    tiers since process start — which path carried the traffic."""
    nt = ctypes.c_uint64()
    plain = ctypes.c_uint64()
    _load().tdr_copy_counters(ctypes.byref(nt), ctypes.byref(plain))
    return int(nt.value), int(plain.value)


# ------------------------------------------------------------------
# Flight recorder (native telemetry.cc): raw ctypes surface. The
# ergonomic API — merged native+Python timelines, Perfetto export,
# histogram percentiles — lives in rocnrdma_tpu_torch/telemetry/.

def telemetry_enabled() -> bool:
    """Whether the native flight recorder is recording (TDR_TELEMETRY
    as the engine parsed it — one branch per event site when off)."""
    return bool(_load().tdr_tel_enabled())


def telemetry_reset() -> None:
    """Re-read TDR_TELEMETRY / TDR_TELEMETRY_RING and clear the native
    ring, histograms, and recorded/dropped counts (set the env, then
    call this — the tdr_fault_plan_reset idiom). The tracer's device
    spans follow the recorder's state."""
    _load().tdr_tel_reset()
    trace.time_devices(telemetry_enabled())


def telemetry_now_ns() -> int:
    """The recorder's clock (CLOCK_MONOTONIC ns) — the same clock
    Python's time.monotonic() reads on Linux, anchoring the merged
    timeline's single clock domain."""
    return int(_load().tdr_tel_now_ns())


def telemetry_recorded() -> int:
    return int(_load().tdr_tel_recorded())


def telemetry_dropped() -> int:
    return int(_load().tdr_tel_dropped())


def telemetry_event_name(ev_type: int) -> str:
    return _load().tdr_tel_event_name(ev_type).decode()


def telemetry_drain(max_events: int = 65536) -> List[TelEventC]:
    """Remove up to ``max_events`` events from the native ring, oldest
    first (raw structs)."""
    lib = _load()
    out: List[TelEventC] = []
    batch = 4096
    while len(out) < max_events:
        want = min(batch, max_events - len(out))
        arr = (TelEventC * want)()
        n = lib.tdr_tel_drain(arr, want)
        out.extend(arr[i] for i in range(n))
        if n < want:
            break
    return out


def telemetry_histograms() -> dict:
    """All native histograms in the legacy 64-octave view: name -> 64
    bucket counts (bucket b counts values in [2^(b-1), 2^b); bucket 0
    zeros). Derived by folding the fine rows — percentile consumers
    should use ``telemetry_histograms_fine`` for sub-octave
    resolution."""
    lib = _load()
    out = {}
    for i in range(int(lib.tdr_tel_hist_count())):
        buckets = (ctypes.c_uint64 * 64)()
        lib.tdr_tel_hist_read(i, buckets)
        out[lib.tdr_tel_hist_name(i).decode()] = [int(v) for v in buckets]
    return out


def telemetry_hist_fine_buckets() -> int:
    """Length of a fine (log2 × 8) histogram row."""
    return int(_load().tdr_tel_hist_fine_buckets())


def telemetry_hist_fine_upper(idx: int) -> int:
    """Inclusive upper edge of fine bucket ``idx`` — read from the
    native layer so Python percentile estimates can never drift from
    the recorder's bucket assignment."""
    return int(_load().tdr_tel_hist_fine_upper(idx))


def telemetry_histograms_fine() -> dict:
    """All native histograms at fine (log2 × 8) resolution: name ->
    TDR_HIST_FINE_BUCKETS counts, 8 linear sub-buckets per octave
    (values 0..15 exact) — relative quantization error <= 12.5%, so
    percentile estimates are real numbers, not octave edges."""
    lib = _load()
    n = int(lib.tdr_tel_hist_fine_buckets())
    out = {}
    for i in range(int(lib.tdr_tel_hist_count())):
        buckets = (ctypes.c_uint64 * n)()
        lib.tdr_tel_hist_read_fine(i, buckets, n)
        out[lib.tdr_tel_hist_name(i).decode()] = [int(v) for v in buckets]
    return out


_counter_names: List[str] = []


def native_counters() -> dict:
    """One snapshot of the unified native counter registry
    (integrity.*, fault.*, copy.*, telemetry.*) — a single native
    call, so delta accounting has no multi-call double-count window.
    Counters sharing a producer (fault seen/hits, copy tiers) are
    read in one pass natively; cross-subsystem counters are
    individually-atomic monotonic reads."""
    lib = _load()
    global _counter_names
    if not _counter_names:
        _counter_names = [lib.tdr_counter_name(i).decode()
                          for i in range(int(lib.tdr_counter_count()))]
    arr = (ctypes.c_uint64 * len(_counter_names))()
    n = lib.tdr_counters_read(arr, len(_counter_names))
    return {name: int(arr[i]) for i, name in enumerate(_counter_names[:n])}


# ------------------------------------------------------------------
# Fault-plan introspection (TDR_FAULT_PLAN, native fault.cc): tests and
# the recovery layer read per-clause hit counters so an injected fault
# is OBSERVABLE — asserted, traced, never assumed.

_fault_hits_noted = [0]


def fault_plan_clauses() -> int:
    """Number of parsed TDR_FAULT_PLAN clauses (0 = no plan)."""
    return int(_load().tdr_fault_plan_clauses())


def fault_plan_hits(idx: int) -> int:
    """Times clause ``idx`` fired (injected its action)."""
    return int(_load().tdr_fault_plan_hits(idx))


def fault_plan_seen(idx: int) -> int:
    """Site arrivals clause ``idx`` matched (fired or not)."""
    return int(_load().tdr_fault_plan_seen(idx))


def fault_plan_reset() -> None:
    """Re-parse TDR_FAULT_PLAN from the environment, zeroing every
    counter (tests set the env var, then call this)."""
    _load().tdr_fault_plan_reset()
    _fault_hits_noted[0] = 0


def note_fault_injections() -> int:
    """Emit a ``fault.injected`` trace event for hits since the last
    call (the recovery path calls this so injected faults show up in
    the same observable stream as ``world.rebuild``/``trainer.resume``).
    Returns the number of new hits. Reads the native counter registry
    — one snapshot, not a per-clause poll loop."""
    with _note_lock:
        total = native_counters()["fault.hits"]
        new = total - _fault_hits_noted[0]
        if new > 0:
            _fault_hits_noted[0] = total
            trace.event("fault.injected", hits=new, total=total)
        return max(new, 0)


# ------------------------------------------------------------------
# Sealed-chunk integrity introspection: CRC32C for tests, the native
# sealed/verified/failed/retransmitted counters, and their bridge into
# the tracer's ``integrity.*`` namespace.

def crc32c(data: bytes, seed: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``; pass the previous return value
    as ``seed`` to extend a running checksum."""
    return int(_load().tdr_crc32c(data, len(data), seed))


_SEAL_COUNTER_NAMES = ("sealed", "verified", "failed", "retransmitted")


def seal_counters() -> dict:
    """Process-wide integrity counters: frames sealed at send,
    landings verified ok, verification failures, retransmissions."""
    arr = (ctypes.c_uint64 * 4)()
    _load().tdr_seal_counters(arr)
    return dict(zip(_SEAL_COUNTER_NAMES, (int(v) for v in arr)))


def seal_counters_reset() -> None:
    _load().tdr_seal_counters_reset()
    with _note_lock:
        _integrity_noted.clear()
        _integrity_noted.update({k: 0 for k in _SEAL_COUNTER_NAMES})


def seal_retry_budget() -> int:
    """The per-chunk retransmit budget AS THE ENGINE PARSES IT
    (TDR_SEAL_RETRY, default 3) — the one source of truth the schedule
    digest records."""
    return int(_load().tdr_seal_retry_budget())


_integrity_noted = {k: 0 for k in _SEAL_COUNTER_NAMES}
# Serializes the delta accounting of note_integrity and
# note_fault_injections: the old poll-then-add bridge could run the
# native read and the noted-state update in two racing callers and
# double-count a window of increments into the tracer.
_note_lock = threading.Lock()


def note_integrity() -> dict:
    """Fold native integrity-counter deltas since the last call into
    the tracer as ``integrity.sealed`` / ``integrity.verified`` /
    ``integrity.failed`` / ``integrity.retransmitted`` — the recovery
    path and tests observe the whole detect→retransmit ladder in the
    same stream as ``world.rebuild``/``trainer.resume``. Returns the
    deltas. Reads the unified native counter registry: one snapshot
    call under one lock, so concurrent callers cannot double-count
    (the poll-bridge race this replaced)."""
    with _note_lock:
        snap = native_counters()
        deltas = {}
        for k in _SEAL_COUNTER_NAMES:
            v = snap[f"integrity.{k}"]
            d = v - _integrity_noted.get(k, 0)
            if d > 0:
                trace.add(f"integrity.{k}", d)
            deltas[k] = max(d, 0)
            _integrity_noted[k] = v
        return deltas


def _check(cond, what: str):
    if not cond:
        err = _load().tdr_last_error().decode()
        # The native layer already labels its errors; avoid doubling
        # the prefix when it does.
        if err and err.split(":")[0] in what:
            raise TransportError(err)
        raise TransportError(f"{what}: {err or 'unknown error'}")


def _live(handle, what: str):
    if not handle:
        raise TransportError(f"{what}: object already closed")
    return handle


@dataclass(frozen=True)
class Completion:
    wr_id: int
    status: int
    opcode: int
    length: int

    @property
    def ok(self) -> bool:
        return self.status == WC_SUCCESS


class MemoryRegion:
    """A registered memory region. Mirrors the lifetime the reference
    front-loads into ``ibv_reg_mr`` (SURVEY.md §3.2): after creation,
    transfers touching it involve no registration-layer software."""

    def __init__(self, engine: "Engine", handle: int):
        self._engine = engine
        self._h = handle

    @property
    def lkey(self) -> int:
        return _load().tdr_mr_lkey(_live(self._h, "mr.lkey"))

    @property
    def rkey(self) -> int:
        return _load().tdr_mr_rkey(_live(self._h, "mr.rkey"))

    @property
    def addr(self) -> int:
        return _load().tdr_mr_addr(_live(self._h, "mr.addr"))

    @property
    def length(self) -> int:
        return _load().tdr_mr_len(_live(self._h, "mr.length"))

    def invalidate(self) -> None:
        """Revoke remote access (the free-while-registered flow,
        amdp2p.c:88-109). Safe to call multiple times; dereg after
        invalidate is also safe (amdp2p.c:299-302 semantics)."""
        if self._h:
            rkey = self.rkey
            _load().tdr_mr_invalidate(self._h)
            trace.event("mr.invalidate", rkey=rkey)

    def deregister(self) -> None:
        if self._h:
            h, self._h = self._h, None
            _load().tdr_dereg_mr(h)
            trace.event("mr.dereg")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deregister()


class QueuePair:
    def __init__(self, engine: "Engine", handle: int):
        self._engine = engine
        self._h = handle

    def post_write(self, mr: MemoryRegion, loff: int, raddr: int, rkey: int,
                   length: int, wr_id: int = 0) -> None:
        rc = _load().tdr_post_write(_live(self._h, "post_write"),
                                    _live(mr._h, "post_write mr"), loff,
                                    raddr, rkey, length, wr_id)
        _check(rc == 0, "post_write")

    def post_read(self, mr: MemoryRegion, loff: int, raddr: int, rkey: int,
                  length: int, wr_id: int = 0) -> None:
        rc = _load().tdr_post_read(_live(self._h, "post_read"),
                                   _live(mr._h, "post_read mr"), loff,
                                   raddr, rkey, length, wr_id)
        _check(rc == 0, "post_read")

    def post_send(self, mr: MemoryRegion, loff: int, length: int,
                  wr_id: int = 0) -> None:
        rc = _load().tdr_post_send(_live(self._h, "post_send"),
                                   _live(mr._h, "post_send mr"), loff,
                                   length, wr_id)
        _check(rc == 0, "post_send")

    def post_recv(self, mr: MemoryRegion, loff: int, maxlen: int,
                  wr_id: int = 0) -> None:
        rc = _load().tdr_post_recv(_live(self._h, "post_recv"),
                                   _live(mr._h, "post_recv mr"), loff,
                                   maxlen, wr_id)
        _check(rc == 0, "post_recv")

    def post_recv_reduce(self, mr: MemoryRegion, loff: int, maxlen: int,
                         dtype: int, red_op: int = RED_SUM,
                         wr_id: int = 0) -> None:
        """Fused reduce-on-receive: the inbound SEND payload is folded
        into the buffer (dst op= src) by the progress engine —
        capability-gated (``has_recv_reduce``)."""
        rc = _load().tdr_post_recv_reduce(
            _live(self._h, "post_recv_reduce"),
            _live(mr._h, "post_recv_reduce mr"), loff, maxlen, dtype,
            red_op, wr_id)
        _check(rc == 0, "post_recv_reduce")

    def post_send_foldback(self, mr: MemoryRegion, loff: int, length: int,
                           wr_id: int = 0) -> None:
        """Fold-and-write-back send: the peer folds this payload into
        its matched reduce-recv buffer and the folded result lands
        back in place over [loff, loff+length); the send completion
        means the exchange is finished on both sides."""
        rc = _load().tdr_post_send_foldback(
            _live(self._h, "post_send_foldback"),
            _live(mr._h, "post_send_foldback mr"), loff, length, wr_id)
        _check(rc == 0, "post_send_foldback")

    @property
    def has_recv_reduce(self) -> bool:
        return bool(_load().tdr_qp_has_recv_reduce(
            _live(self._h, "has_recv_reduce")))

    @property
    def has_send_foldback(self) -> bool:
        return bool(_load().tdr_qp_has_send_foldback(
            _live(self._h, "has_send_foldback")))

    @property
    def has_fused2(self) -> bool:
        """Both ends negotiated the world-2 fused exchange schedule."""
        return bool(_load().tdr_qp_has_fused2(
            _live(self._h, "has_fused2")))

    @property
    def has_seal(self) -> bool:
        """Both ends negotiated sealed payload framing (CRC32C +
        incarnation tag, NAK-driven chunk retransmit). Emu-only; the
        verbs wire carries its own ICRC."""
        return bool(_load().tdr_qp_has_seal(_live(self._h, "has_seal")))

    @property
    def has_seal_payload(self) -> bool:
        """Whether the negotiated seal's CRC covers the PAYLOAD bytes:
        always on the TCP stream tier; on the CMA tier only when both
        ends set TDR_SEAL_CMA=1 (the default there is tag-only — the
        kernel-memcpy \"wire\" has no payload bit-flip failure mode,
        the same rationale as the verbs backend's ICRC stance)."""
        return bool(_load().tdr_qp_has_seal_payload(
            _live(self._h, "has_seal_payload")))

    @property
    def has_coll_id(self) -> bool:
        """Both ends negotiated wire-carried collective trace ids
        (FEAT_COLL_ID): frame headers carry the posting rank's coll id
        so the peer's telemetry events join by key. Advertised only
        when TDR_TELEMETRY was on at handshake time — with the feature
        off, frames are byte-identical to the pre-trace-id format."""
        return bool(_load().tdr_qp_has_coll_id(
            _live(self._h, "has_coll_id")))

    @property
    def has_wire_q8(self) -> bool:
        """Both ends negotiated int8 wire compression (FEAT_WIRE_Q8):
        the ring may run the quantized scale-carrying schedule
        (``Ring.allreduce_q8``) over this link. The compressed pieces
        are ordinary sealed SEND payloads — frames are byte-identical
        with the feature off; the bit gates the SCHEDULE and lets the
        health ladder query per-link int8 capability. TDR_NO_WIRE_Q8
        suppresses the advertisement."""
        return bool(_load().tdr_qp_has_wire_q8(
            _live(self._h, "has_wire_q8")))

    @property
    def telemetry_id(self) -> int:
        """Flight-recorder track id of this QP (bring-up ordinal;
        names the per-QP timeline in Perfetto exports)."""
        return int(_load().tdr_tel_qp_id(_live(self._h, "telemetry_id")))

    def probe(self, timeout_ms: int = 1000) -> int:
        """Hung-peer probe: PING the peer's progress thread and wait
        for the echoed PONG. Returns 1 (peer alive — it drained its
        socket even if the collective is stalled), 0 (no pong inside
        the window — peer hung), -1 (connection down), or -2 (probing
        not negotiated: legacy peer or TDR_NO_PROBE — wire frames stay
        byte-identical with the feature off)."""
        return int(_load().tdr_qp_probe(_live(self._h, "probe"),
                                        int(timeout_ms)))

    def set_link(self, lane: int, rank: int, peer: int) -> None:
        """Stamp link identity (channel lane, local rank, peer rank)
        onto this QP: netem fault riders scope by these labels and
        stall attribution reports them. Ring bring-up stamps them
        natively; this is for QPs used outside a ring."""
        _load().tdr_qp_set_link(_live(self._h, "set_link"),
                                int(lane), int(rank), int(peer))

    def poll(self, max_wc: int = 16, timeout_ms: int = -1) -> List[Completion]:
        arr = (Wc * max_wc)()
        n = _load().tdr_poll(_live(self._h, "poll"), arr, max_wc, timeout_ms)
        _check(n >= 0, "poll")
        return [
            Completion(arr[i].wr_id, arr[i].status, arr[i].opcode, arr[i].len)
            for i in range(n)
        ]

    def wait(self, wr_id: int, timeout_ms: int = 10000) -> Completion:
        """Poll until the completion for wr_id arrives; other
        completions raise (protocol error in simple callers)."""
        got = self.poll(max_wc=1, timeout_ms=timeout_ms)
        if not got:
            raise TransportError(f"timeout waiting for wr_id={wr_id}")
        if got[0].wr_id != wr_id:
            raise TransportError(
                f"unexpected completion wr_id={got[0].wr_id}, want {wr_id}")
        return got[0]

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            _load().tdr_qp_close(h)
            trace.event("qp.close")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RingOp:
    """Handle for one nonblocking ring collective (``allreduce_async``).

    Holds a reference to the data buffer (the native op posts against
    it until completion). Failure is handle-scoped: ``wait``/``test``
    raise a :class:`TransportError` carrying the same status labels as
    the blocking API, so the retryable/fatal taxonomy — and the
    elastic rebuild ladder above it — applies unchanged."""

    def __init__(self, handle: int, array):
        self._h = handle
        self._array = array  # keep the buffer alive until completion

    @property
    def done(self) -> bool:
        """Completed (ok or failed) and released."""
        return self._h is None

    def test(self) -> bool:
        """True when the op completed OK (and releases the handle);
        False while still in flight; raises on a failed op."""
        if self._h is None:
            return True
        rc = _load().tdr_ring_test(self._h)
        if rc == 0:
            return False
        self._finish(rc)
        return True

    def wait(self, timeout_ms: int = -1) -> None:
        """Block until the op completes (forever by default — the
        collective's own stall deadline bounds a wedged ring). A
        positive timeout that expires raises a retryable timeout error
        and leaves the handle live (wait again or let close() reap)."""
        if self._h is None:
            return
        rc = _load().tdr_ring_wait(self._h, int(timeout_ms))
        if rc != 0:
            # Distinguish a wait TIMEOUT from an op FAILURE — and
            # re-check the op, not the error string: the collective
            # may have completed (either way) between the native wait
            # expiring and now, and reporting a completed-ok op as
            # failed would tear down a world whose peers all
            # succeeded.
            t = _load().tdr_ring_test(self._h)
            if t == 0:
                raise TransportError(
                    "timeout waiting for async collective "
                    "(still in flight)")
            rc = 0 if t > 0 else -1
        self._finish(rc)

    def _finish(self, rc: int) -> None:
        """Consume the completed op: free the native handle and raise
        the recorded, taxonomy-classified error on failure."""
        err = ""
        if rc != 0:
            err = _load().tdr_ring_op_error(self._h).decode() or \
                _load().tdr_last_error().decode() or "async collective failed"
        h, self._h = self._h, None
        self._array = None
        _load().tdr_ring_op_free(h)
        if rc != 0:
            raise TransportError(err)

    def __del__(self):
        # Backstop only: free a COMPLETED but never-consumed op.
        # A pending op is deliberately leaked here (op_free would
        # block GC until the collective terminates); ring destroy
        # fails pending ops promptly and close paths wait handles.
        # tdr_ring_op_done, NOT tdr_ring_test: a finalizer runs at an
        # arbitrary GC point and must never write the thread-local
        # error slot another native call is about to read.
        h = getattr(self, "_h", None)
        if h is not None and _load().tdr_ring_op_done(h):
            self._h = None
            _load().tdr_ring_op_free(h)


class Ring:
    """Native ring-allreduce context over neighbor QPs.

    ``left``/``right`` may each be a single QueuePair (the classic
    single-QP ring) or a sequence of QueuePairs — one per channel —
    in which case the striped schedules route chunk i over channel
    i % channels (``lefts[c]`` here must be connected to ``rights[c]``
    on the left neighbor; RingWorld's bootstrap guarantees it by
    bringing channels up in index order)."""

    def __init__(self, engine: "Engine", left, right, rank: int,
                 world: int):
        lefts = list(left) if isinstance(left, (list, tuple)) else [left]
        rights = (list(right) if isinstance(right, (list, tuple))
                  else [right])
        if len(lefts) != len(rights) or not lefts:
            raise TransportError("ring_create: mismatched channel lists")
        n = len(lefts)
        P = ctypes.c_void_p
        la = (P * n)(*[_live(q._h, "ring_create left") for q in lefts])
        ra = (P * n)(*[_live(q._h, "ring_create right") for q in rights])
        self._h = _load().tdr_ring_create_channels(engine._h, la, ra, n,
                                                   rank, world)
        _check(self._h, "ring_create")
        self.rank, self.world = rank, world

    @property
    def channels(self) -> int:
        """Channel count (independent QPs per neighbor) of this ring."""
        return int(_load().tdr_ring_channels(_live(self._h, "channels")))

    def set_coll(self, coll_id: int) -> None:
        """Stamp the collective trace id for the NEXT collective on
        this ring (blocking call or async start). The id tags every
        native telemetry event of that collective and rides the frame
        header to the peer when FEAT_COLL_ID was negotiated, making
        two ranks' events joinable by key in a merged fleet timeline.
        Observational only — never negotiated, never in the digest."""
        _load().tdr_ring_set_coll(_live(self._h, "ring_set_coll"),
                                  int(coll_id))

    def register_buffer(self, array) -> None:
        """Front-load MR registration for a buffer the caller promises
        stable for the ring's lifetime; subsequent allreduces on it do
        no registration work (the reference's zero-software-hot-path
        invariant). Unregistered buffers still work — registered per
        call."""
        addr, _, nbytes = buffer_args(array, "ring_register")
        rc = _load().tdr_ring_register(
            _live(self._h, "ring_register"), addr, nbytes)
        _check(rc == 0, "ring_register")

    def unregister_buffer(self, array) -> None:
        """Drop the front-loaded MR for a buffer registered with
        ``register_buffer`` (call before freeing the buffer)."""
        rc = _load().tdr_ring_unregister(
            _live(self._h, "ring_unregister"),
            buffer_args(array, "ring_unregister")[0])
        _check(rc == 0, "ring_unregister")

    def adopt_mr(self, addr: int, mr: MemoryRegion) -> None:
        """Adopt a caller-owned MR (typically a dma-buf MR over device
        memory with iova == addr) as the data MR for allreduces on
        ``addr`` — the zero-copy collective path. The ring never
        deregisters an adopted MR; call ``drop_buffer(addr)`` before
        invalidating or deregistering it."""
        rc = _load().tdr_ring_adopt_mr(
            _live(self._h, "ring_adopt_mr"), addr,
            _live(mr._h, "ring_adopt_mr mr"))
        _check(rc == 0, "ring_adopt_mr")

    def drop_buffer(self, addr: int) -> None:
        """Drop the cached MR for ``addr`` (registered or adopted) by
        raw address. Adopted MRs stay alive — ownership is the
        caller's."""
        rc = _load().tdr_ring_unregister(
            _live(self._h, "ring_unregister"), addr)
        _check(rc == 0, "ring_unregister")

    def allreduce(self, array, op: int = RED_SUM) -> None:
        """In-place allreduce of a C-contiguous numpy array or CPU
        tensor (ctypes releases the GIL for the duration, so per-rank
        threads overlap)."""
        ptr, dt, n = self._array_args(array, "allreduce")
        rc = _load().tdr_ring_allreduce(_live(self._h, "ring_allreduce"),
                                        ptr, n, dt, op)
        _check(rc == 0, "ring_allreduce")

    def allreduce_async(self, array, op: int = RED_SUM) -> "RingOp":
        """Nonblocking allreduce: posts onto the ring's async driver
        and returns a :class:`RingOp` immediately. Ops execute strictly
        in submission order (the SPMD contract — every rank must start
        the same ops in the same order), bitwise-identical to the
        blocking call. The array must stay alive and untouched until
        the handle completes."""
        ptr, dt, n = self._array_args(array, "allreduce_async")
        h = _load().tdr_ring_start(_live(self._h, "ring_start"),
                                   ptr, n, dt, op)
        _check(h, "ring_start")
        return RingOp(h, array)

    def allreduce_q8(self, q8, scale: float, out) -> None:
        """int8 wire-compressed allreduce: ``q8`` (C-contiguous int8,
        scratch — destroyed) holds this rank's bucket quantized with
        the symmetric per-bucket ``scale`` (true value = q * scale;
        the caller computed scale = absmax/127 and keeps the
        error-feedback residual); ``out`` (float32, same element
        count) receives the dequantized sum, bitwise identical on
        every rank. Wire pieces are [f32 running scale][int8 segment]
        inside ordinary sealed payloads; requires FEAT_WIRE_Q8 on
        every channel QP (fails fast otherwise)."""
        ptr, _, n = self._array_args(q8, "allreduce_q8")
        optr, _, n_out = self._array_args(out, "allreduce_q8 out")
        if dtype_name(q8) != "int8" or dtype_name(out) != "float32":
            raise TransportError(
                "allreduce_q8 needs int8 q8 + float32 out")
        if n_out != n:
            raise TransportError("allreduce_q8: q8/out size mismatch")
        rc = _load().tdr_ring_allreduce_q8(
            _live(self._h, "ring_allreduce_q8"), ptr, n,
            float(scale), optr)
        _check(rc == 0, "ring_allreduce_q8")

    def allreduce_q8_async(self, q8, scale: float, out) -> "RingOp":
        """Nonblocking ``allreduce_q8`` on the same async driver (and
        submission-order SPMD contract) as ``allreduce_async``. BOTH
        buffers must stay alive and untouched until the handle
        completes (the RingOp pins them)."""
        ptr, _, n = self._array_args(q8, "allreduce_q8_async")
        optr, _, n_out = self._array_args(out, "allreduce_q8_async out")
        if dtype_name(q8) != "int8" or dtype_name(out) != "float32":
            raise TransportError(
                "allreduce_q8 needs int8 q8 + float32 out")
        if n_out != n:
            raise TransportError("allreduce_q8: q8/out size mismatch")
        h = _load().tdr_ring_start_q8(
            _live(self._h, "ring_start_q8"), ptr, n, float(scale),
            optr)
        _check(h, "ring_start_q8")
        return RingOp(h, (q8, out))

    def reduce_scatter_async(self, array, op: int = RED_SUM) -> "RingOp":
        """Nonblocking reduce-scatter on the same async driver (and
        under the same submission-order SPMD contract) as
        ``allreduce_async``. The ownership layout is the blocking
        call's; read the owned slice with ``owned_slice``."""
        ptr, dt, n = self._array_args(array, "reduce_scatter_async")
        h = _load().tdr_ring_start_reduce_scatter(
            _live(self._h, "ring_start_reduce_scatter"), ptr, n, dt, op)
        _check(h, "ring_start_reduce_scatter")
        return RingOp(h, array)

    def all_gather_async(self, array) -> "RingOp":
        """Nonblocking all-gather (the reduce-scatter's phase-2 twin)
        on the async driver; assumes the ownership layout
        ``reduce_scatter`` leaves."""
        ptr, dt, n = self._array_args(array, "all_gather_async")
        h = _load().tdr_ring_start_all_gather(
            _live(self._h, "ring_start_all_gather"), ptr, n, dt)
        _check(h, "ring_start_all_gather")
        return RingOp(h, array)

    def owned_slice(self, array) -> slice:
        """The flat-element slice this rank owns after a reduce-scatter
        of ``array`` — the native layout math (segment (rank+1) % world
        with remainder distribution), so async callers never re-derive
        it in Python."""
        _, dt, n = self._array_args(array, "owned_slice")
        off = ctypes.c_size_t()
        length = ctypes.c_size_t()
        rc = _load().tdr_ring_owned_segment(
            _live(self._h, "ring_owned_segment"), n, dt,
            ctypes.byref(off), ctypes.byref(length))
        _check(rc == 0, "ring_owned_segment")
        isz = _itemsize(array)
        return slice(off.value // isz, (off.value + length.value) // isz)

    def _array_args(self, array, what: str, need_dtype: bool = True):
        """(address, DT_* code, element count) of a ring buffer."""
        dt = _NUMPY_DTYPE_MAP.get(dtype_name(array))
        if dt is None and need_dtype:
            raise TransportError(f"unsupported dtype {array.dtype}")
        ptr, n, _ = buffer_args(array, what)
        return ptr, dt, n

    def reduce_scatter(self, array, op: int = RED_SUM) -> slice:
        """In-place ring reduce-scatter (the allreduce's phase 1).
        Returns the FLAT-element slice this rank owns afterwards — the
        fully-reduced segment (rank+1) % world; the rest of the buffer
        holds partial sums. The slice indexes ``array.reshape(-1)``
        (segmentation ignores dimensionality, exactly like allreduce's
        reduction does); apply it to the flat view, not to axis 0 of a
        multi-dimensional array. ``all_gather`` on the same buffer
        completes the allreduce."""
        ptr, dt, n = self._array_args(array, "reduce_scatter")
        own_off = ctypes.c_size_t()
        own_len = ctypes.c_size_t()
        rc = _load().tdr_ring_reduce_scatter(
            _live(self._h, "ring_reduce_scatter"), ptr, n, dt,
            op, ctypes.byref(own_off), ctypes.byref(own_len))
        _check(rc == 0, "ring_reduce_scatter")
        isz = _itemsize(array)
        return slice(own_off.value // isz,
                     (own_off.value + own_len.value) // isz)

    def all_gather(self, array) -> None:
        """In-place ring all-gather (the allreduce's phase 2):
        circulates each rank's owned segment — the (rank+1) % world
        layout ``reduce_scatter`` leaves — until every rank holds the
        full buffer."""
        ptr, dt, n = self._array_args(array, "all_gather")
        rc = _load().tdr_ring_all_gather(
            _live(self._h, "ring_all_gather"), ptr, n, dt)
        _check(rc == 0, "ring_all_gather")

    def all_to_all(self, array) -> None:
        """In-place MPI_Alltoall: ``array.reshape(-1)`` is ``world``
        equal segments — segment j is FOR rank j on entry and FROM
        rank j on return (this rank's own segment is untouched).
        ``array.size`` must divide evenly by the world size. Ring
        bundle-shrink schedule: w(w-1)/2 segments cross each link,
        the store-and-forward optimum for a ring topology."""
        ptr, dt, n = self._array_args(array, "all_to_all")
        rc = _load().tdr_ring_alltoall(
            _live(self._h, "ring_alltoall"), ptr, n, dt)
        _check(rc == 0, "ring_alltoall")

    def reduce(self, array, root: int, op: int = RED_SUM) -> None:
        """Root-reduce: after the call ROOT's buffer holds the
        reduction over all ranks. In-place and DESTRUCTIVE on
        non-root ranks (their buffers end holding the partial sums
        that passed through them on the way to root); one buffer-pass
        per link, folds riding the fused reduce-on-receive op."""
        ptr, dt, n = self._array_args(array, "reduce")
        rc = _load().tdr_ring_reduce(
            _live(self._h, "ring_reduce"), ptr, n, dt, op, root)
        _check(rc == 0, "ring_reduce")

    def broadcast(self, array, root: int) -> None:
        """Ring broadcast: root's buffer contents stream to every
        rank, store-and-forward per chunk (bandwidth-optimal for
        large messages; latency grows by world-1 chunks)."""
        # Byte-oriented: any dtype broadcasts (no folds happen).
        ptr, _, n = self._array_args(array, "broadcast", need_dtype=False)
        rc = _load().tdr_ring_broadcast(
            _live(self._h, "ring_broadcast"), ptr, n * _itemsize(array),
            root)
        _check(rc == 0, "ring_broadcast")

    @property
    def last_schedule(self) -> int:
        """Which SCHED_* the last allreduce on this ring ran — lets
        tests assert that negotiated capabilities actually selected
        the fused paths (not just that results are correct)."""
        return int(_load().tdr_ring_last_schedule(
            _live(self._h, "last_schedule")))

    def destroy(self) -> None:
        if self._h:
            _load().tdr_ring_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()


class Engine:
    """An open transport engine ("verbs" on real HCAs, "emu" anywhere)."""

    def __init__(self, spec: str = "auto"):
        self._h = _load().tdr_engine_open(spec.encode())
        _check(self._h, f"engine_open({spec})")
        # Worlds currently hosted on this engine (RingWorld attaches at
        # bootstrap, detaches at close). Multi-tenancy gates the
        # engine-wide seal-context stamp: the incarnation fence is only
        # meaningful while ONE world owns the engine — with co-tenant
        # worlds at different generations the stamp is cleared and
        # stale-world fencing falls back to the schedule-digest
        # generation check (per world, per collective). A WeakSet, so
        # an abandoned world (never closed — e.g. discarded after a
        # non-retryable rebuild failure) stops counting once collected
        # instead of permanently disabling the fence for its successor.
        import weakref

        self._worlds: "weakref.WeakSet" = weakref.WeakSet()
        trace.event("engine.open", kind=self.kind, backend=self.name)

    def attach_world(self, world) -> None:
        self._worlds.add(world)

    def detach_world(self, world) -> None:
        self._worlds.discard(world)

    @property
    def world_count(self) -> int:
        """Number of RingWorlds currently attached to this engine."""
        return len(self._worlds)

    def set_qp_limit(self, limit: int) -> None:
        """Cap live QPs on this engine (0 = unlimited). When the cap is
        reached, listen/connect fail fast with a non-retryable budget
        error — bring-up-time enforcement for engines shared by
        concurrent worlds."""
        _load().tdr_engine_set_qp_limit(_live(self._h, "set_qp_limit"),
                                        int(limit))

    @property
    def qp_limit(self) -> int:
        return int(_load().tdr_engine_qp_limit(
            _live(self._h, "qp_limit")))

    @property
    def qp_live(self) -> int:
        """Live QPs on this engine right now (all worlds combined)."""
        return int(_load().tdr_engine_qp_live(_live(self._h, "qp_live")))

    @property
    def kind(self) -> int:
        return _load().tdr_engine_kind(_live(self._h, "engine.kind"))

    @property
    def name(self) -> str:
        return _load().tdr_engine_name(_live(self._h, "engine.name")).decode()

    @property
    def telemetry_id(self) -> int:
        """Flight-recorder track id of this engine (open ordinal;
        names the per-rank/engine timeline in Perfetto exports)."""
        return int(_load().tdr_tel_engine_id(
            _live(self._h, "telemetry_id")))

    def reg_mr(self, buf, access: int = ACCESS_REMOTE_WRITE | ACCESS_REMOTE_READ
               ) -> MemoryRegion:
        """Register memory. ``buf`` is a numpy array, a CPU torch
        tensor, a bytearray, or an (addr, len) tuple for pre-resolved
        memory."""
        import numpy as np

        if isinstance(buf, tuple):
            addr, length = buf
        elif isinstance(buf, (np.ndarray, torch.Tensor)):
            addr, _, length = buffer_args(buf, "reg_mr")
        elif isinstance(buf, (bytearray, memoryview)):
            c = (ctypes.c_char * len(buf)).from_buffer(buf)
            addr, length = ctypes.addressof(c), len(buf)
        else:
            raise TransportError(f"cannot register {type(buf)}")
        h = _load().tdr_reg_mr(_live(self._h, "reg_mr"), addr, length,
                               access)
        _check(h, "reg_mr")
        trace.event("mr.reg", bytes=length)
        return MemoryRegion(self, h)

    def reg_dmabuf_mr(self, fd: int, offset: int, length: int, iova: int = 0,
                      access: int = ACCESS_REMOTE_WRITE | ACCESS_REMOTE_READ
                      ) -> MemoryRegion:
        """Register device memory behind a dma-buf fd — the modern
        equivalent of the reference's whole pin+map pipeline
        (amdp2p.c:169-264), performed by the kernel's dma-buf machinery
        instead of a custom peer-memory client."""
        h = _load().tdr_reg_dmabuf_mr(_live(self._h, "reg_dmabuf_mr"), fd,
                                      offset, length, iova, access)
        _check(h, "reg_dmabuf_mr")
        trace.event("mr.reg_dmabuf", bytes=length)
        return MemoryRegion(self, h)

    def set_seal_context(self, generation: int, step: int = 0) -> None:
        """Stamp this engine's seal context: outbound seals carry the
        ring incarnation (+1 on the wire, 0 meaning unset) and the
        training step; a landing sealed by a DIFFERENT live
        incarnation is fenced as a stale-world ghost write. RingWorld
        calls this after every bootstrap/rebuild generation
        agreement."""
        _load().tdr_seal_context(_live(self._h, "seal_context"),
                                 int(generation) + 1, int(step))

    def clear_seal_context(self) -> None:
        """Unset the seal context (wire gen 0 = fence skipped).
        RingWorld clears it at every bootstrap entry: generation
        RECONCILIATION frames must not be fenced by a stamp retained
        from a previous incarnation, or an asymmetrically-failed
        rebuild (one rank stamped, its neighbor did not) would reject
        the very frames that re-sync the ranks — on every retry."""
        _load().tdr_seal_context(_live(self._h, "seal_context"), 0, 0)

    def listen(self, host: str = "127.0.0.1", port: int = 0,
               timeout_ms: int = -1,
               force_stream: bool = False) -> QueuePair:
        """Accept one connection (blocking). ``timeout_ms`` bounds the
        accept wait (-1 = forever): elastic rendezvous must be able to
        give up and release the port for the next attempt.
        ``force_stream`` pins the connection to the stream tier (no
        CMA fast path — full payload seals; the emulated inter-host
        link of a hierarchical topology)."""
        h = _load().tdr_listen_tier(_live(self._h, "listen"),
                                    host.encode(), port, timeout_ms,
                                    _CONN_FORCE_STREAM if force_stream
                                    else 0)
        _check(h, "listen")
        return QueuePair(self, h)

    def connect(self, host: str = "127.0.0.1", port: int = 0,
                timeout_ms: int = 10000,
                force_stream: bool = False) -> QueuePair:
        h = _load().tdr_connect_tier(_live(self._h, "connect"),
                                     host.encode(), port, timeout_ms,
                                     _CONN_FORCE_STREAM if force_stream
                                     else 0)
        _check(h, "connect")
        return QueuePair(self, h)

    def close(self) -> None:
        if self._h:
            _load().tdr_engine_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def loopback_pair(engine: Engine, port: int,
                  engine2: Optional[Engine] = None
                  ) -> Tuple[QueuePair, QueuePair]:
    """Bring up a connected QP pair on localhost (test/bench helper)."""
    result: List[Optional[QueuePair]] = [None]

    def _serve():
        result[0] = engine.listen("127.0.0.1", port)

    t = threading.Thread(target=_serve)
    t.start()
    client = (engine2 or engine).connect("127.0.0.1", port)
    t.join()
    assert result[0] is not None
    return result[0], client
