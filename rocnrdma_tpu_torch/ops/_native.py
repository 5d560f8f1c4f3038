"""Build, load and count the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, at first use, into ``_build/`` (which
git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, of every header under
``csrc/`` (``*.cuh``, which the sources may include) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. :func:`build`
starts one ``nvcc`` per source, all at once. The libraries are loaded
with ``ctypes``: every pointer and the stream are ``c_void_p``, and
every entry returns ``cudaGetLastError()``, which :func:`check` turns
into an exception.

Importing this module compiles nothing and needs no compiler: a host
without ``nvcc`` fails only when a kernel is first launched.

Route queries: the three attention kernels, ``flash_fwd`` (K3),
``flash_bwd_dkv`` (K4) and ``flash_bwd_dq`` (K5), have two instances
each, a tensor-core one (bf16 at D 64 and 128) and a scalar one (f32,
and bf16 at D 16 and 32); their libraries export ``<entry>_route(D,
dtype)``, the instance the entry launches, from the same dispatch code
(:func:`route`).

Launch counters: each wrapper calls :func:`count` once where it launches
its kernel and nowhere else, so a run can show which kernels its path
went through (:func:`launches`, :func:`reset_launches`). A CUDA graph
launches its kernels without calling the wrappers: a capture launches
nothing, so what its thread counts while it records goes into a tally of
its own (:func:`tally_launches`), and
:class:`~rocnrdma_tpu_torch.utils.graphs.CapturedStep` counts that tally
at every replay (``count(name, n)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

import torch

from ..utils.trace import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

BUILD_TIMEOUT_S = 600
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entries, one library per source.
SIGNATURES = {
    "rmsnorm_fwd": ("rmsnorm_fwd", [_P, _P, _P, _I, _I, _F, _I, _P]),
    "flash_fwd": ("flash_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _I, _I, _P]),
    "rmsnorm_bwd": ("rmsnorm_bwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _F, _I, _P]),
    "flash_bwd_dq": ("flash_bwd_dq", [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _F, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd_dkv", [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _F, _I, _I, _P]),
}
KERNELS = tuple(SIGNATURES)
# Kernels with more than one instance, and the C function that names the
# one their entry launches for (D, dtype).
ROUTES = {"flash_fwd": "flash_fwd_route",
          "flash_bwd_dkv": "flash_bwd_dkv_route",
          "flash_bwd_dq": "flash_bwd_dq_route"}
ROUTE_NAMES = {1: "tensor_core", 0: "scalar"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# This thread's open tally (tally_launches), if any.
_local = threading.local()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when none has it."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "rocnrdma_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, "
        "PATH and /usr/local/cuda/bin); the CUDA kernels are built from "
        "csrc/ at first use and need the CUDA toolkit")


def _source(name: str) -> Path:
    if name not in SIGNATURES:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library of ``name`` is built: keyed by a hash of its
    source, the headers under ``csrc/`` and the compiler flags."""
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    compile took (0.0 for a library already built). Raises with the
    compiler's output when one fails. A build that compiles anything is
    a ``kernels.build`` span of the tracer, with the ``names`` built."""
    secs = {name: 0.0 for name in names}
    todo = [name for name in secs if not library_path(name).exists()]
    if todo:
        with trace.span("kernels.build", names=todo):
            secs.update(_compile(todo))
    return secs


def _compile(names: List[str]) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.monotonic())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc killed after {BUILD_TIMEOUT_S} s"
        secs[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                            f"{log[-4000:]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if name in ROUTES:
            rt = getattr(lib, ROUTES[name])
            rt.argtypes = [_I, _I]
            rt.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def route(name: str, d: int, dtype_code: int) -> str:
    """The instance of ``name`` that its entry launches for head dim
    ``d`` and dtype code ``dtype_code`` (0 f32, 1 bf16): "tensor_core"
    or "scalar". Raises for a pair the entry refuses."""
    code = getattr(library(name), ROUTES[name])(d, dtype_code)
    if code not in ROUTE_NAMES:
        raise ValueError(f"{name} takes no instance for D={d}, "
                         f"dtype code {dtype_code}")
    return ROUTE_NAMES[code]


def check(name: str, code: int) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if code != 0:
        msg = library(name).error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def device_type(t: torch.Tensor, what: str) -> str:
    """Where an op runs for ``t``: ``"cuda"`` (its kernel) or ``"cpu"``
    (its plain version). Any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device`` as an integer handle."""
    return int(torch.cuda.current_stream(device).cuda_stream)


def count(name: str, n: int = 1) -> None:
    tally = getattr(_local, "tally", None)
    if tally is None:
        _launches[name] += n
    else:
        tally[name] = tally.get(name, 0) + n


@contextmanager
def tally_launches() -> Iterator[Dict[str, int]]:
    """What this thread counts inside the block goes into the yielded
    dict instead of :func:`launches`: the launches a graph capture
    records (and does not make). Other threads count as ever."""
    prev, _local.tally = getattr(_local, "tally", None), {}
    try:
        yield _local.tally
    finally:
        _local.tally = prev


def launches() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launches`."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
