"""The port's sanitized sweep, and the ``TDR_NATIVE_LIB`` switch it
rides on (``rocnrdma_tpu_torch/transport/engine.py``), as
``tests/test_sanitize.py`` holds the reference's.

Tier-1, each load in its own process (the library loads once per
process):

- with ``TDR_NATIVE_LIB`` naming a copy of the built ``libtdr.so``, an
  ``Engine("emu")`` maps that file, and no ``make`` runs;
- a path that does not exist raises ``TransportError`` naming the
  variable and the path;
- unset, the port builds under its flock and maps its own
  ``libtdr.so``;
- ``make .buildflags_san`` of the port's native copy stamps the ASan +
  UBSan + frame-pointer flags.

Slow: ``libtdr_san.so`` is built once from the port's native copy under
the engine's flock, and each drive runs in a subprocess with ASan
preloaded and ``TDR_NATIVE_LIB`` naming it: the port's sealed world-2
ring allreduce (telemetry on, sharded progress, fold workers, 32 KiB
chunks), then ``tools/torch_overlap_smoke.py`` lite,
``tools/torch_hier_smoke.py``, ``tools/torch_perf_smoke.py``,
``tools/torch_telemetry_smoke.py``, ``tools/torch_control_smoke.py``
lite, ``tools/torch_trace_smoke.py`` (whose rank processes inherit the
preload, the library and the sanitizer options),
``tools/torch_brownout_smoke.py`` and ``tools/torch_fleet_soak.py`` lite
(whose coordinator child inherits the preload) with the variables of
their reference ``*-smoke-san`` targets (``rocnrdma_tpu/native/Makefile``).
Each must exit 0 with its OK marker and no UBSan ``runtime error`` or
``AddressSanitizer`` report. None of them runs the trainer or makes
torch throw: under ASan any C++ exception torch throws aborts the
process, even a caught one.
"""

import fcntl
import os
import shutil
import subprocess
import sys

import pytest

from rocnrdma_tpu_torch.transport import engine as eng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "rocnrdma_tpu_torch", "native")
SAN_LIB = os.path.join(NATIVE, "libtdr_san.so")


def _env(**extra):
    env = dict(os.environ)
    env.pop("TDR_NATIVE_LIB", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _python(script, env, timeout=300):
    return subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


_MAPS_NO_MAKE = r"""
import subprocess
import torch  # before the patch: only the engine's loader is refused

def refuse(*args, **kwargs):
    raise AssertionError(f"make ran: {args!r}")

subprocess.run = refuse
from rocnrdma_tpu_torch.transport import engine as eng
e = eng.Engine("emu")
with open("/proc/self/maps") as f:
    maps = f.read()
print("LIB", eng._LIB_PATH)
print("MAPPED", eng._LIB_PATH in maps)
print("OWN_BUILD_MAPPED", eng.os.path.join(eng._NATIVE_DIR, "libtdr.so")
      in maps)
e.close()
"""


def test_native_lib_is_loaded_and_nothing_built(tmp_path):
    eng._load()  # the production build exists before it is copied
    copy = tmp_path / "libtdr_copy.so"
    shutil.copyfile(os.path.join(NATIVE, "libtdr.so"), copy)
    proc = _python(_MAPS_NO_MAKE, _env(TDR_NATIVE_LIB=str(copy)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert f"LIB {copy}" in lines, proc.stdout
    assert "MAPPED True" in lines, proc.stdout
    assert "OWN_BUILD_MAPPED False" in lines, proc.stdout


def test_missing_native_lib_raises_naming_the_variable(tmp_path):
    missing = tmp_path / "no_such_libtdr.so"
    proc = _python(
        "from rocnrdma_tpu_torch.transport import engine as eng\n"
        "try:\n"
        "    eng.Engine('emu')\n"
        "except eng.TransportError as e:\n"
        "    print('RAISED', e)\n",
        _env(TDR_NATIVE_LIB=str(missing)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("RAISED "), proc.stdout
    assert "TDR_NATIVE_LIB" in proc.stdout and str(missing) in proc.stdout


_BUILDS_OWN = r"""
import subprocess
import torch

real = subprocess.run
calls = []

def record(cmd, *args, **kwargs):
    calls.append(list(cmd))
    return real(cmd, *args, **kwargs)

subprocess.run = record
from rocnrdma_tpu_torch.transport import engine as eng
e = eng.Engine("emu")
with open("/proc/self/maps") as f:
    maps = f.read()
own = eng.os.path.join(eng._NATIVE_DIR, "libtdr.so")
print("MAKE", [c[:2] + c[-3:] for c in calls if c and c[0] == "make"])
print("OWN_MAPPED", eng._LIB_PATH == own and own in maps)
e.close()
"""


def test_unset_native_lib_builds_and_loads_the_ports_own():
    proc = _python(_BUILDS_OWN, _env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "OWN_MAPPED True" in lines, proc.stdout
    make = next(ln for ln in lines if ln.startswith("MAKE "))
    assert NATIVE in make and "'make'" in make, make


def test_port_sanitize_target_stamps_flags():
    subprocess.run(["make", "-s", "-C", NATIVE, ".buildflags_san"],
                   check=True, capture_output=True)
    with open(os.path.join(NATIVE, ".buildflags_san")) as f:
        stamp = f.read()
    assert "-fsanitize=address,undefined" in stamp
    assert "-fno-omit-frame-pointer" in stamp


# ---------------------------------------------------------------- slow


def _libasan_path():
    gcc = shutil.which("gcc")
    if not gcc:
        return None
    out = subprocess.run([gcc, "-print-file-name=libasan.so"],
                         capture_output=True, text=True)
    path = out.stdout.strip()
    return path if path and os.path.isabs(path) and os.path.exists(path) \
        else None


@pytest.fixture(scope="module")
def san_env():
    """``libtdr_san.so`` built from the port's native copy (under the
    engine's flock, which every other build of that copy takes) and the
    environment of a sanitized run."""
    libasan = _libasan_path()
    if libasan is None:
        pytest.skip("no gcc/libasan on this host")
    os.makedirs(os.path.dirname(eng._BUILD_LOCK), exist_ok=True)
    with open(eng._BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            build = subprocess.run(
                ["make", "-s", "-j4", "-C", NATIVE, "sanitize"],
                capture_output=True, text=True, timeout=900)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert build.returncode == 0, build.stderr[-2000:]
    return _env(
        LD_PRELOAD=libasan,
        # abort_on_error surfaces ASan findings as a non-zero exit;
        # leak checking is off (the interpreter's arenas drown it).
        ASAN_OPTIONS="detect_leaks=0,abort_on_error=1",
        UBSAN_OPTIONS="print_stacktrace=1",
        TDR_NATIVE_LIB=SAN_LIB)


def _clean(proc, marker):
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert marker in proc.stdout, out[-3000:]
    assert "runtime error" not in out, out[-3000:]      # UBSan reports
    assert "AddressSanitizer" not in out, out[-3000:]


_SAN_WORLD2 = """
import os, socket, threading
import numpy as np
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.transport import engine as eng
s = socket.socket(); s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]; s.close()
worlds = local_worlds(2, port)
with open("/proc/self/maps") as f:
    assert os.environ["TDR_NATIVE_LIB"] in f.read(), "sanitized lib not mapped"
assert worlds[0].left_qp.has_seal, "seal must be on under the sanitizer"

def run():
    bufs = [np.full(65536, float(r + 1), dtype=np.float32)
            for r in range(2)]
    ts = [threading.Thread(target=worlds[r].allreduce, args=(bufs[r],))
          for r in range(2)]
    [t.start() for t in ts]; [t.join() for t in ts]
    for b in bufs:
        np.testing.assert_array_equal(b, np.full(65536, 3.0, np.float32))

run()
# Second pass: the sharded progress engine over the windowed-scratch
# schedule (TDR_PROGRESS_SHARDS=2 in the env; 32 KiB chunks make the
# run big enough in chunks to engage the shards).
os.environ["TDR_NO_RECV_REDUCE"] = "1"
run()
assert eng.native_counters()["progress.wc"] > 0, \\
    "sharded progress engine never engaged under the sanitizer"
assert telemetry.enabled(), "telemetry must be on under the sanitizer"
events = telemetry.timeline()
assert any(e.name == "wc" for e in events), "no native events recorded"
telemetry.export_trace("/dev/null", events=events)
for w in worlds:
    w.close()
print("SAN_WORLD2_OK")
"""


@pytest.mark.slow
def test_sanitized_sealed_world2_allreduce(san_env):
    proc = _python(_SAN_WORLD2, {**san_env, "TDR_TELEMETRY": "1",
                                 "TDR_PROGRESS_SHARDS": "2",
                                 "TDR_FOLD_THREADS": "2",
                                 "TDR_RING_CHUNK": "32768"})
    _clean(proc, "SAN_WORLD2_OK")


@pytest.mark.slow
@pytest.mark.parametrize("tool,extra,marker", [
    ("torch_overlap_smoke.py",
     {"TDR_OVERLAP_SMOKE_LITE": "1", "TDR_OVERLAP_GATE": "0.05"},
     "overlap-smoke OK"),
    ("torch_hier_smoke.py", {"TDR_HIER_QUICK": "1"}, '"ok": true'),
    ("torch_perf_smoke.py", {}, "perf-smoke OK"),
    ("torch_telemetry_smoke.py", {}, '"ok": true'),
    # The reference's control, trace and brownout targets leave the
    # ring's stall deadline at its 30 s default, which the drives'
    # rebuild budgets are sized against (tests/test_torch_fleet_smokes.py).
    ("torch_control_smoke.py",
     {"TDR_CONTROL_SMOKE_LITE": "1", "TDR_RING_TIMEOUT_MS": "30000"},
     '"ok": true'),
    ("torch_trace_smoke.py",
     {"TDR_TRACE_SMOKE_SAN": "1", "TDR_RING_TIMEOUT_MS": "30000"},
     "trace smoke OK"),
    ("torch_brownout_smoke.py", {"TDR_RING_TIMEOUT_MS": "30000"},
     '"ok": true'),
    ("torch_fleet_soak.py",
     {"TDR_FLEET_SOAK_LITE": "1", "TDR_RING_TIMEOUT_MS": "30000"},
     '"ok": true'),
])
def test_sanitized_smoke(san_env, tool, extra, marker):
    """Each smoke under ASan + UBSan, with all its gates. The hier case
    is known to fail its ``hier >= flat`` timing gate on most runs on an
    8-core host, as the reference's ``make hier-smoke-san`` does there
    (ROADMAP Queue 3): read a red hier run for ``AddressSanitizer`` or
    ``runtime error`` before putting it down to timing."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", tool)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={**san_env, **extra})
    _clean(proc, marker)
