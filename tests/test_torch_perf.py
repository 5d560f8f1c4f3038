"""The port's perftest analogue (``rocnrdma_tpu_torch/tools/perf.py``)
against the JAX package's (``rocnrdma_tpu/tools/perf.py``).

- its ``--lat`` (``ib_write_lat``) and bandwidth (``--qd``,
  ``ib_write_bw``) modes, as ``tests/test_tools.py`` holds the
  reference's;
- its ``--json`` record has the reference tool's keys, sweep by sweep,
  for writes and reads, with and without ``--telemetry``;
- ``--hbm fake`` pins its buffer through the port's
  ``RegistrationManager`` and ``FakeHBMExporter``, and a one-sided
  write lands in the pinned range;
- as two processes, a ``--listen`` child and a client, writes and reads
  sweep every size with both ends exiting 0.
"""

import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rocnrdma_tpu.tools import perf as jperf
from rocnrdma_tpu.transport.engine import telemetry_reset as jtel_reset
from rocnrdma_tpu_torch.hbm.registry import RegistrationManager
from rocnrdma_tpu_torch.tools import perf as tperf
from rocnrdma_tpu_torch.transport.engine import (Engine, loopback_pair,
                                                 telemetry_reset)

from test_hier import port_band

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _recorder_off_after():
    """``--telemetry`` turns the recorder on for the process: put the
    environment back and reset both libraries' recorders after each
    test."""
    saved = os.environ.get("TDR_TELEMETRY")
    yield
    if saved is None:
        os.environ.pop("TDR_TELEMETRY", None)
    else:
        os.environ["TDR_TELEMETRY"] = saved
    telemetry_reset()
    jtel_reset()


def _run(cli, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args + ["--port", str(port_band(2))])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _keys(obj):
    """The nested key structure of a JSON record."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


def test_perf_cli_lat_and_qd_modes():
    out = _run(tperf, ["--loopback", "--engine", "emu", "--op", "write",
                       "--sizes", "4K", "--iters", "24", "--lat", "--json"])
    rec = out["sweep"][0]
    assert (rec["lat_us_min"] <= rec["lat_us_p50"]
            <= rec["lat_us_p99"] <= rec["lat_us_max"])
    assert out["min_lat_us"] == rec["lat_us_min"]

    out = _run(tperf, ["--loopback", "--engine", "emu", "--op", "write",
                       "--sizes", "64K", "--iters", "24", "--qd", "8",
                       "--json"])
    assert out["peak_GBps"] > 0
    assert out["sweep"][0]["lat_us"] > 0


@pytest.mark.parametrize("extra", [
    ["--op", "write"], ["--op", "read"], ["--op", "write", "--lat"],
    ["--op", "read", "--telemetry"]])
def test_json_record_has_the_reference_keys(extra):
    args = ["--loopback", "--engine", "emu", "--sizes", "4K:16K",
            "--iters", "4", "--json"] + extra
    got, want = _run(tperf, args), _run(jperf, args)
    assert _keys(got) == _keys(want)
    assert [r["bytes"] for r in got["sweep"]] == [4096, 8192, 16384]
    assert got["op"] == extra[1]


def test_parse_sizes_equals_the_reference():
    for spec in ("4:1G", "4K", "64M", "1G", "3:17"):
        assert tperf.parse_sizes(spec) == jperf.parse_sizes(spec)


def test_hbm_fake_sweep():
    out = _run(tperf, ["--loopback", "--engine", "emu", "--op", "write",
                       "--sizes", "4K:64K", "--iters", "8", "--hbm", "fake",
                       "--json"])
    assert len(out["sweep"]) == 5 and out["peak_GBps"] > 0


def test_hbm_fake_pins_through_the_registry():
    """``--hbm fake``'s buffer is a ``RegistrationManager`` pin over
    fake HBM filled with the perftest pattern; a write from a peer's
    host tensor lands in it, and deregistering releases the pin."""
    n = 1 << 16
    e = Engine("emu")
    try:
        mr, (mgr, reg) = tperf._mr_for(e, n, "fake")
        assert isinstance(mgr, RegistrationManager) and reg.mr is mr
        va = mr.addr
        assert ctypes.string_at(va, n) == b"\xa5" * n
        src = torch.arange(n, dtype=torch.int64).to(torch.uint8)
        srv, cli = loopback_pair(e, port_band(2))
        with e.reg_mr(src) as smr:
            cli.post_write(smr, 0, va, mr.rkey, n, wr_id=7)
            assert cli.wait(7, timeout_ms=30000).ok
        assert ctypes.string_at(va, n) == bytes(src.numpy())
        mgr.deregister(reg)
        srv.close()
        cli.close()
    finally:
        e.close()


@pytest.mark.parametrize("op", ["write", "read"])
def test_sweep_across_two_processes(op):
    """The tool's server as a ``--listen`` child process and its client
    in this one, over the emu engine (the cross-process link the
    two-process paths ride): both ends exit 0, the client's record holds
    every size of the sweep, each at a positive rate."""
    args = ["--engine", "emu", "--op", op, "--sizes", "4K:64K", "--iters",
            "8", "--port", str(port_band(2))]
    server = subprocess.Popen(
        [sys.executable, "-m", "rocnrdma_tpu_torch.tools.perf", *args,
         "--listen", "--bind", "127.0.0.1"], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = tperf.main(args + ["--host", "127.0.0.1", "--json"])
        _, err = server.communicate(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert rc == 0
    assert server.returncode == 0, err[-2000:]
    sweep = json.loads(buf.getvalue().strip().splitlines()[-1])["sweep"]
    assert [r["bytes"] for r in sweep] == tperf.parse_sizes("4K:64K")
    assert all(r["GBps"] > 0 for r in sweep), sweep
