"""The port's serving path in wire mode (``world`` not None) against the
JAX package's: ``ContinuousBatcher`` over ``WeightStreamer`` and
``KVStream`` on the port's ``RingWorld``.

- a JAX batcher and a torch batcher on ONE world-2 ring (each on its
  own package's ``RingWorld`` and library), in both placements, with and
  without prefetch: the two ranks post their page gathers and KV
  broadcasts in the same order, so the ring completes and both ranks'
  tokens equal the JAX loopback batcher's;
- the world-2 tests of ``tests/test_serving.py`` on the port: lockstep
  tokens bitwise equal to both packages' loopback batchers, credits
  refunded under a retransmit, a corrupt rider on a KV page healed, the
  serving counters and latency histogram on the port's coordinator's
  ``/metrics``, and request-tagged stream ids through ``tdr_explain``;
- llama-tiny weights from the JAX package's ``init_params`` at world 2
  decode ``generate``'s greedy tokens;
- ``tools/torch_serve_smoke.py --cpu`` end to end.

Every batcher runs its decoder on the CPU (``device="cpu"``), so the
kernels' plain versions compute.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from rocnrdma_tpu.collectives.world import RingWorld as JaxWorld
from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.serving import batcher as jbatcher
from rocnrdma_tpu.serving import model as jmodel
from rocnrdma_tpu.transport.engine import Engine as JaxEngine
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.serving import model as tmodel
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher, Request
from rocnrdma_tpu_torch.serving.pager import KVStream, WeightStreamer
from rocnrdma_tpu_torch.serving.stream import (is_stream_coll,
                                               make_stream_coll,
                                               stream_coll_request,
                                               stream_coll_seq)
from rocnrdma_tpu_torch.transport.engine import (Engine, fault_plan_reset,
                                                 seal_counters,
                                                 seal_counters_reset,
                                                 telemetry_reset)
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

CORRUPT_RIDER = "send:chunk=0:nth=1:corrupt=3"


@pytest.fixture(autouse=True)
def _serving_env():
    keys = ("TDR_TELEMETRY", "TDR_FAULT_PLAN", "TDR_SEAL_CMA",
            "TDR_STREAM_DEPTH", "TDR_RING_CHUNK")
    saved = {k: os.environ.get(k) for k in keys}
    trace.reset()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    telemetry_reset()
    fault_plan_reset()
    seal_counters_reset()


def _toy(pkg, seed=7):
    cfg = pkg.ServeConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq_len=32,
                          rope_theta=10000.0)
    return cfg, pkg.pack_pages(cfg, pkg.toy_param_tree(cfg, seed=seed))


def _scenario(b, req_cls):
    """Join/evict churn (``tests/test_serving.py``'s): R1+R2 decode, R3
    queues while full, R1 is evicted mid-stream, the freed slot admits
    R3 mid-stream (prefill on its home rank 3 % 2 = 1, KV pages streamed
    to rank 0)."""
    b.submit(req_cls(1, [3, 7, 11], 8))
    b.submit(req_cls(2, [9, 2], 6))
    for _ in range(3):
        b.step()
    b.submit(req_cls(3, [5, 1], 4))
    b.evict(1)
    b.run()
    return {rid: r.tokens for rid, r in sorted(b.finished.items())}


def _jax_loopback():
    cfg, pages = _toy(jmodel)
    b = jbatcher.ContinuousBatcher(None, pages, cfg, max_slots=2,
                                   prefetch=False)
    want = _scenario(b, jbatcher.Request)
    b.close()
    return want


def _torch_loopback():
    cfg, pages = _toy(tmodel)
    b = ContinuousBatcher(None, pages, cfg, max_slots=2, prefetch=False,
                          device="cpu")
    want = _scenario(b, Request)
    b.close()
    return want


def _run(fns):
    """fns[r]() on one thread per rank; the results, or the first
    rank's error once every thread has ended."""
    out, errs = [None] * len(fns), [None] * len(fns)

    def body(r):
        try:
            out[r] = fns[r]()
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[r] = e

    ts = [threading.Thread(target=body, args=(r,)) for r in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive(), "a rank did not finish in 120 s"
    for e in errs:
        if e is not None:
            raise e
    return out


def _mixed_worlds(jax_rank):
    """One world-2 ring: rank ``jax_rank`` on the JAX package's library,
    the other on the port's."""
    port = port_band(8)

    def boot(r):
        return lambda: (JaxWorld(JaxEngine("emu"), r, 2, port)
                        if r == jax_rank
                        else RingWorld(Engine("emu"), r, 2, port))

    return _run([boot(0), boot(1)])


# ------------------------------------------------- mixed JAX/torch ring


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("jax_rank", [0, 1])
def test_mixed_jax_torch_world2_batcher(jax_rank, prefetch):
    """A JAX rank and a torch rank serve one request stream on one ring.
    The torch batcher must top its page stream up while it still holds
    the page it acquired (as the JAX batcher does), or its fetch pointer
    runs one page ahead and the ranks post different collectives at the
    first KV join."""
    want = _jax_loopback()
    worlds = _mixed_worlds(jax_rank)
    try:
        bs = []
        for r, w in enumerate(worlds):
            if r == jax_rank:
                cfg, pages = _toy(jmodel)
                bs.append(jbatcher.ContinuousBatcher(
                    w, pages, cfg, max_slots=2, prefetch=prefetch))
            else:
                cfg, pages = _toy(tmodel)
                bs.append(ContinuousBatcher(w, pages, cfg, max_slots=2,
                                            prefetch=prefetch, device="cpu"))
        reqs = [jbatcher.Request if r == jax_rank else Request
                for r in range(2)]
        got = _run([lambda r=r: _scenario(bs[r], reqs[r]) for r in range(2)])
        assert got[0] == got[1] == want
        for b in bs:
            b.close()
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        for w in worlds:
            w.close()


# --------------------------------------------------- torch world 2


@pytest.mark.parametrize("prefetch", [False, True])
def test_batcher_world2_lockstep_bitwise_vs_loopback(prefetch):
    """Torch world 2 (weights gathered per page, KV joins broadcast over
    the sealed path): tokens bitwise equal on both ranks, to the port's
    loopback batcher and to the JAX package's."""
    want = _jax_loopback()
    assert _torch_loopback() == want
    cfg, pages = _toy(tmodel)
    worlds = local_worlds(2, port_band(8))
    try:
        bs = [ContinuousBatcher(w, pages, cfg, max_slots=2,
                                prefetch=prefetch, device="cpu")
              for w in worlds]
        got = _run([lambda r=r: _scenario(bs[r], Request) for r in range(2)])
        assert got[0] == got[1] == want
        assert bs[0].finished[1].evicted and bs[1].finished[3].joined_step > 0
        for b in bs:
            b.close()
            for eng in (b.streamer.engine, b.kv.engine):
                s = eng.stats()
                assert s["live"] == 0 and s["acquired"] == s["released"], s
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        for w in worlds:
            w.close()


def test_world2_wire_bytes_and_host_spans_match_the_shapes():
    """What crossed the ring, read from each rank's engine in the flight
    recorder, is what the shapes give: every page gathered each step and
    ``depth - 1`` into the next cycle, the peer's half landing (ceil(n/2)
    elements on rank 0, floor(n/2) on rank 1) and the own half sent, and
    each join's KV pages (2 x n_kv_heads x prompt x head_dim per layer
    and one meta element) sent whole by both ranks of the world-2
    allreduce. ``serve.prefetch`` spans one per fetched page and
    ``serve.upload`` one per page a step computes under, with its
    bytes."""
    os.environ["TDR_TELEMETRY"] = "1"
    telemetry_reset()
    cfg, pages = _toy(tmodel)
    worlds = local_worlds(2, port_band(8))
    try:
        bs = [ContinuousBatcher(w, pages, cfg, max_slots=2, device="cpu")
              for w in worlds]
        telemetry_reset()                       # the handshakes' frames out
        _run([lambda r=r: _scenario(bs[r], Request) for r in range(2)])
        for b in bs:
            b.close()
        events = telemetry.drain()
        sizes = [int(p.size) for p in pages.pages]
        prompts = [3, 2, 2]                     # _scenario's R1, R2, R3
        kv = 4 * sum(cfg.n_layers * 2 * cfg.n_kv_heads * n * cfg.head_dim + 1
                     for n in prompts)
        for r, (w, b) in enumerate(zip(worlds, bs)):
            order = sizes * b.step_no + sizes[:b.streamer.depth - 1]
            peer = sum((n + 1) // 2 if r == 0 else n // 2 for n in order)
            assert b.streamer.stats()["pages"] == len(order)
            mine = [e for e in events if e.engine == w.engine.telemetry_id]
            tally = {name: sum(e.arg for e in mine if e.name == name)
                     for name in ("wire_tx", "land")}
            assert tally == {"wire_tx": 4 * (sum(order) - peer) + kv,
                             "land": 4 * peer}, (r, tally)
        assert telemetry.counters().get("telemetry.dropped", 0) == 0
        fetched = sum(b.streamer.stats()["pages"] for b in bs)
        assert len(trace.events("serve.prefetch")) == fetched
        ups = trace.events("serve.upload")
        assert len(ups) == sum(len(sizes) * b.step_no for b in bs)
        assert sum(e[2]["bytes"] for e in ups) == \
            sum(4 * sum(sizes) * b.step_no for b in bs)
    finally:
        for w in worlds:
            w.close()


def test_world2_credit_refund_under_retransmit(monkeypatch):
    """NAK/retransmit on a streamed weight page: the gate balances, the
    high-water mark stays within depth, and every landed page is
    bitwise the packed page."""
    monkeypatch.setenv("TDR_SEAL_CMA", "1")
    monkeypatch.setenv("TDR_RING_CHUNK", str(16 << 10))
    monkeypatch.setenv("TDR_FAULT_PLAN", CORRUPT_RIDER)
    fault_plan_reset()
    seal_counters_reset()
    cfg, pages = _toy(tmodel)
    order = list(range(len(pages))) * 2
    worlds = local_worlds(2, port_band(8))
    try:
        sts = [WeightStreamer(w, pages, depth=2) for w in worlds]

        def run(r):
            st, outs = sts[r], []
            for idx in order:
                st.prefetch(idx)
                view = st.acquire(idx)
                outs.append(view.copy())
                st.release(view)
            return outs

        outs = _run([lambda r=r: run(r) for r in range(2)])
        c = seal_counters()
        assert c["failed"] >= 1 and c["retransmitted"] >= 1, c
        for r in range(2):
            for got, idx in zip(outs[r], order):
                np.testing.assert_array_equal(got, pages.pages[idx])
            s = sts[r].stats()
            assert s["acquired"] == s["released"], s
            assert s["high_water"] <= 2, s
            sts[r].close()
    finally:
        monkeypatch.delenv("TDR_FAULT_PLAN")
        fault_plan_reset()
        for w in worlds:
            w.close()


def test_world2_kv_page_corrupt_rider_heals(monkeypatch):
    """A corrupt rider on a streamed KV page fails its seal, is NAKed and
    retransmitted, and both ranks receive the home rank's exact bytes."""
    monkeypatch.setenv("TDR_SEAL_CMA", "1")
    monkeypatch.setenv("TDR_RING_CHUNK", str(16 << 10))
    monkeypatch.setenv("TDR_FAULT_PLAN", CORRUPT_RIDER)
    fault_plan_reset()
    seal_counters_reset()
    payload = np.random.default_rng(3).standard_normal(6144).astype(
        np.float32)
    worlds = local_worlds(2, port_band(8))
    try:
        kvs = [KVStream(w, max_elems=payload.size) for w in worlds]
        got = _run([lambda r=r: kvs[r].broadcast(
            payload if r == 0 else None, home=0, request_id=9, seq=1,
            n=payload.size) for r in range(2)])
        c = seal_counters()
        assert c["failed"] >= 1 and c["retransmitted"] >= 1, c
        for r in range(2):
            np.testing.assert_array_equal(got[r], payload)
            s = kvs[r].engine.stats()
            assert s["acquired"] == s["released"], s
            kvs[r].close()
    finally:
        monkeypatch.delenv("TDR_FAULT_PLAN")
        fault_plan_reset()
        for w in worlds:
            w.close()


# ------------------------------------------------------- llama-tiny


def test_world2_llama_tiny_equals_generate():
    """Pages packed from the JAX package's llama-tiny ``init_params``
    (through ``params_to_flax``) at world 2: both ranks decode exactly
    the port's ``generate`` greedy tokens, with a request joining
    mid-run on rank 1 (its home) and its KV streamed to rank 0."""
    jm = jllama.make_model("llama-tiny")
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jm, jax.random.PRNGKey(0)))
    state = tllama.params_from_flax(tree)
    port = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    port.load_state_dict(state)
    cfg = tmodel.ServeConfig.from_llama(tllama.LLAMA_TINY)
    pages = tmodel.pack_llama_params(cfg, tllama.params_to_flax(state))
    prompts = {2: [5, 9, 42, 7], 3: [3, 1, 4, 1, 5, 9]}

    def drive(b):
        b.submit(Request(2, prompts[2], 8))
        b.step()
        b.submit(Request(3, prompts[3], 5))
        b.run()
        return {rid: r.tokens for rid, r in b.finished.items()}

    worlds = local_worlds(2, port_band(8))
    try:
        bs = [ContinuousBatcher(w, pages, cfg, max_slots=2, device="cpu")
              for w in worlds]
        got = _run([lambda r=r: drive(bs[r]) for r in range(2)])
        for b in bs:
            b.close()
    finally:
        for w in worlds:
            w.close()
    assert got[0] == got[1]
    assert bs[0].finished[3].joined_step > 0
    for rid, p in prompts.items():
        want = tllama.generate(port, [p], len(got[0][rid]),
                               device="cpu")[0].tolist()
        assert got[0][rid] == want


# --------------------------------------------------------- SLO metrics


def test_serve_counters_and_hist_ride_heartbeat_to_metrics():
    """The port's serving counters and fine latency histogram, pushed by
    a heartbeat to the port's coordinator, render on ``/metrics`` as
    ``tdr_serve_requests_total{world=}``, ``tdr_serve_tokens_total`` and
    ``tdr_token_lat_us{quantile=}``."""
    from rocnrdma_tpu_torch.control.client import ControlClient
    from rocnrdma_tpu_torch.control.coordinator import Coordinator

    cfg, pages = _toy(tmodel)
    b = ContinuousBatcher(None, pages, cfg, max_slots=2, device="cpu")
    b.submit(Request(1, [3, 7], 5))
    b.submit(Request(2, [4], 5))
    b.run()
    b.close()
    toks = trace.counter("serve.tokens")
    assert toks == len(b.finished[1].tokens) + len(b.finished[2].tokens)

    co = Coordinator(port=0, lease_ms=5000, port_base=port_band(64)).start()
    try:
        client = ControlClient(co.address)
        views = _run([lambda r=r: client.join("serve", 2, rank=r)
                      for r in range(2)])
        hists = {name: {**{64: 0}, **row}
                 for name, row in trace.hists().items()}
        client.heartbeat("serve", 0, views[0]["incarnation"],
                         views[0]["generation"],
                         counters=trace.counters_prefixed("serve."),
                         hists=hists)
        body = client.metrics()
    finally:
        co.stop()
    assert 'tdr_serve_requests_total{world="serve"} 2' in body
    assert f'tdr_serve_tokens_total{{world="serve"}} {toks}' in body
    for q in ("0.50", "0.90", "0.99"):
        line = [ln for ln in body.splitlines()
                if ln.startswith(f'tdr_token_lat_us{{world="serve",'
                                 f'quantile="{q}"}}')]
        assert line, f"quantile {q} not served:\n{body}"
        assert float(line[0].rsplit(" ", 1)[1]) > 0
    assert f'tdr_token_lat_us_count{{world="serve"}} {toks}' in body


# --------------------------------------------------------- attribution


def test_tdr_explain_attributes_stream_requests():
    """The port's telemetry events with request-tagged stream ids, fed
    to the reference's ``tools/tdr_explain.py``, decompose per request:
    request 0 (shared weight pages) apart from request 7's KV pages, and
    a plain collective left out."""
    from rocnrdma_tpu_torch.telemetry import TelEvent, events_to_wire
    from tdr_explain import analyze_segments, render_text

    MS = 1_000_000

    def seg(rank, colls):
        evs = []
        for i, coll in enumerate(colls):
            t = 10 * i + rank
            evs += [
                TelEvent(ts_ns=t * MS, name="ring_begin", engine=rank + 1,
                         id=i + 1, arg=4096, coll=coll),
                TelEvent(ts_ns=(t + 1) * MS, name="wire_tx",
                         engine=rank + 1, qp=1, id=i + 1, arg=4096,
                         coll=coll),
                TelEvent(ts_ns=(t + 5) * MS, name="ring_end",
                         engine=rank + 1, id=i + 1, arg=0, coll=coll),
            ]
        return {"events": events_to_wire(evs), "clock_offset_ns": 0,
                "dropped": 0}

    colls = [make_stream_coll(0, 1), make_stream_coll(7, 1),
             make_stream_coll(7, 2), 5]
    a = analyze_segments({"0": seg(0, colls), "1": seg(1, colls)})
    serving = a["serving"]
    assert serving["7"]["transfers"] == 2
    assert serving["7"]["tx_bytes"] == 2 * 2 * 4096
    assert serving["0"]["transfers"] == 1
    assert "5" not in serving
    for c in a["collectives"]:
        if is_stream_coll(c["coll"]):
            assert c["request"] == stream_coll_request(c["coll"])
            assert c["stream_seq"] == stream_coll_seq(c["coll"])
        else:
            assert "request" not in c
    text = render_text(a)
    assert "serving streams" in text and "req 7" in text


def test_tdr_explain_serving_section_from_a_world2_run(monkeypatch):
    """A recorded torch world-2 batcher run (recorder on before the
    engines exist): its timeline, through ``tdr_explain``, has a
    non-empty serving section with the shared weight pages as request 0
    and the joining request's KV pages under its own id."""
    from rocnrdma_tpu_torch import telemetry
    from tdr_explain import analyze_segments

    monkeypatch.setenv("TDR_TELEMETRY", "1")
    telemetry_reset()
    cfg, pages = _toy(tmodel)
    worlds = local_worlds(2, port_band(8))
    try:
        bs = [ContinuousBatcher(w, pages, cfg, max_slots=2, device="cpu")
              for w in worlds]
        _run([lambda r=r: _scenario(bs[r], Request) for r in range(2)])
        for b in bs:
            b.close()
    finally:
        for w in worlds:
            w.close()
    seg = {"events": telemetry.events_to_wire(telemetry.timeline()),
           "clock_offset_ns": 0, "dropped": 0}
    serving = analyze_segments({"0": seg})["serving"]
    assert serving["0"]["transfers"] > 0
    assert any(k != "0" for k in serving), serving


# -------------------------------------------------- the serve smoke


def test_torch_serve_smoke_cpu():
    """``tools/torch_serve_smoke.py --cpu`` passes and prints one
    ``SERVE`` line with the reference tool's keys, ``jit_decode`` with
    equal tokens from the compiled and the eager decoder among them."""
    proc = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "torch_serve_smoke.py"),
         "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("SERVE ")]
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0][len("SERVE "):])
    for key in ("mode", "world", "host_cores", "overlap_gate", "pages",
                "page_bytes_max", "depth", "curve", "windows",
                "overlap_fraction", "prefetch_tokens_s",
                "noprefetch_tokens_s", "tokens_s_windows", "heal",
                "scenario", "serve_requests", "serve_tokens"):
        assert key in out, key
    assert out["jit_decode"]["tokens_match"] is True
    assert out["device"] == "cpu" and out["world"] == 2
    assert out["scenario"]["bitwise_ok"] is True
    assert out["heal"]["failed"] >= 1 and out["heal"]["retransmitted"] >= 1
    assert all(c["wire_events"] > 0 for c in out["curve"])
