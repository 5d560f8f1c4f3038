#!/usr/bin/env python
"""Autoregressive generation with the incremental KV cache, on the
PyTorch port: the counterpart of ``examples/generate_text.py``.

The decode path: an eager prefill (the K3 kernel on the card), then one
decode step captured as a CUDA graph and replayed for every further
token (``models/llama.py`` ``generate`` / ``DecodeLoop``), memoized so a
second call with the same shapes replays without capturing. The same
prompt then runs through the serving batcher with ``jit_decode=True``
(each decode layer step replayed from a graph over streamed weight
pages), whose per-token stamps give the marginal decode time.

Smoke run on the CPU (random weights, token ids only; the steps run
uncaptured there):

    python examples/generate_text_torch.py --cpu --config llama-tiny --new 16

On the card:

    python examples/generate_text_torch.py --config llama3-1b --new 64
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama-tiny")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions of the kernels, "
                         "steps uncaptured); default: the card")
    args = ap.parse_args()

    import numpy as np
    import torch

    from rocnrdma_tpu_torch import resolve_device
    from rocnrdma_tpu_torch.models import llama
    from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher, Request
    from rocnrdma_tpu_torch.serving.model import (ServeConfig,
                                                  pack_llama_params)
    from rocnrdma_tpu_torch.utils import graphs

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = llama.CONFIGS[args.config]
    state = llama.init_params(cfg, seed=0, device=device)
    model = llama.Llama(cfg, device=device)
    model.load_state_dict(state, assign=True)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, args.prompt_len))).to(device)

    def timed():
        # A fresh generator each call: the memo keys on what the graph
        # bakes in, not on the generator, so the second call still only
        # replays.
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        toks = llama.generate(model, prompt, args.new,
                              temperature=args.temperature, generator=gen,
                              device=device)
        out = toks.cpu().numpy()          # waits for the card
        return out, time.perf_counter() - t0

    first, t_capture = timed()            # capture + run
    captured = graphs.captures()
    out, dt = timed()                     # replays only
    assert graphs.captures() == captured, "the second call captured again"

    # Marginal decode rate from the serving batcher's per-token stamps
    # (loopback, prefetch on), the same prompt through the compiled
    # paged decode. Its pages are f32.
    scfg = ServeConfig.from_llama(cfg)
    pages = pack_llama_params(scfg, llama.params_to_flax(state))
    b = ContinuousBatcher(None, pages, scfg, max_slots=1, jit_decode=True,
                          device=device)
    req = Request(1, prompt.cpu().numpy()[0], args.new)
    b.submit(req)
    try:
        b.run()
        lats = sorted(b.token_lat_us)
        marginal = lats[len(lats) // 2] if lats else float("nan")
    finally:
        b.close()

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"config={cfg.name} device={name} prompt={args.prompt_len} "
          f"new={args.new}")
    print(f"capture+run: {t_capture:.2f}s; steady: {dt * 1e3:.0f} ms "
          f"({args.new / dt:.1f} tok/s)")
    print(f"marginal (batcher token stamps, jit_decode): {marginal:.0f} "
          f"us/token ({1e6 / marginal:.1f} tok/s, p50 of "
          f"{len(lats)} stamps)")
    print("token ids:", out[0].tolist())
    assert out.shape == (1, args.new) and first.shape == out.shape
    if args.temperature == 0.0:
        agree = sum(a == g for a, g in zip(req.tokens, out[0].tolist()))
        print(f"batcher tokens equal to generate's: {agree}/{args.new}")
        # Like for like only where the model computes in f32, as the
        # pages do; a bf16 model rounds where the pages do not.
        if cfg.dtype == torch.float32:
            assert req.tokens == out[0].tolist(), (req.tokens,
                                                   out[0].tolist())


if __name__ == "__main__":
    main()
