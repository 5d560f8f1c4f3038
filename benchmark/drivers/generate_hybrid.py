"""Entry driver ``generate_hybrid``: the closed loop of greedy
``generate`` calls of ``drivers/generate_mla.py`` over a hybrid
linear-attention, routed-expert model (the program's ``KimiLinear``).

Everything but the model and the number the check compares is
``generate_mla``'s: the cycle of prompt lengths, the prompts, the units,
the rates, the warm-up of each cache length (one call of two new tokens,
which captures the decode graph), the sample of requests that the check
takes and the readings. Set-up reads the whole configuration file by the
cell's name, builds the model from its keys (the experts this card holds
among the router's) and fills it from the seed's weights one group at a
time (:mod:`benchmark.weights_kimi`); the check runs the plain reference
(:mod:`benchmark.reference.kimi_linear_ref`) over each sampled prompt
with its served tokens.

The number it compares, ``logit_gap``, is the widest over the sampled
requests of a request's gap at its tenth percentile (``QUANTILE``) of
served positions; a request's median gap, ``generate_mla``'s number, is
the reading ``logit_gap_median``. At random weights bf16 alone flips
near-tied picks among 256 router scores, so the program misses the
reference's best token at ~87% of positions and its median gap reads
half the fp8 control's; but it serves the best token at more than a
tenth of every request's positions, and fp8 at under 2%, so the tenth
percentile reads the control at 15 times the program's widest (PERF.md
§2).
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import harness, weights_kimi
from benchmark.drivers import generate, generate_mla
from benchmark.reference import kimi_linear_ref, llama_ref

BENCH = Path(__file__).resolve().parent.parent
# The share of a request's served positions at which its gap is read.
QUANTILE = 0.1


class Driver(generate_mla.Driver):
    def __init__(self, shape, traffic, seed: int, device) -> None:
        from rocnrdma_tpu_torch.models.kimi_linear import (KimiLinear,
                                                           KimiLinearConfig)
        from rocnrdma_tpu_torch.models.llama import generate as gen

        self.shape, self.traffic, self.seed = shape, traffic, seed
        self.device = torch.device(device)
        self.b, self.new = traffic["batch"], traffic["new_tokens"]
        self.groups = [g if isinstance(g, list) else [g]
                       for g in traffic["prompt_lens"]]
        self._generate = gen
        self.config = harness.Bench(BENCH).config(shape.name)
        self.model = KimiLinear(KimiLinearConfig.from_hf(self.config),
                                self.device)
        for group in weights_kimi.draw_all(self.config, seed, self.device,
                                           shape.torch_dtype):
            self.model.load_state_dict(group, strict=False)
            del group
        self.next = 0
        longest = {}
        for p in sum(self.groups, []):
            c = self.cache_len(p, self.new)
            longest[c] = max(p, longest.get(c, 0))
        for c, p in sorted(longest.items()):
            while self.cache_len(p, generate.WARM_NEW) < c:
                p += 1
            self._call(self.prompt(-1 - p, p), generate.WARM_NEW)

    def _served(self, win: dict, precs):
        by_index = {u["index"]: u for u in win["units"]}
        requests = []
        for i, r in self.sample(win["units"]):
            u = by_index[i]
            requests.append((self.prompt(i, u["p"])[r], u["tokens"][r]))
        logits = kimi_linear_ref.served_logits(
            self.config, self.seed, requests, self.shape.torch_dtype,
            self.device, precs)
        return logits, [t for _, t in requests]

    def numbers(self, win: dict) -> dict:
        logits, served = self._served(win, ("f32",))
        return gap_numbers([llama_ref.served_gaps(lg["f32"], t)
                            for lg, t in zip(logits, served)])

    def control(self, win: dict) -> dict:
        """The program's numbers beside the control's: the reference in
        fp8, at each position of the same prompts and served tokens,
        judged by the gap of the token it puts first."""
        logits, served = self._served(win, ("f32", "fp8"))
        prog = gap_numbers([llama_ref.served_gaps(lg["f32"], t)
                            for lg, t in zip(logits, served)])
        fp8 = gap_numbers([llama_ref.served_gaps(lg["f32"],
                                                 lg["fp8"].argmax(-1))
                           for lg in logits])
        return {"program": prog, "fp8": fp8}


def gap_numbers(gaps) -> dict:
    """``generate_mla.gap_numbers`` of the requests' served gaps, each
    (n,), with its ``logit_gap`` (the widest request's median gap) kept as
    ``logit_gap_median`` and ``logit_gap`` the widest over the requests
    of a request's gap at ``QUANTILE``."""
    gaps = [g.float() for g in gaps]
    numbers = generate_mla.gap_numbers(gaps)
    numbers["logit_gap_median"] = numbers.pop("logit_gap")
    numbers["logit_gap"] = max(float(g.quantile(QUANTILE)) for g in gaps)
    return numbers
