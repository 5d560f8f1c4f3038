"""Entry driver ``generate_mla``: the closed loop of greedy ``generate``
calls of ``drivers/generate.py`` over a latent-attention, routed-expert
model (the program's ``MlaMoe``).

Everything but the model is the ``generate`` driver's: the cycle of
prompt lengths, the prompts, the units, the rates, the warm-up of each
cache length (one call of two new tokens, which captures the decode
graph) and the sample of requests that the check takes. Set-up reads the
whole configuration file by the cell's name, builds the model from its
published keys and fills it from the seed's weights one group at a time
(:mod:`benchmark.weights_mla`); the check runs the plain reference
(:mod:`benchmark.reference.mla_moe_ref`) over each sampled prompt with
its served tokens.

The number it compares, ``logit_gap``, is the widest over the sampled
requests of a request's median gap: the median, over its served
positions, of the gap by which the served token's reference logit lies
below the reference's best (the ``generate`` driver takes a request's
widest gap instead). Its readings are the widest request's mean gap
(``logit_gap_mean``), its share of positions off the reference's best
(``argmax_miss_share``) and the widest gap at any one position
(``logit_gap_widest``). Random weights make this model's routing
sensitive: a token whose sixth and seventh expert scores nearly tie
picks another expert under another rounding, and 26 expert layers and
the attention carry that on, so the program in bf16 misses the
reference's best token at most positions, and its widest gap overlaps
the reference's in fp8. A request's median reads the fp8 control at
3.4 times the program's widest (PERF.md §2); its mean at 2.6 times.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import harness, weights_mla
from benchmark.drivers import generate
from benchmark.reference import compare, llama_ref, mla_moe_ref

BENCH = Path(__file__).resolve().parent.parent


class Driver(generate.Driver):
    def __init__(self, shape, traffic, seed: int, device) -> None:
        from rocnrdma_tpu_torch.models.llama import generate as gen
        from rocnrdma_tpu_torch.models.mla_moe import MlaMoe, MlaMoeConfig

        self.shape, self.traffic, self.seed = shape, traffic, seed
        self.device = torch.device(device)
        self.b, self.new = traffic["batch"], traffic["new_tokens"]
        self.groups = [g if isinstance(g, list) else [g]
                       for g in traffic["prompt_lens"]]
        self._generate = gen
        self.config = harness.Bench(BENCH).config(shape.name)
        self.model = MlaMoe(MlaMoeConfig.from_hf(self.config), self.device)
        for group in weights_mla.draw_all(self.config, seed, self.device,
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
        logits = mla_moe_ref.served_logits(self.config, self.seed, requests,
                                           self.shape.torch_dtype,
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
    """The numbers of the requests' served gaps, each (n,): over the
    requests, the widest of a request's median gap (``logit_gap``), of
    its mean gap (``logit_gap_mean``) and of its share of positions whose
    token is not the reference's best (``argmax_miss_share``), and the
    widest gap at any position (``logit_gap_widest``)."""
    gaps = [g.float() for g in gaps]
    return {"logit_gap": max(float(g.quantile(0.5)) for g in gaps),
            "logit_gap_mean": max(float(g.mean()) for g in gaps),
            "argmax_miss_share": max(float((g > 0).float().mean())
                                     for g in gaps),
            "logit_gap_widest": max(float(g.max()) for g in gaps)}
