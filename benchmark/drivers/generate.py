"""Entry driver ``generate``: a closed loop of greedy ``generate`` calls.

Set-up builds a ``Llama`` and fills it from the seed's weights with
``load_state_dict``, one group at a time. Call i takes ``batch`` prompts
of one length: the traffic's ``prompt_lens`` are one cycle of lengths,
which every seed runs in its own order, so that every seed does the same
work (see :meth:`Driver.prompt_len`). Each call ends with its tokens on
the host, as a caller reads them.

Set-up warms each cache length that the cycle's lengths need (the
smallest multiple of 128 that holds prompt and new tokens), and the
decode graph that each holds, with the least that captures it: one call
of two new tokens (a prefill and one decode step), its prompt the
longest of the cycle's in that cache length, lengthened where need be
until prompt and two tokens fill that cache length.

The check takes a sample, drawn from the seed, of the requests (rows)
that the window finished, with one of the longest prompts in it and as
many distinct rows of a call as the sample holds, and runs the
reference over each prompt with its served tokens.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import weights
from benchmark.reference import compare, llama_ref

# New tokens of a warm-up call: the first comes from the prefill, the
# second from one decode step, which captures the graph.
WARM_NEW = 2


class Driver:
    def __init__(self, shape, traffic, seed: int, device) -> None:
        from rocnrdma_tpu_torch.models.llama import (Llama, LlamaConfig,
                                                     generate)

        self.shape, self.traffic, self.seed = shape, traffic, seed
        self.device = torch.device(device)
        self.b, self.new = traffic["batch"], traffic["new_tokens"]
        # The cycle of prompt lengths, in groups that a seed keeps
        # together: a group of lengths that sum alike (a short and a long
        # one) keeps every prefix of the window near the same work.
        self.groups = [g if isinstance(g, list) else [g]
                       for g in traffic["prompt_lens"]]
        self._generate = generate
        cfg = LlamaConfig(
            name=shape.name, vocab_size=shape.vocab_size,
            d_model=shape.d_model, n_layers=shape.n_layers,
            n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads,
            d_ff=shape.d_ff, max_seq_len=shape.max_seq_len,
            rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
            dtype=shape.torch_dtype)
        self.model = Llama(cfg, self.device)
        for group in weights.draw_all(shape, seed, self.device,
                                      shape.torch_dtype):
            self.model.load_state_dict(group, strict=False)
            del group
        self.next = 0
        longest = {}
        for p in sum(self.groups, []):
            c = self.cache_len(p, self.new)
            longest[c] = max(p, longest.get(c, 0))
        for c, p in sorted(longest.items()):
            while self.cache_len(p, WARM_NEW) < c:
                p += 1
            self._call(self.prompt(-1 - p, p), WARM_NEW)

    def cache_len(self, p: int, new: int) -> int:
        """The cache length of a call of prompt ``p`` and ``new`` tokens,
        as ``generate`` sizes it: the smallest multiple of 128 that holds
        both, at most the configuration's positions."""
        return min(self.shape.max_seq_len, -(-(p + new) // 128) * 128)

    def prompt_len(self, index: int) -> int:
        """Call ``index``'s prompt length: each cycle runs every length
        once, its groups in an order drawn from the seed and each group's
        lengths in an order of their own."""
        cycle, at = divmod(index, sum(len(g) for g in self.groups))
        rng = np.random.default_rng(
            weights.mix(self.seed, weights.ORDER, cycle))
        order = [p for j in rng.permutation(len(self.groups))
                 for p in rng.permutation(self.groups[j])]
        return int(order[at])

    def prompt(self, index: int, p: int) -> torch.Tensor:
        return weights.tokens(self.device, self.shape.vocab_size, self.b, p,
                              self.seed, weights.PROMPT, index)

    def _call(self, prompt: torch.Tensor, new: int) -> torch.Tensor:
        with record_function("bench.generate"):
            return self._generate(self.model, prompt, new,
                                  device=self.device).cpu()

    def unit(self) -> dict:
        i = self.next
        self.next += 1
        p = self.prompt_len(i)
        tokens = self._call(self.prompt(i, p), self.new)
        return {"index": i, "b": self.b, "p": p, "new": self.new,
                "tokens": tokens}

    @staticmethod
    def end_to_end(win: dict) -> dict:
        units, t = win["units"], win["elapsed"]
        return {"decode_tok_s": sum(u["b"] * u["new"] for u in units) / t,
                "prefill_tok_s": sum(u["b"] * u["p"] for u in units) / t}

    @staticmethod
    def attempted(win: dict):
        return sum(u["b"] for u in win["units"]), 0

    def release(self) -> None:
        del self.model

    def sample(self, units: list):
        """(call index, row) of the requests to check, drawn from the
        seed: a row of a call with the longest prompt, then others, each
        in a row that no earlier pick holds while rows are left, so that
        a fault in one row of a call is as likely as may be to be in
        the sample."""
        rng = np.random.default_rng(weights.mix(self.seed, weights.SAMPLE))
        longest = max(units, key=lambda u: u["p"])
        first = (longest["index"], int(rng.integers(longest["b"])))
        pairs = [(u["index"], r) for u in units for r in range(u["b"])]
        rest = [pairs[j] for j in rng.permutation(len(pairs))
                if pairs[j] != first]
        k = min(len(rest), self.traffic["check_requests"] - 1)
        picked, rows = [first], {first[1]}
        for pr in rest:
            if len(picked) <= k and pr[1] not in rows:
                picked.append(pr)
                rows.add(pr[1])
        left = [pr for pr in rest if pr not in picked]
        return picked + left[:k + 1 - len(picked)]

    def _served(self, win: dict, precs):
        by_index = {u["index"]: u for u in win["units"]}
        requests = []
        for i, r in self.sample(win["units"]):
            u = by_index[i]
            requests.append((self.prompt(i, u["p"])[r], u["tokens"][r]))
        logits = llama_ref.served_logits(self.shape, self.seed, requests,
                                         self.shape.torch_dtype, self.device,
                                         precs)
        return logits, [t for _, t in requests]

    def numbers(self, win: dict) -> dict:
        logits, served = self._served(win, ("f32",))
        return compare.served_numbers(
            float(llama_ref.served_gaps(lg["f32"], t).max())
            for lg, t in zip(logits, served))

    def control(self, win: dict) -> dict:
        """The program's numbers beside the control's: the reference in
        fp8, at each position of the same prompts and served tokens,
        judged by the gap of the token it puts first."""
        logits, served = self._served(win, ("f32", "fp8"))
        prog = compare.served_numbers(
            float(llama_ref.served_gaps(lg["f32"], t).max())
            for lg, t in zip(logits, served))
        fp8 = compare.served_numbers(
            float(llama_ref.served_gaps(lg["f32"], lg["fp8"].argmax(-1)).max())
            for lg in logits)
        return {"program": prog, "fp8": fp8}
