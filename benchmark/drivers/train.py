"""Entry driver ``train``: the port's ``Trainer.step`` on fresh batches.

Set-up builds one ``Trainer`` from the seed's weights and drives it
through the traffic's ``check_steps`` first steps, by the same call and
feed as the window; those steps are also its warm-up. It reads, for the
check, each step's loss, each weight's first gradient as AdamW got it
(its first moment after one step over 1 - beta1) and each weight's
change over those steps. The window then steps the same trainer on.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from benchmark import weights
from benchmark.reference import compare, llama_ref

BETA1 = 0.9


class Driver:
    def __init__(self, shape, traffic, seed: int, device) -> None:
        from rocnrdma_tpu_torch.models.llama import LlamaConfig
        from rocnrdma_tpu_torch.parallel.trainer import Trainer

        self.shape, self.traffic, self.seed = shape, traffic, seed
        self.device = torch.device(device)
        self.b, self.s = traffic["batch"], traffic["seq_len"]
        cfg = LlamaConfig(
            name=shape.name, vocab_size=shape.vocab_size,
            d_model=shape.d_model, n_layers=shape.n_layers,
            n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads,
            d_ff=shape.d_ff, max_seq_len=shape.max_seq_len,
            rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
            dtype=shape.torch_dtype, remat=traffic["remat"],
            remat_policy=traffic.get("remat_policy", "full"))
        start = {}
        for group in weights.draw_all(shape, seed, self.device,
                                      shape.torch_dtype):
            start.update(group)
        self.trainer = Trainer(cfg, params=start,
                               learning_rate=traffic["learning_rate"],
                               weight_decay=traffic["weight_decay"],
                               device=self.device)
        self.next = 0
        losses = []
        for step in range(traffic["check_steps"]):
            losses.append(self.unit()["loss"])
            if step == 0:
                grad_norms = self._first_grads()
        with torch.no_grad():
            change = {k: float((t.float() - start[k].float()).norm())
                      for k, t in self.trainer.state_dict().items()}
        self.readings = {"losses": losses, "grad_norms": grad_norms,
                         "change": change}

    def _first_grads(self):
        """0 for a weight that AdamW holds no state for."""
        opt = self.trainer.opt
        with torch.no_grad():
            return {k: float(opt.state[p]["exp_avg"].float().norm())
                    / (1 - BETA1) if "exp_avg" in opt.state.get(p, {})
                    else 0.0
                    for k, p in self.trainer.model.named_parameters()}

    def batch(self, index: int) -> torch.Tensor:
        return weights.tokens(self.device, self.shape.vocab_size, self.b,
                              self.s + 1, self.seed, weights.BATCH, index)

    def unit(self) -> dict:
        """One step on the next batch; ``step`` returns the loss as a
        float, so the step has ended on the device."""
        tokens = self.batch(self.next)
        self.next += 1
        with record_function("bench.train_step"):
            loss = self.trainer.step(tokens)
        return {"b": self.b, "s": self.s, "loss": loss,
                "failed": not math.isfinite(loss)}

    @staticmethod
    def end_to_end(win: dict) -> dict:
        return {"train_tok_s": sum(u["b"] * u["s"] for u in win["units"])
                / win["elapsed"]}

    @staticmethod
    def attempted(win: dict):
        return len(win["units"]), sum(u["failed"] for u in win["units"])

    def release(self) -> None:
        del self.trainer

    def _reference(self, **kw) -> dict:
        t = self.traffic
        return llama_ref.train_steps(
            self.shape, self.seed,
            [self.batch(i) for i in range(t["check_steps"])],
            self.shape.torch_dtype, self.device, t["learning_rate"],
            t["weight_decay"], **kw)

    def numbers(self, win: dict) -> dict:
        return compare.train_numbers(self.readings, self._reference())

    def control(self, win: dict) -> dict:
        """The program's numbers beside those of the control (the
        reference in fp8 in the program's place) and of a planted fault
        (the reference on half of each batch, the mean over that half)."""
        ref = self._reference()
        half = list(range(self.b // 2))
        return {"program": compare.train_numbers(self.readings, ref),
                "fp8": compare.train_numbers(self._reference(prec="fp8"),
                                             ref),
                "half_batch": compare.train_numbers(
                    self._reference(rows=half), ref)}
