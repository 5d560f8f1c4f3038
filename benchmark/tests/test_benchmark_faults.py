"""A run whose timed path is broken underneath comes out not correct:
each fault a one-chip cell can have, planted in the port on the CPU at
a tiny size, with the cells' own limits. (The exchange between chips
is not a fault these cells can have: each runs on one chip.)"""

import time

import pytest

from benchmark import harness

SEED = 2 ** 31 + 3


def _run(tiny, cell):
    return harness.run_cell(tiny, cell, SEED, 0.2, False,
                            time.perf_counter(), "cpu")


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.gen"])
def test_sound_runs_are_correct(tiny, cell):
    assert _run(tiny, cell)["correct"] is True


def test_a_step_that_leaves_its_state_unchanged(tiny, monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    res = _run(tiny, "tiny.train")
    assert res["correct"] is False
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tiny, monkeypatch):
    from rocnrdma_tpu_torch.parallel import trainer

    full = trainer.loss_fn
    monkeypatch.setattr(trainer, "loss_fn",
                        lambda model, tokens: full(model,
                                                   tokens[:len(tokens) // 2]))
    res = _run(tiny, "tiny.train")
    assert res["correct"] is False


def test_a_token_altered_where_it_is_produced(tiny, monkeypatch):
    from rocnrdma_tpu_torch.models import llama

    pick = llama._pick
    calls = []

    def altered(logits, temperature, generator):
        calls.append(1)
        tok = pick(logits, temperature, generator)
        # The third token of every call, in every row.
        return (tok + 1) % logits.shape[-1] if len(calls) % 6 == 3 else tok

    monkeypatch.setattr(llama, "_pick", altered)
    res = _run(tiny, "tiny.gen")
    assert res["correct"] is False
