"""The plain reference against the port's model and trainer on the CPU
at a tiny size, in float32, where both should agree to round-off."""

import torch

from benchmark import harness, weights
from benchmark.reference import compare, llama_ref


def _shape(tiny):
    return harness.shape_of(tiny.config("tiny"))


def test_served_logits_match_the_port(tiny):
    from rocnrdma_tpu_torch.models.llama import Llama, LlamaConfig

    shape = _shape(tiny)
    cfg = LlamaConfig(name="tiny", vocab_size=shape.vocab_size,
                      d_model=shape.d_model, n_layers=shape.n_layers,
                      n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads,
                      d_ff=shape.d_ff, max_seq_len=shape.max_seq_len,
                      rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
                      dtype=torch.float32)
    model = Llama(cfg, "cpu")
    for group in weights.draw_all(shape, 11, "cpu", torch.float32):
        model.load_state_dict(group, strict=False)
    prompt = weights.tokens("cpu", shape.vocab_size, 1, 20, 11, 9, 0)[0]
    served = weights.tokens("cpu", shape.vocab_size, 1, 6, 11, 9, 1)[0]
    got = llama_ref.served_logits(shape, 11, [(prompt, served)],
                                  torch.float32, "cpu")[0]["f32"]
    with torch.no_grad():
        want = model(torch.cat([prompt, served[:-1]])[None])[0, 19:]
    assert got.shape == want.shape == (6, shape.vocab_size)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    gaps = llama_ref.served_gaps(got, want.argmax(-1))
    assert float(gaps.max()) == 0.0


def test_train_steps_match_the_port(tiny):
    from rocnrdma_tpu_torch.models.llama import LlamaConfig
    from rocnrdma_tpu_torch.parallel.trainer import Trainer

    shape = _shape(tiny)
    cfg = LlamaConfig(name="tiny", vocab_size=shape.vocab_size,
                      d_model=shape.d_model, n_layers=shape.n_layers,
                      n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads,
                      d_ff=shape.d_ff, max_seq_len=shape.max_seq_len,
                      rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
                      dtype=torch.float32)
    start = {}
    for group in weights.draw_all(shape, 3, "cpu", torch.float32):
        start.update(group)
    trainer = Trainer(cfg, params=start, device="cpu")
    batches = [weights.tokens("cpu", shape.vocab_size, 2, 17, 3, 2, i)
               for i in range(3)]
    losses = [trainer.step(b) for b in batches]
    ref = llama_ref.train_steps(shape, 3, batches, torch.float32, "cpu",
                                3e-4, 0.1)
    assert max(abs(a - b) for a, b in zip(losses, ref["losses"])) < 1e-5
    change = {k: float((t - start[k]).norm())
              for k, t in trainer.state_dict().items()}
    assert compare.worst_leaf(change, ref["change"]) < 1e-3
