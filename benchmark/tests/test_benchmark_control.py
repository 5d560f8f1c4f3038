"""The control, the reference computed in fp8 in the program's place,
has to come out not correct. On the CPU at a tiny size (bf16) it reads
above the program; on the card (``-m gpu``) at each cell's own size, on
one seed, it fails the cell's limits where the program passes them."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import compare


@pytest.mark.parametrize("mix", ["tiny_train", "tiny_gen"])
def test_control_reads_above_the_program_on_the_cpu(tiny, mix):
    shape = harness.shape_of(dict(tiny.config("tiny"),
                                  torch_dtype="bfloat16"))
    traffic = tiny.traffic(mix)
    drv = tiny.driver(traffic["entry"])(shape, traffic, 2 ** 31 + 9, "cpu")
    win = harness.run_window(drv.unit, 0.2)
    drv.release()
    got = drv.control(win)
    name = "grad_gap" if "train" in mix else "logit_gap"
    assert got["fp8"][name] > 3 * got["program"][name]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["train.internlm2-1.8b",
                                  "decode.mistral-7b-v0.3",
                                  "prefill.mistral-7b-v0.3"])
def test_control_fails_the_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); run on the card with -m gpu")
    bench = harness.Bench()
    w = bench.cell(cell)
    shape = harness.shape_of(bench.config(w["config"]))
    traffic = bench.traffic(w["traffic"])
    limits = bench.limits(cell)
    drv = bench.driver(traffic["entry"])(shape, traffic, 2 ** 31 + 17,
                                         "cuda")
    win = harness.run_window(drv.unit, 2.0)
    drv.release()
    torch.cuda.empty_cache()
    got = drv.control(win)
    assert compare.judge(got["program"], limits)[0]
    assert not compare.judge(got["fp8"], limits)[0]
