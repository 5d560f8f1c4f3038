"""The bounds of ``chip_smoke.py``'s ``kernels`` line, at the shapes of
PERF.md §6's kernel table: each entry's and each of its cells'
``bound_ms`` and ``bound_by``. K1-K5, K7 and K9 take them from the
benchmark's yardstick (``benchmark/roofline.py``,
``benchmark/roofline_mla.py``, ``benchmark/roofline_kimi.py``), as G1's
GEMMs alone do; K6, G1's
whole call and K8, which the benchmark does not bound, are written on
its ``bound_s``. The expected values are the table's, to the last bit, so a
change to either side shows here before the table and the benchmark's
``kernels_roofline.*`` drift apart.
"""

from functools import partial

import pytest
import torch

import chip_smoke as cs

bf, f32 = torch.bfloat16, torch.float32
OPS, BYTES = "operations", "bytes"


def _flash(kernel, cases):
    return [(partial(cs.flash_bound, kernel, *shape), want)
            for shape, want in cases]


# (B, H, KVH, S, D, causal, dtype): (a), (c), (g) full / causal /
# Ulysses, (i), the scalar f32 route at S 85, 225, 256, 512 full, 2048.
K3 = [((4, 32, 8, 512, 128, True, bf), (0.012598562388059701, BYTES)),
      ((2, 16, 8, 2048, 128, True, bf), (0.03475886307785642, OPS)),
      ((1, 16, 8, 4096, 128, False, bf), (0.1389675970394338, OPS)),
      ((1, 16, 8, 4096, 128, True, bf), (0.06950076233771486, OPS)),
      ((1, 8, 4, 8192, 128, True, bf), (0.13898456085743174, OPS)),
      ((1, 8, 4, 2048, 128, True, bf), (0.008689715769464104, OPS)),
      ((1, 16, 8, 85, 128, True, f32), (0.0006251940298507463, BYTES)),
      ((1, 16, 8, 225, 128, True, f32), (0.0031086805970149253, OPS)),
      ((1, 16, 8, 256, 128, True, f32), (0.004022149731343284, OPS)),
      ((1, 16, 8, 512, 128, False, f32), (0.03205199474626866, OPS)),
      ((1, 16, 8, 2048, 128, True, f32), (0.2565411610746269, OPS))]
# (c), (g) full / causal / Ulysses, (i), the scalar f32 route at S 200,
# 512 full, 2048.
BWD_SHAPES = [(2, 16, 8, 2048, 128, True, bf), (1, 16, 8, 4096, 128, False, bf),
              (1, 16, 8, 4096, 128, True, bf), (1, 8, 4, 8192, 128, True, bf),
              (1, 8, 4, 2048, 128, True, bf), (1, 16, 8, 200, 128, True, f32),
              (1, 16, 8, 512, 128, False, f32),
              (1, 16, 8, 2048, 128, True, f32)]
K4 = [0.06951772615571283, 0.2779351940788676, 0.13900152467542973,
      0.2779691217148635, 0.01737943153892821, 0.0049152,
      0.06410398949253732, 0.5130823221492538]
K5 = [0.05213829461678463, 0.20845139555915065, 0.1042511435065723,
      0.20847684128614763, 0.013034573654196158, 0.0036864,
      0.04807799211940298, 0.3848117416119403]

CASES = {
    "K1 rmsnorm_fwd": [
        (partial(cs.rmsnorm_bound, 2048, 4096, bf, backward=False),
         (0.010021139104477612, BYTES))],
    "K2 rmsnorm_bwd": [
        (partial(cs.rmsnorm_bound, 4096, 2048, bf, backward=True),
         (0.01502926328358209, BYTES))],
    "K3 flash_fwd": _flash("flash_fwd", K3),
    "K4 flash_bwd_dkv": _flash("flash_bwd_dkv", [
        (shape, (ms, OPS)) for shape, ms in zip(BWD_SHAPES, K4)]),
    "K5 flash_bwd_dq": _flash("flash_bwd_dq", [
        (shape, (ms, OPS)) for shape, ms in zip(BWD_SHAPES, K5)]),
    # (B, H, KVH, D, pos, dtype): (a), the decode cell at its shortest,
    # mean and longest prompts, the prefill cell.
    "K6 decode_attn": [
        (partial(cs.decode_attn_bound, *args), (ms, BYTES))
        for args, ms in (((4, 32, 8, 128, 540, bf), 0.0026654567164179107),
                         ((128, 32, 8, 128, 777, bf), 0.12238603462686569),
                         ((128, 32, 8, 128, 960, bf), 0.1510262447761194),
                         ((128, 32, 8, 128, 1144, bf), 0.17982295880597013),
                         ((16, 32, 8, 128, 8250, bf), 0.16149244179104477))],
    # B 64 over the decode-mla cell's cache, at its mean and last
    # position; at 32 heads, B 128 over the decode-hybrid cell's.
    "K7 mla_decode": [
        (partial(cs.mla_decode_bound, 64, 4033), (0.08944685850746269, BYTES)),
        (partial(cs.mla_decode_bound, 64, 4223), (0.09362844656716418, BYTES)),
        (partial(cs.mla_decode_bound, 128, 1800,
                 cs.rlk.mla_config(cs.KIMI)), (0.08193467223880596, BYTES)),
        (partial(cs.mla_decode_bound, 128, 2047,
                 cs.rlk.mla_config(cs.KIMI)), (0.09280680119402986, BYTES))],
    # A decode step's 64 tokens and a prefill chunk's 65,536, and the
    # chunk's two GEMMs alone (the entry's ``many_rows``).
    "G1 moe_gemm": [
        (partial(cs.grouped_swiglu_bound, 64), (0.3321207976119403, BYTES)),
        (partial(cs.grouped_swiglu_bound, 65536), (6.878896053451972, OPS)),
        (partial(cs.grouped_gemm_bounds, 65536),
         (4.585930702301314, 2.292965351150657))],
    # A decode step's 64 tokens and a 62,400-token prefill chunk's.
    "K8 moe_combine": [
        (partial(cs.combine_bound, 64), (0.0006269325373134329, BYTES)),
        (partial(cs.combine_bound, 62400), (0.6112592238805971, BYTES))],
    # A decode step's 128 sequences of one token and a prefill chunk's
    # 40 of 1,600 at the decode-hybrid cell's 32 heads.
    "K9 kda_recurrent": [
        (partial(cs.kda_bound, 128, 1), (0.16214291104477613, BYTES)),
        (partial(cs.kda_bound, 40, 1600), (0.9915498985074627, BYTES))],
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_kernel_table_bounds(kernel):
    for call, want in CASES[kernel]:
        assert call() == want, (call, want)
