// The per-element rule shared by the flash-attention backward kernels
// (flash_bwd_dkv.cu, K4, and flash_bwd_dq.cu, K5), in both their routes:
// the counterpart of rocnrdma_tpu/ops/attention.py:_bwd_tile, so that the
// two kernels cannot rebuild the softmax, its mask or its scale
// differently.
//
// The scalar routes (f32 at every D, bf16 at D 16 and 32) follow K3's
// (scalar_route.cuh): a warp owns 8 rows for its whole loop (query rows
// in K5, key rows in K4) and the other operand streams past it in 32-row
// tiles through a 2-stage cp.async ring. Each warp rebuilds its 8 x 32
// tile of s = q . k and dp = dO . v (warp_dot: each lane sums a quarter
// of D for all 8 rows against 4 tile rows, then two shuffle exchanges
// leave it 2 rows x 4 columns), applies the rule below in registers,
// passes p and ds through a per-warp slice of shared memory (under
// __syncwarp, never a block barrier) and accumulates the second products
// register-blocked (scalar_route::RowTile). Every sum of a row runs in one
// fixed order (s and dp by warp_dot's tree; dQ over keys ascending; dK
// and dV over the group's heads, then query rows ascending), whatever
// block size the launch picks; a tile a warp skips or finds fully masked
// adds exact zeros, so a row's result is bitwise the same at any batch
// size.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "scalar_route.cuh"

namespace flash_bwd {

constexpr int kBT = 32;            // rows per ring tile of the scalar routes
constexpr int kPStride = kBT + 8;  // p / ds slice row stride: 8 banks apart
constexpr int kNJ = kBT / 8;       // tile rows per lane in warp_dot

// The per-element rule of _bwd_tile, the one place both backward
// kernels take it from: a (query qi, key kj) pair is visible when both
// lie inside the sequence and, when causal, the key does not follow the
// query (a query row at or past S is masked whole, so rows beyond the
// sequence contribute nothing; the JAX package gets the same by padding
// dO with zeros); with s = q . k and dp = dO . v,
//   p  = exp(s * scale - lse)          (0 where not visible),
//   ds = p * (dp - delta) * scale.
__device__ __forceinline__ bool bwd_visible(int qi, int kj, int S,
                                            int causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}
__device__ __forceinline__ float bwd_p(float s, float scale, float lse) {
  return expf(s * scale - lse);
}
__device__ __forceinline__ float bwd_ds(float p, float dp, float delta,
                                        float scale) {
  return p * (dp - delta) * scale;
}

// out = A B^T for a warp's 8 rows (A: rows of stride ld from a) against
// the kBT rows of a tile (B: stride ld from b), scalar f32 FMA. Lane
// (dq, g) = (lane / 8, lane % 8) sums the D quarter dq of all 8 rows
// against tile rows g + 8 j: a step of 4 along D reads 8 A float4s and
// kNJ B float4s for 128 FMAs. Two butterfly exchanges (lanes 16 apart,
// then 8 apart) add the quarters in a fixed tree, (q0 + q2) + (q1 + q3)
// or its mirror, whatever the grid. A lane's register row i holds A row
// i ^ 2 dq, so each exchange keeps the lower registers and sends the upper
// ones; the lane ends with rows 2 dq and 2 dq + 1 in out[0] and out[1].
template <typename T, int HD>
__device__ __forceinline__ void warp_dot(const T* a, const T* b, int ld,
                                         int lane, float (&out)[2][kNJ]) {
  using scalar_route::kRows;
  using scalar_route::ld4;
  constexpr int kQuarter = HD / 4;
  const int dq = lane >> 3, g = lane & 7;
  const int rsw = 2 * dq;
  const T* ap = a + dq * kQuarter;
  const T* bp = b + g * ld + dq * kQuarter;
  float part[kRows][kNJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) part[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < kQuarter; d += 4) {
    float4 bv[kNJ];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) bv[j] = ld4(bp + 8 * j * ld + d);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 av = ld4(ap + (i ^ rsw) * ld + d);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        part[i][j] = fmaf(av.x, bv[j].x, part[i][j]);
        part[i][j] = fmaf(av.y, bv[j].y, part[i][j]);
        part[i][j] = fmaf(av.z, bv[j].z, part[i][j]);
        part[i][j] = fmaf(av.w, bv[j].w, part[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      part[i][j] += __shfl_xor_sync(0xffffffffu, part[i + 4][j], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      part[i][j] += __shfl_xor_sync(0xffffffffu, part[i + 2][j], 8);
      out[i][j] = part[i][j];
    }
}

}  // namespace flash_bwd
