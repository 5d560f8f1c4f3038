// Tile math shared by the flash-attention backward kernels
// (flash_bwd_dkv.cu, K4, and flash_bwd_dq.cu, K5): the counterpart of
// rocnrdma_tpu/ops/attention.py:_bwd_tile, so that the two kernels cannot
// rebuild the softmax, its mask or its scale differently.
//
// In the scalar kernels a block of kThreads threads works on one (kBQ
// query rows) x (kBK key rows) tile at a time. Thread (ty, tx) = (tid / 16, tid % 16) owns tile
// rows ty + 16 * i (i < 4) and tile columns tx + 16 * j (j < 4). Tiles
// live in shared memory in f32, rows padded by one float so that the
// column walks below hit distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_bwd {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Copy `rows` rows of width HD from global row r0 into a padded f32 tile
// (leading dimension HD + 1); rows at or past S are zero-filled and never
// read.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int S) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int gr = r0 + r;
    dst[r * (HD + 1) + c] =
        gr < S ? to_f(src[static_cast<size_t>(gr) * HD + c]) : 0.f;
  }
}

// lse and delta of kBQ query rows from row q0; 0 past S.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int gr = q0 + r;
    lse_s[r] = gr < S ? lse[gr] : 0.f;
    delta_s[r] = gr < S ? delta[gr] : 0.f;
  }
}

// The per-element rule of _bwd_tile, the one place both backward
// kernels take it from (softmax_grad_tile below, for the scalar kernels;
// the tensor-core fragment code in flash_bwd_dkv.cu and flash_bwd_dq.cu):
// a (query qi, key kj) pair is visible when both lie inside the
// sequence and, when causal, the key does not follow the query
// (a query row at or past S is masked whole, so rows beyond the sequence
// contribute nothing; the JAX package gets the same by padding dO with
// zeros); with s = q . k and dp = dO . v,
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

// One tile of the softmax gradient (the body of _bwd_tile) by the rule
// above, for the scalar kernels: writes p (when P is not null) and ds into
// padded [kBQ][kBK + 1] shared tiles.
template <int HD>
__device__ __forceinline__ void softmax_grad_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int S,
    float scale, int causal, float* P, float* dS) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
      dov[i] = dOs[(ty + 16 * i) * (HD + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (HD + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      const float p =
          bwd_visible(qi, kj, S, causal) ? bwd_p(s[i][j], scale, l) : 0.f;
      if (P != nullptr) P[r * (kBK + 1) + c] = p;
      dS[r * (kBK + 1) + c] = bwd_ds(p, dp[i][j], dl, scale);
    }
  }
}

}  // namespace flash_bwd
