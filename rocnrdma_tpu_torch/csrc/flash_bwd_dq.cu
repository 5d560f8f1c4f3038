// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: rocnrdma_tpu/ops/attention.py:_bwd_dq_kernel (launched by
// _flash_backward; tile math _bwd_tile, here flash_bwd_common.cuh). Same
// contract: q, dO (B,H,S,D), k, v (B,KVH,S,D) in bf16 or f32, lse and
// delta = rowsum(dO * out) (B,H,S,1) f32; dQ (B,H,S,D) in q's dtype.
// Query head h reads kv head h / (H/KVH) in place.
//
// Bound on H100: operations. Per (b, h) it does 6*D flops for every
// visible (query, key) pair (Q K^T, dO V^T and dS K) against
// (3 + 2/group) * S * D * elt + 8 * S bytes, above the ~295 flop/byte
// ridge at S = 2048, D = 128: the floor is the flops over the tensor-core
// peak.
//
// Design (simple and right first, scalar f32 FMA over shared-memory
// tiles): one block of 256 threads per (b, h, tile of 64 query rows).
// Q, dO, lse and delta of the tile stay in shared memory; the TPU's
// sequential kv grid axis becomes a loop inside the block over kv tiles of
// 64 rows, which stops at the causal diagonal (the _last_kv_block rule).
// Each kv tile rebuilds dS (softmax_grad_tile) and adds dS K into the
// f32 accumulator, 4 query rows x D/16 columns per thread in registers,
// written once in q's dtype. Keys past S are zero-filled and masked;
// query rows past S are masked in the tile and never written. Nothing of
// size S x S is materialised. Tensor-core products and TMA are later work.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; returns cudaGetLastError().

#include "flash_bwd_common.cuh"

namespace {

using namespace flash_bwd;

template <int HD>
constexpr int smem_floats() {
  // Q, dO, K, V tiles; the dS tile; lse and delta.
  return 2 * kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * (kBK + 1) + 2 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KVH, int S, float scale, int causal) {
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][HD + 1]
  float* dOs = Qs + kBQ * (HD + 1);      // [kBQ][HD + 1]
  float* Ks = dOs + kBQ * (HD + 1);      // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);       // [kBK][HD + 1]
  float* dSs = Vs + kBK * (HD + 1);      // [kBQ][kBK + 1]
  float* lse_s = dSs + kBQ * (kBK + 1);  // [kBQ]
  float* delta_s = lse_s + kBQ;          // [kBQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBQ;

  const size_t q_off = static_cast<size_t>(bh) * S * HD;
  const size_t kv_off = static_cast<size_t>(b * KVH + kvh) * S * HD;
  load_tile<T, HD>(Qs, q + q_off, q0, kBQ, S);
  load_tile<T, HD>(dOs, dout + q_off, q0, kBQ, S);
  load_rows(lse_s, delta_s, lse + static_cast<size_t>(bh) * S,
            delta + static_cast<size_t>(bh) * S, q0, S);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  int n_kv = (S + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's K/V/dS fully consumed
    load_tile<T, HD>(Ks, k + kv_off, k0, kBK, S);
    load_tile<T, HD>(Vs, v + kv_off, k0, kBK, S);
    __syncthreads();
    softmax_grad_tile<HD>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, scale,
                          causal, nullptr, dSs);
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] * K[c]
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float kv = Ks[c * (HD + 1) + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(sv[i], kv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const size_t row = q_off + static_cast<size_t>(qi) * HD;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dq[row + tx + 16 * cc] = from_f<T>(acc[i][cc]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H), block(kThreads);
  flash_bwd_dq_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, KVH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int KVH, int S, float scale,
                     int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale,
                           causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale,
                           causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale,
                           causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH, S,
                            scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int KVH, int S, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(D, q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale,
                        causal, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B, H, KVH,
                                S, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
