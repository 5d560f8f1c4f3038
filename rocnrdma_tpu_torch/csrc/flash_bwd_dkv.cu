// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: rocnrdma_tpu/ops/attention.py:_bwd_dkv_kernel (launched by
// _flash_backward; tile math _bwd_tile, here flash_bwd_common.cuh). Same
// contract: q, dO (B,H,S,D), k, v (B,KVH,S,D) in bf16 or f32, lse and
// delta = rowsum(dO * out) (B,H,S,1) f32; dK, dV (B,KVH,S,D) in k's
// dtype. Query head h belongs to kv head h / (H/KVH).
//
// Bound on H100: operations. Per (b, h) it does 8*D flops for every
// visible (query, key) pair (the products Q K^T, dO V^T, P^T dO and
// dS^T Q) against (2 + 4/group) * S * D * elt + 8 * S bytes of inputs
// and outputs (q, dO; k, v, dK, dV shared by the group; lse, delta),
// which at S = 2048, D = 128 sits above the ~295 flop/byte ridge: the
// floor is the flops over the tensor-core peak.
//
// Design (simple and right first, scalar f32 FMA over shared-memory
// tiles, as the forward kernel): one block of 256 threads per (b, kv
// head, tile of 64 key rows). K and V of the tile stay in shared memory
// for the whole block. The TPU's sequential grid axis over group x q
// blocks becomes a loop inside the block: for every query head of the GQA
// group and every q tile from the causal diagonal on (the _first_q_block
// skip), it loads Q, dO, lse and delta, rebuilds P and dS
// (softmax_grad_tile), and adds P^T dO into dV and dS^T Q into dK. The
// accumulators are f32 registers, 4 key rows x D/16 columns per thread
// for each of dK and dV, so the group sum never leaves the chip and needs
// no atomics; the outputs are written once. Keys past S are zero-filled
// and masked; query rows past S are masked in the tile, never read.
// Nothing of size S x S is materialised. Tensor-core products (mma.sync,
// wgmma) and TMA are later work: this kernel does not approach its bound.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; returns cudaGetLastError().

#include "flash_bwd_common.cuh"

namespace {

using namespace flash_bwd;

template <int HD>
constexpr int smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and delta.
  return 2 * kBK * (HD + 1) + 2 * kBQ * (HD + 1) + 2 * kBQ * (kBK + 1) +
         2 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KVH, int S, float scale,
                     int causal) {
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);       // [kBK][HD + 1]
  float* Qs = Vs + kBK * (HD + 1);       // [kBQ][HD + 1]
  float* dOs = Qs + kBQ * (HD + 1);      // [kBQ][HD + 1]
  float* Ps = dOs + kBQ * (HD + 1);      // [kBQ][kBK + 1]
  float* dSs = Ps + kBQ * (kBK + 1);     // [kBQ][kBK + 1]
  float* lse_s = dSs + kBQ * (kBK + 1);  // [kBQ]
  float* delta_s = lse_s + kBQ;          // [kBQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * kBK;

  const size_t kv_off = static_cast<size_t>(bkv) * S * HD;
  load_tile<T, HD>(Ks, k + kv_off, k0, kBK, S);
  load_tile<T, HD>(Vs, v + kv_off, k0, kBK, S);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (S + kBQ - 1) / kBQ;
  const int first_q = causal ? k0 / kBQ : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * H + kvh * group + gi;
    const size_t q_off = static_cast<size_t>(bh) * S * HD;
    for (int qt = first_q; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // previous tile's Q/dO/P/dS fully consumed
      load_tile<T, HD>(Qs, q + q_off, q0, kBQ, S);
      load_tile<T, HD>(dOs, dout + q_off, q0, kBQ, S);
      load_rows(lse_s, delta_s, lse + static_cast<size_t>(bh) * S,
                delta + static_cast<size_t>(bh) * S, q0, S);
      __syncthreads();
      softmax_grad_tile<HD>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, scale,
                            causal, Ps, dSs);
      __syncthreads();
      // dV[kc] += sum_r P[r][kc] * dO[r];  dK[kc] += sum_r dS[r][kc] * Q[r]
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * (kBK + 1) + ty + 16 * i];
          sv[i] = dSs[r * (kBK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dOs[r * (HD + 1) + tx + 16 * c];
          const float qv = Qs[r * (HD + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const size_t row = kv_off + static_cast<size_t>(kj) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = from_f<T>(acc_k[i][c]);
      dv[row + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int S,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBK - 1) / kBK, B * KVH), block(kThreads);
  flash_bwd_dkv_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, KVH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int KVH, int S,
                     float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                            scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int KVH, int S, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(D, q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                        scale, causal, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv, B, H,
                                KVH, S, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
