// Flash-attention forward for Hopper (sm_90a): online-softmax attention,
// causal or full, grouped-query heads, returning out and the row
// log-sum-exp.
//
// Replaces: rocnrdma_tpu/ops/attention.py:_flash_kernel (launched by
// _flash_forward). Same contract: q (B,H,S,D), k/v (B,KVH,S,D) in bf16 or
// f32; out (B,H,S,D) in q's dtype; lse (B,H,S,1) f32 = m + log(max(l,
// 1e-30)); q head h reads kv head h / (H/KVH) in place; -1e30 masks keys
// past the sequence and, when causal, keys after the query.
//
// Bound on H100: depends on S. A (b, h) pair costs 4*D flops per visible
// (query, key) pair, ~2*D*S^2 causal, against (2 + 2/group)*S*D*elt
// bytes of q, out and its share of k, v: in bf16 at D = 128 that is
// ~0.4*S flops per byte for group 4 and ~0.33*S for group 2. So at
// S = 512 (the 8B prefill) the kernel is bound by bytes, below the ~295
// flop/byte ridge, and from S ~ 900 on (S = 2048 here) by operations: the
// flops over the tensor-core peak (989 TFLOP/s bf16; 67 TFLOP/s for f32
// outside the tensor cores).
//
// Design (simple and right first, scalar FMA): one block of 256 threads
// per (b, h, tile of 64 query rows). The TPU's sequential "arbitrary" kv
// grid axis becomes a loop inside the block over kv tiles of 32 rows held
// in shared memory, so nothing is carried between blocks. The running max
// m, denominator l and the accumulator stay in f32 registers: each of the
// 16 threads of a row group owns 4 query rows, 2 key columns of the score
// tile and D/16 output columns. The loop stops at the causal diagonal (the
// _last_kv_block rule), and the ragged tail is masked in the kernel
// instead of padding the inputs. Tiles are stored in f32 with one padding
// column so that the score loop reads shared memory without bank
// conflicts. wgmma/TMA and tensor-core products are later work: this
// kernel does not approach the operations bound.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // key rows per kv tile
constexpr int kThreads = 256; // 16 row groups x 16 lanes
constexpr float kNegInf = -1e30f;

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

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

// Copy `rows` rows of width HD starting at global row r0 into a padded
// f32 tile; rows at or past S are zero-filled.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int S) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int g = r0 + r;
    dst[r * LD + c] = g < S ? to_f(src[static_cast<size_t>(g) * HD + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int KVH, int S, float scale,
                 int causal) {
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBQ][HD + 1]
  float* Ks = Qs + kBQ * (HD + 1);      // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);      // [kBK][HD]
  float* Ps = Vs + kBK * HD;            // [kBQ][kBK + 1]

  const int tx = threadIdx.x & 15;  // lane within the row group
  const int ty = threadIdx.x >> 4;  // row group: rows ty + 16 * i
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBQ;

  const T* qp = q + static_cast<size_t>(bh) * S * HD;
  const T* kp = k + static_cast<size_t>(b * KVH + kvh) * S * HD;
  const T* vp = v + static_cast<size_t>(b * KVH + kvh) * S * HD;

  int n_kv = (S + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  load_tile<T, HD, HD + 1>(Qs, qp, q0, kBQ, S);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    load_tile<T, HD, HD + 1>(Ks, kp, k0, kBK, S);
    load_tile<T, HD, HD>(Vs, vp, k0, kBK, S);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float k0v = Ks[tx * (HD + 1) + d];
      const float k1v = Ks[(tx + 16) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty + 16 * i) * (HD + 1) + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < S && (!causal || kj <= qi);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      // A masked key contributes exactly 0, so a row that sees no key in
      // this tile (the padded tail) never turns into NaN.
      const float p0 = ok[0] ? expf(s[i][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[i][1] - m_new) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      Ps[(ty + 16 * i) * (kBK + 1) + tx] = p0;
      Ps[(ty + 16 * i) * (kBK + 1) + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vv[cc] = Vs[c * HD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * S + qi) * HD;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) orow[tx + 16 * cc] = from_f<T>(acc[i][cc] / lc);
    if (tx == 0) lse[static_cast<size_t>(bh) * S + qi] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H), block(kThreads);
  flash_fwd_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, KVH, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int H, int KVH, int S,
                     float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int KVH, int S,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(D, q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(D, q, k, v, out, lse, B, H, KVH, S, scale,
                                causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
