// RMSNorm backward for Hopper (sm_90a): for y = x * rstd * w with
// rstd = rsqrt(mean(x^2) + eps),
//   dx = rstd * (g*w - xhat * mean(g*w * xhat)),   xhat = x * rstd,
//   dw = sum over rows of g * xhat (f32).
//
// Replaces: rocnrdma_tpu/ops/rmsnorm.py:_rmsnorm_bwd_kernel (launched by
// _rmsnorm_bwd_pallas; formulas _bwd_math). Same contract: x, g (rows, d)
// in bf16 or f32, w (d,) f32; dx in x's dtype, dw (d,) f32; rows past
// `rows` are never read and never counted into dw.
//
// Bound on H100: bytes. Each element of x and g is read once and each
// element of dx written once, ~10 flops apiece, far below the ~295
// flop/byte ridge: the floor is (3 * rows * d * sizeof(T) + 8 * d) /
// 3.35 TB/s.
//
// Design: the TPU walks row blocks in order and carries dw in VMEM
// scratch across that sequential grid. CUDA blocks run in no order, so
// the sum is split in two passes, with no float atomics and so bitwise the
// same on every run:
//  1. rmsnorm_bwd_rows: block i owns a fixed run of rows (the run length
//     depends only on `rows`). Per row it reads x and g once with 16-byte
//     vector loads into registers, reduces sum(x^2) and sum(g*w*x) across
//     the block (shuffles, then the warps' partials summed in a fixed
//     order), writes dx, and adds g*xhat into per-thread f32 registers
//     that always hold the same columns. At the end the block writes its
//     f32 partial row partial[i, :].
//  2. rmsnorm_bwd_reduce: dw[c] = sum_i partial[i, c], each column summed
//     by 8 threads over a fixed stride of the partials and those 8 sums
//     added in a fixed order. This is the counterpart of the TPU kernel's
//     in-body accumulation, not a library reduction.
// Widths: d must be a multiple of the 16-byte vector (4 f32 or 8 bf16
// elements) and hold at most 4 vectors per thread (d <= 4096 in f32,
// 8192 in bf16), and every pointer 16-byte aligned; anything else is
// refused with cudaErrorInvalidValue. Every Llama width the port runs
// (64 .. 4096) fits; the wrapper checks the width before it launches.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; `blocks` bounds the number of partial
// rows (the caller allocates partial as (blocks, d) f32); returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;  // elements per 16-byte vector
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      float2 p = __bfloat1622float2(h);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Sums of a and b over the block; every thread gets both totals, added in
// the same fixed order. `red` holds 2 * kWarps floats and is free again
// when this returns.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    a += red[i];
    b += red[kWarps + i];
  }
  __syncthreads();
}

// Rows [r0, r1) of block blockIdx.x, with r0 = blockIdx.x * rpb.
__device__ __forceinline__ void row_range(int rows, int rpb, int& r0,
                                          int& r1) {
  r0 = blockIdx.x * rpb;
  r1 = min(rows, r0 + rpb);
}

// VPT: 16-byte vectors held per thread; the row has at most
// VPT * kThreads vectors.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_vec(const T* __restrict__ x, const float* __restrict__ w,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ partial, int rows, int d, int rpb,
                     float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  __shared__ float red[2 * kWarps];
  const int nvec = d / N;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  int r0, r1;
  row_range(rows, rpb, r0, r1);

  float acc[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;

  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * d;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* gr = reinterpret_cast<const uint4*>(g + off);
    uint4* dxr = reinterpret_cast<uint4*>(dx + off);
    float xv[VPT][N], gv[VPT][N];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < nvec) {
        P::load(__ldg(xr + idx), xv[i]);
        P::load(__ldg(gr + idx), gv[i]);
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 ww = __ldg(w4 + (idx * N + j) / 4);
          const float wj[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ss += xv[i][j + e] * xv[i][j + e];
            dot += gv[i][j + e] * wj[e] * xv[i][j + e];
          }
        }
      }
    }
    block_sum2(ss, dot, red);
    const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
    // mean(g*w * xhat) = rstd * sum(g*w*x) / d
    const float proj = rstd * dot / static_cast<float>(d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < nvec) {
        float o[N];
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 ww = __ldg(w4 + (idx * N + j) / 4);
          const float wj[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xhat = xv[i][j + e] * rstd;
            o[j + e] = rstd * (gv[i][j + e] * wj[e] - xhat * proj);
            acc[i][j + e] += gv[i][j + e] * xhat;
          }
        }
        dxr[idx] = P::store(o);
      }
    }
  }

  float4* pr = reinterpret_cast<float4*>(partial +
                                         static_cast<size_t>(blockIdx.x) * d);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        pr[(idx * N + j) / 4] =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

// dw[c] = sum over the nblk partial rows, in a fixed order: thread
// (lane c, slice s) of a block sums partial rows s, s + 8, ... of column
// c, then the 8 slices are added in order 0..7.
constexpr int kRedCols = 32;
constexpr int kRedSlices = kThreads / kRedCols;

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_reduce(const float* __restrict__ partial, int nblk, int d,
                   float* __restrict__ dw) {
  __shared__ float part[kRedSlices][kRedCols];
  const int lc = threadIdx.x % kRedCols, sl = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + lc;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = sl; b < nblk; b += kRedSlices)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  part[sl][lc] = s;
  __syncthreads();
  if (sl == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRedSlices; ++i) t += part[i][lc];
    dw[c] = t;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* g, void* dx,
           void* partial, void* dw, int rows, int d, int blocks, float eps,
           cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* wp = static_cast<const float*>(w);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  // Rows per block and the number of partial rows depend on `rows` and
  // `blocks` only, so the order of every sum is fixed.
  const int rpb = (rows + blocks - 1) / blocks;
  const int nblk = (rows + rpb - 1) / rpb;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dx) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(partial) % 16 == 0);
  const int nvec = d / N;
  const int vpt = (nvec + kThreads - 1) / kThreads;
  const dim3 grid(nblk), block(kThreads);
  if (!aligned || d % N != 0 || vpt > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vpt <= 1) {
    rmsnorm_bwd_rows_vec<T, 1><<<grid, block, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, d, rpb, eps);
  } else if (vpt <= 2) {
    rmsnorm_bwd_rows_vec<T, 2><<<grid, block, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, d, rpb, eps);
  } else {
    rmsnorm_bwd_rows_vec<T, 4><<<grid, block, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, d, rpb, eps);
  }
  rmsnorm_bwd_reduce<<<(d + kRedCols - 1) / kRedCols, kThreads, 0, stream>>>(
      pp, nblk, d, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* g,
                           void* dx, void* partial, void* dw, int rows, int d,
                           int blocks, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, g, dx, partial, dw, rows, d, blocks, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, g, dx, partial, dw, rows, d, blocks,
                                 eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
