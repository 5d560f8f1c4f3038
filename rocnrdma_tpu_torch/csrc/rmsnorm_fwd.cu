// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces: rocnrdma_tpu/ops/rmsnorm.py:_rmsnorm_kernel (launched by
// _rmsnorm_fwd_pallas). The TPU kernel keeps a block of rows in VMEM and
// does the reduction and the scale in one HBM round trip; here one thread
// block owns one row.
//
// Bound on H100: bytes. Each element is read once and written once and
// costs ~4 flops, far below the card's ~295 flop/byte ridge, so the floor
// is (2 * rows * d * sizeof(T) + 4 * d) / 3.35 TB/s.
//
// Design against that bound: the row is read from device memory exactly
// once with 16-byte vector loads (8 bf16 or 4 f32 per load, neighbouring
// threads on neighbouring addresses) and held in registers; the sum of
// squares is taken in f32 with a warp-shuffle then shared-memory
// reduction; the second pass scales the registers and stores in x's dtype
// with 16-byte vector stores. A row whose width is not a multiple of the
// vector, or wider than the register budget, takes the scalar kernel,
// which reads x twice (rows of the slice never do).
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
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
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};

// Sum over the block; every thread gets the total. `red` holds one
// partial per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VPT: 16-byte vectors held per thread; the row has at most
// VPT * kThreads vectors.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_vec(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, int d, float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int nvec = d / N;

  float v[VPT][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
      P::load(__ldg(xr + idx), v[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += v[i][j] * v[i][j];
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
      float o[N];
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const float4 ww = __ldg(w4 + (idx * N + j) / 4);
        o[j] = v[i][j] * r * ww.x;
        o[j + 1] = v[i][j + 1] * r * ww.y;
        o[j + 2] = v[i][j + 2] * r * ww.z;
        o[j + 3] = v[i][j + 3] * r * ww.w;
      }
      yr[idx] = P::store(o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_any(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, int d, float eps) {
  using P = Pack<T>;
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float a = P::to_f(xr[i]);
    ss += a * a;
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = P::from_f(P::to_f(xr[i]) * r * w[i]);
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d,
            float eps, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* yp = static_cast<T*>(y);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int nvec = d / N;
  const int vpt = (nvec + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  if (!aligned || d % N != 0 || vpt > 8) {
    rmsnorm_fwd_any<T><<<grid, block, 0, stream>>>(xp, wp, yp, d, eps);
  } else if (vpt <= 1) {
    rmsnorm_fwd_vec<T, 1><<<grid, block, 0, stream>>>(xp, wp, yp, d, eps);
  } else if (vpt <= 2) {
    rmsnorm_fwd_vec<T, 2><<<grid, block, 0, stream>>>(xp, wp, yp, d, eps);
  } else if (vpt <= 4) {
    rmsnorm_fwd_vec<T, 4><<<grid, block, 0, stream>>>(xp, wp, yp, d, eps);
  } else {
    rmsnorm_fwd_vec<T, 8><<<grid, block, 0, stream>>>(xp, wp, yp, d, eps);
  }
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows,
                           int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, rows, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
