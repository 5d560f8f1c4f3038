// The expert layer's gate and up GEMM (grouped over the experts) for
// Hopper (sm_90a): for each padded row r of expert e = block_expert[r /
// BM] whose pick is row_slot[r] (token row_slot[r] / top_k),
//   h[r, n] = silu(x[tok] . w_gate[e][:, n]) * (x[tok] . w_up[e][:, n]),
// f32 sums, rounded once to bf16; a padding row (row_slot[r] >= n_picks)
// reads zeros and writes zeros. The design, its bound and its contract
// are moe_gemm.cuh's; the plain version is
// ops/moe.py:grouped_swiglu_reference.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// strides are int64 elements (x's rows; an expert's and a row's of
// w_gate and w_up, which share them; h's rows); bm picks the instance (16
// or 128 rows a block, ops/moe.py:block_config); returns
// cudaGetLastError().

#include "moe_gemm.cuh"

namespace {

using Few = moe::Tile<16, 64, 64, 16, 16, 4, 2>;
using Many = moe::Tile<128, 64, 64, 64, 32, 3, 2>;

template <class T>
__global__ void __launch_bounds__(T::kThreads, 2)
moe_gemm_up_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wg,
                   const __nv_bfloat16* __restrict__ wu,
                   __nv_bfloat16* __restrict__ h,
                   const int* __restrict__ row_slot,
                   const int* __restrict__ block_expert, int n_picks,
                   int top_k, int n_experts, int k, long long sx,
                   long long swe, long long swk, long long sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* a_off = reinterpret_cast<long long*>(smem);
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(smem + T::BM * 8);
  const int e = block_expert[blockIdx.x];
  if (e >= n_experts) return;
  const long long row0 = static_cast<long long>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  for (int r = threadIdx.x; r < T::BM; r += T::kThreads) {
    const int slot = row_slot[row0 + r];
    a_off[r] = slot < n_picks ? static_cast<long long>(slot / top_k) * sx
                              : -1;
  }
  __syncthreads();
  const __nv_bfloat16* b[2] = {wg + e * swe, wu + e * swe};
  float acc[2][T::MT][T::NT][4];
  moe::mainloop<T>(acc, stages, x, a_off, b, swk, k, n0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm0 = (warp / T::kWarpsN) * T::WM;
  const int wn0 = (warp % T::kWarpsN) * T::WN;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + wm0 + mt * 16 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * tq;
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float gv = acc[0][mt][nt][2 * half + i];
          const float uv = acc[1][mt][nt][2 * half + i];
          v[i] = gv / (1.f + expf(-gv)) * uv;
        }
        *reinterpret_cast<__nv_bfloat162*>(h + r * sh + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

template <class T>
int launch(const void* x, const void* wg, const void* wu, void* h,
           const void* row_slot, const void* block_expert, int n_picks,
           int top_k, int n_experts, int cap, int k, int n, long long sx,
           long long swe, long long swk, long long sh, cudaStream_t st) {
  if (cap % T::BM || k % T::BK || n % T::BN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  moe_gemm_up_kernel<T><<<dim3(cap / T::BM, n / T::BN), T::kThreads,
                          T::kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<__nv_bfloat16*>(h),
      static_cast<const int*>(row_slot),
      static_cast<const int*>(block_expert), n_picks, top_k, n_experts, k,
      sx, swe, swk, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_gemm_up(const void* x, const void* wg, const void* wu,
                           void* h, const void* row_slot,
                           const void* block_expert, int n_picks, int top_k,
                           int n_experts, int cap, int k, int n, int bm,
                           long long sx, long long swe, long long swk,
                           long long sh, void* stream) {
  bool ok = cap > 0 && top_k > 0 && n_experts > 0 && moe::aligned16(x) &&
            moe::aligned16(wg) && moe::aligned16(wu) && moe::aligned16(h);
  const long long strides[4] = {sx, swe, swk, sh};
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == Few::BM)
    return launch<Few>(x, wg, wu, h, row_slot, block_expert, n_picks, top_k,
                       n_experts, cap, k, n, sx, swe, swk, sh, st);
  if (bm == Many::BM)
    return launch<Many>(x, wg, wu, h, row_slot, block_expert, n_picks, top_k,
                        n_experts, cap, k, n, sx, swe, swk, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
