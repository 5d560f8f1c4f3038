// The expert layer's down GEMM (grouped over the experts) for Hopper
// (sm_90a): for each padded row r of expert e = block_expert[r / BM],
//   out[r, n] = row_w[r] * (h[r] . w_down[e][:, n]),
// f32 sums, scaled in f32 by the pick's routing weight (0 for a padding
// row) and rounded once to bf16. Two instances: few rows a block
// (moe_gemm_down_kernel<Few>, moe_gemm.cuh's mma.sync design) and many
// (moe_gemm_down_tc_kernel, moe_gemm_tc.cuh's TMA and wgmma design). The
// plain version is ops/moe.py:grouped_swiglu_reference.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// strides are int64 elements (h's rows; an expert's and a row's of
// w_down; out's rows); bm picks the instance (16 or 128 rows a block,
// ops/moe.py:block_rows); returns cudaGetLastError().

#include "moe_gemm.cuh"
#include "moe_gemm_tc.cuh"

namespace {

using Few = moe::Tile<16, 64, 64, 16, 16, 4, 1>;

template <class T>
__global__ void __launch_bounds__(T::kThreads, 2)
moe_gemm_down_kernel(const __nv_bfloat16* __restrict__ h,
                     const __nv_bfloat16* __restrict__ wd,
                     __nv_bfloat16* __restrict__ out,
                     const float* __restrict__ row_w,
                     const int* __restrict__ block_expert, int n_experts,
                     int k, long long sh, long long swe, long long swk,
                     long long so) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* a_off = reinterpret_cast<long long*>(smem);
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(smem + T::BM * 8);
  const int e = block_expert[blockIdx.x];
  if (e >= n_experts) return;
  const long long row0 = static_cast<long long>(blockIdx.x) * T::BM;
  const int n0 = blockIdx.y * T::BN;
  for (int r = threadIdx.x; r < T::BM; r += T::kThreads)
    a_off[r] = (row0 + r) * sh;
  __syncthreads();
  const __nv_bfloat16* b[1] = {wd + e * swe};
  float acc[1][T::MT][T::NT][4];
  moe::mainloop<T>(acc, stages, h, a_off, b, swk, k, n0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm0 = (warp / T::kWarpsN) * T::WM;
  const int wn0 = (warp % T::kWarpsN) * T::WN;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + wm0 + mt * 16 + g + 8 * half;
      const float w = row_w[r];
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(out + r * so + col) =
            __floats2bfloat162_rn(acc[0][mt][nt][2 * half] * w,
                                  acc[0][mt][nt][2 * half + 1] * w);
      }
    }
}

template <class T>
int launch(const void* h, const void* wd, void* out, const void* row_w,
           const void* block_expert, int n_experts, int cap, int k, int n,
           long long sh, long long swe, long long swk, long long so,
           cudaStream_t st) {
  if (cap % T::BM || k % T::BK || n % T::BN)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_down_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  moe_gemm_down_kernel<T><<<dim3(cap / T::BM, n / T::BN), T::kThreads,
                            T::kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wd),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(row_w),
      static_cast<const int*>(block_expert), n_experts, k, sh, swe, swk, so);
  return static_cast<int>(cudaGetLastError());
}

// The many-row instance (moe_gemm_tc.cuh): tiles of 128 rows by 256
// columns. th maps h as (K, cap, 1), twd w_down as (N, K, expert), tout
// out as (N, cap, 1).
__global__ void __launch_bounds__(moe_tc::kThreads, 1)
moe_gemm_down_tc_kernel(const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap twd,
                        const __grid_constant__ CUtensorMap tout,
                        const float* __restrict__ row_w,
                        const int* __restrict__ block_expert, int n_experts,
                        int k, int n_cols, int tiles) {
  using namespace moe_tc;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = setup(smem_raw, 1);  // one thread expects every byte
  const int ktiles = k / kBK;
  int it = 0, rb, e;

  if (threadIdx.x >= kConsumers * 128) {
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    for (int t = blockIdx.x;
         next_tile(t, tiles, n_cols, block_expert, n_experts, rb, e);
         t += gridDim.x) {
      const int n0 = (t % n_cols) * kBN;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kStages;
        wait_free(r, it);
        hopper_tc::mbar_arrive_expect_tx(&r.full[s], kStageBytes);
        hopper_tc::tma_load_3d(r.a(s), &th, &r.full[s], kt * kBK, rb * kBM,
                               0);
        uint8_t* b = r.b(s);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hopper_tc::tma_load_3d(b + q * hopper_tc::kChunkBytes, &twd,
                                 &r.full[s], n0 + q * hopper_tc::kChunkCols,
                                 kt * kBK, e);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  // This thread's rows of the tile: rloc and rloc + 8.
  const int rloc = wg * 64 + (tw / 32) * 16 + (tw % 32) / 4;
  float acc[128];
  int stores = 0;
  for (int t = blockIdx.x;
       next_tile(t, tiles, n_cols, block_expert, n_experts, rb, e);
       t += gridDim.x) {
    consume<false>(acc, r, wg, tw, ktiles, it);
    const long long row = static_cast<long long>(rb) * kBM + rloc;
    const float w[2] = {row_w[row], row_w[row + 8]};
    const auto scaled = [&](int j, int half) {
      return __floats2bfloat162_rn(acc[4 * j + 2 * half] * w[half],
                                   acc[4 * j + 2 * half + 1] * w[half]);
    };
#pragma unroll
    for (int sub = 0; sub < kBN / 64; ++sub)
      store_subtile(r, wg, tw, sub, stores, &tout,
                    (t % n_cols) * kBN + 64 * sub, rb * kBM + wg * 64,
                    scaled);
  }
  if (tw == 0) store_wait_all();
}

int launch_many(const void* h, const void* wd, void* out, const void* row_w,
                const void* block_expert, int n_experts, int cap, int k,
                int n, long long sh, long long swe, long long swk,
                long long so, cudaStream_t st) {
  using namespace moe_tc;
  if (cap % kBM || k % kBK || k < kBK || n % kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap th, twd, tout;
  if (!encode(&th, h, k, cap, 1, sh, sh * cap, kBM) ||
      !encode(&twd, wd, n, k, n_experts, swk, swe, kBK) ||
      !encode(&tout, out, n, cap, 1, so, so * cap, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_cols = n / kBN, tiles = cap / kBM * n_cols;
  return launch_persistent(
      moe_gemm_down_tc_kernel, tiles, st, th, twd, tout,
      static_cast<const float*>(row_w),
      static_cast<const int*>(block_expert), n_experts, k, n_cols, tiles);
}

}  // namespace

extern "C" int moe_gemm_down(const void* h, const void* wd, void* out,
                             const void* row_w, const void* block_expert,
                             int n_experts, int cap, int k, int n, int bm,
                             long long sh, long long swe, long long swk,
                             long long so, void* stream) {
  bool ok = cap > 0 && n_experts > 0 && moe::aligned16(h) &&
            moe::aligned16(wd) && moe::aligned16(out);
  const long long strides[4] = {sh, swe, swk, so};
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == Few::BM)
    return launch<Few>(h, wd, out, row_w, block_expert, n_experts, cap, k, n,
                       sh, swe, swk, so, st);
  if (bm == moe_tc::kBM)
    return launch_many(h, wd, out, row_w, block_expert, n_experts, cap, k, n,
                       sh, swe, swk, so, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
