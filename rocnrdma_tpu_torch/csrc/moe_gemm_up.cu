// The expert layer's gate and up GEMM (grouped over the experts) for
// Hopper (sm_90a): for each padded row r of expert e = block_expert[r /
// BM] whose pick is row_slot[r] (token row_slot[r] / top_k),
//   h[r, n] = silu(x[tok] . w_gate[e][:, n]) * (x[tok] . w_up[e][:, n]),
// f32 sums, rounded once to bf16; a padding row (row_slot[r] >= n_picks)
// reads zeros and writes zeros. Two instances: few rows a block
// (moe_gemm_up_kernel<Few>, moe_gemm.cuh's mma.sync design) and many
// (moe_gemm_up_tc_kernel, moe_gemm_tc.cuh's TMA and wgmma design, x's rows
// gathered by the producer). The plain version is
// ops/moe.py:grouped_swiglu_reference.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// strides are int64 elements (x's rows; an expert's and a row's of
// w_gate and w_up, which share them; h's rows); bm picks the instance (16
// or 128 rows a block, ops/moe.py:block_rows); returns
// cudaGetLastError().

#include "moe_gemm.cuh"
#include "moe_gemm_tc.cuh"

namespace {

using Few = moe::Tile<16, 64, 64, 16, 16, 4, 2>;

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

// The many-row instance (moe_gemm_tc.cuh): tiles of 128 rows by 128 gate
// and the matching 128 up columns. tg and tu map w_gate and w_up as (N, K,
// expert), th h as (N, cap, 1).
__global__ void __launch_bounds__(moe_tc::kThreads, 1)
moe_gemm_up_tc_kernel(const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tu,
                      const __grid_constant__ CUtensorMap th,
                      const __nv_bfloat16* __restrict__ x,
                      const int* __restrict__ row_slot,
                      const int* __restrict__ block_expert, int n_picks,
                      int top_k, int n_experts, int k, int n_cols, int tiles,
                      long long sx) {
  using namespace moe_tc;
  extern __shared__ uint8_t smem_raw[];
  // A stage is full once the weights' bytes have landed, with the
  // arrival of the thread that expects them, and each producer thread's
  // copies of the rows (128 arrivals).
  const Ring r = setup(smem_raw, 128 + 1);
  const int ktiles = k / kBK;
  int it = 0, rb, e;

  if (threadIdx.x >= kConsumers * 128) {
    producer_regs();
    // Thread p copies 16-byte column chunk p % 8 of rows p / 8 + 16 i.
    const int p = threadIdx.x - kConsumers * 128;
    const int c = p % 8;
    for (int t = blockIdx.x;
         next_tile(t, tiles, n_cols, block_expert, n_experts, rb, e);
         t += gridDim.x) {
      int tok[kBM / 16];  // -1: a padding row
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i) {
        const int slot = row_slot[static_cast<long long>(rb) * kBM + p / 8 +
                                  16 * i];
        tok[i] = slot < n_picks ? slot / top_k : -1;
      }
      const int n0 = (t % n_cols) * (kBN / 2);
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kStages;
        wait_free(r, it);
        if (p == 0) {
          hopper_tc::mbar_arrive_expect_tx(&r.full[s], kBBytes);
          uint8_t* b = r.b(s);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hopper_tc::tma_load_3d(b + q * hopper_tc::kChunkBytes,
                                   q < 2 ? &tg : &tu, &r.full[s],
                                   n0 + (q % 2) * hopper_tc::kChunkCols,
                                   kt * kBK, e);
        }
        uint8_t* a = r.a(s);
#pragma unroll
        for (int i = 0; i < kBM / 16; ++i) {
          const int row = p / 8 + 16 * i;
          const bool valid = tok[i] >= 0;
          moe::copy16(a + row * 128 + ((c ^ (row & 7)) << 4),
                      valid ? x + tok[i] * sx + kt * kBK + c * 8 : x, valid);
        }
        cp_async_arrive(&r.full[s]);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  float acc[128];
  int stores = 0;
  for (int t = blockIdx.x;
       next_tile(t, tiles, n_cols, block_expert, n_experts, rb, e);
       t += gridDim.x) {
    consume<true>(acc, r, wg, tw, ktiles, it);
    // Gate column group j's pair and its up column group's, j + 16.
    const auto swiglu = [&](int j, int half) {
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float gv = acc[4 * j + 2 * half + i];
        const float uv = acc[4 * (j + kBN / 16) + 2 * half + i];
        v[i] = gv / (1.f + expf(-gv)) * uv;
      }
      return __floats2bfloat162_rn(v[0], v[1]);
    };
#pragma unroll
    for (int sub = 0; sub < kBN / 128; ++sub)
      store_subtile(r, wg, tw, sub, stores, &th,
                    (t % n_cols) * (kBN / 2) + 64 * sub, rb * kBM + wg * 64,
                    swiglu);
  }
  if (tw == 0) store_wait_all();
}

int launch_many(const void* x, const void* wg, const void* wu, void* h,
                const void* row_slot, const void* block_expert, int n_picks,
                int top_k, int n_experts, int cap, int k, int n, long long sx,
                long long swe, long long swk, long long sh,
                cudaStream_t st) {
  using namespace moe_tc;
  if (cap % kBM || k % kBK || k < kBK || n % (kBN / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tg, tu, th;
  if (!encode(&tg, wg, n, k, n_experts, swk, swe, kBK) ||
      !encode(&tu, wu, n, k, n_experts, swk, swe, kBK) ||
      !encode(&th, h, n, cap, 1, sh, sh * cap, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_cols = n / (kBN / 2), tiles = cap / kBM * n_cols;
  return launch_persistent(
      moe_gemm_up_tc_kernel, tiles, st, tg, tu, th,
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(row_slot),
      static_cast<const int*>(block_expert), n_picks, top_k, n_experts, k,
      n_cols, tiles, sx);
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
  if (bm == moe_tc::kBM)
    return launch_many(x, wg, wu, h, row_slot, block_expert, n_picks, top_k,
                       n_experts, cap, k, n, sx, swe, swk, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
