// G1's many-row instance for Hopper (sm_90a): the expert layer's grouped
// GEMMs over a prefill chunk (thousands of rows an expert) on TMA and
// wgmma. Shared by moe_gemm_up.cu (moe_gemm_up_tc_kernel: gate and up,
// silu(gate) * up out) and moe_gemm_down.cu (moe_gemm_down_tc_kernel:
// down, each row scaled by its routing weight); the few-row instance of a
// decode step is moe_gemm.cuh's. The plain version is
// ops/moe.py:grouped_swiglu_reference.
//
// Bound on H100: operations. A 65,536-token chunk of Moonlight (6 picks
// a token, 64 experts of 2048 -> 1408) is 4.54 TFLOP of gate and up and
// 2.27 of down: 4.59 + 2.29 ms at 989 TFLOP/s, against ~1 ms of bytes.
//
// Design (PERF.md has what each choice measured):
//   - Output tiles of 128 padded rows (kBM, one expert's) by 256 columns
//     (kBN): up takes 128 gate columns and the matching 128 up columns,
//     down 256 output columns. K runs in 64-deep steps through a ring of 4
//     stages of 48 KB (A 16 KB, B 32 KB), 128-byte swizzled, each with a
//     full and an empty mbarrier.
//   - Warp specialisation: warpgroups 0 and 1 consume, each running
//     wgmma m64n256k16 on its 64 rows of the tile (A K-major; B MN-major
//     with the transpose bit, as the weights are stored (K, N) with N
//     contiguous), the f32 sums in 128 registers a thread; warpgroup 2
//     produces. setmaxnreg moves registers from the producer (56) to the
//     consumers (224); 3 x 168 at entry, one block of 384 threads an SM.
//   - B by TMA: 3-D tensor maps over (N, K, expert), boxes of 64 x 64.
//   - A: down's is h, dense in padded order: one TMA box of 64 x 128.
//     Up's is gathered (padded row r is token row_slot[r] / top_k, and
//     Hopper's TMA has no row gather): the producer warpgroup's 128 threads
//     copy it by cp.async, 16 bytes each, into the swizzled layout that
//     wgmma reads, eight threads to a 128-byte row so that a warp reads
//     four whole rows; cp.async.mbarrier.arrive.noinc counts each thread's
//     copies on the stage's full barrier beside the TMA's bytes, and the
//     consumers fence the generic proxy's writes before wgmma reads them.
//     A padding row reads zeros.
//   - A persistent grid: one block an SM walks the tiles blockIdx.x,
//     + gridDim.x, ...: row block t / n_cols, column block t % n_cols. The
//     row blocks are laid out by expert, so the ~132 tiles in flight share
//     one or two experts' weights (gate and up 11.5 MB, down 5.8 MB at
//     Moonlight's widths) and a dozen row blocks in the 50 MB L2. A block
//     past the last expert's rows (block_expert == n_experts) is skipped.
//   - Epilogue from the accumulators: up makes silu(g) * u (a thread holds
//     gate column c and up column c together), down the row's f32 routing
//     weight times its sum, each rounded once to bf16, written to 64 x 64
//     staging subtiles in shared memory (two a warpgroup, in turn) and
//     stored by TMA while the warpgroup goes on to the next tile.
//   - No split-K and no atomics: each output's sum runs in one fixed
//     order (64-deep steps of four 16-deep wgmma), so two calls give the
//     same bits.
//
// Contract (checked by the wrapper, ops/moe.py, and again by the C
// entries): bf16, rows 16-byte aligned and 16 bytes apart; cap a multiple
// of 128; up: K (the model width) a multiple of 64, N (the expert width) of
// 128; down: K (the expert width) a multiple of 64, N of 256.

#pragma once

#include "hopper_tc.cuh"
#include "moe_gemm.cuh"

namespace moe_tc {

using hopper_tc::smem_u32;

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;  // warpgroups, 64 rows of the tile each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kABytes = kBM * kBK * 2;  // two 64-row chunks
constexpr int kBBytes = kBK * kBN * 2;  // four 64-column chunks
constexpr int kStageBytes = kABytes + kBBytes;
// The epilogue's staging: two 64 x 64 subtiles a consumer warpgroup.
constexpr int kSubBytes = 64 * 64 * 2;
constexpr int kEpiBytes = kConsumers * 2 * kSubBytes;
constexpr int kSmem =
    kStages * kStageBytes + kEpiBytes + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "shared memory of one block");
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kProducerRegs + kConsumers * kConsumerRegs == 3 * 168,
              "setmaxnreg moves registers, it does not make them");

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival on `bar` once every cp.async this thread started has
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A 64 x 64 box of shared memory (128-byte swizzled) into a 3-D tensor
// at (c0, c1, c2), as one bulk group of this thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Until at most one of this thread's bulk stores still reads shared memory.
__device__ __forceinline__ void store_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup wg (named barrier wg + 1).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// D (64 x 256, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 256,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The ring of stages in dynamic shared memory (aligned to the 1024-byte
// swizzle atom) and its barriers.
struct Ring {
  uint8_t* base;
  uint8_t* epi;
  uint64_t* full;
  uint64_t* empty;
  __device__ uint8_t* a(int s) const { return base + s * kStageBytes; }
  __device__ uint8_t* b(int s) const {
    return base + s * kStageBytes + kABytes;
  }
};

// Lays the ring out and initialises its barriers: a full barrier waits
// for `full_arrivals` arrivals and its bytes, an empty one for each
// consumer warpgroup. Every thread of the block calls it.
__device__ __forceinline__ Ring setup(uint8_t* raw, int full_arrivals) {
  Ring r;
  r.base = hopper_tc::align_1024(raw);
  r.epi = r.base + kStages * kStageBytes;
  r.full = reinterpret_cast<uint64_t*>(r.epi + kEpiBytes);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper_tc::mbar_init(&r.full[s], full_arrivals);
      hopper_tc::mbar_init(&r.empty[s], kConsumers);
    }
    hopper_tc::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// Advances t (by gridDim.x) to this block's next tile that holds rows:
// its row block rb and expert e. False past the last tile.
__device__ __forceinline__ bool next_tile(int& t, int tiles, int n_cols,
                                          const int* block_expert,
                                          int n_experts, int& rb, int& e) {
  for (; t < tiles; t += gridDim.x) {
    rb = t / n_cols;
    e = block_expert[rb];
    if (e < n_experts) return true;
  }
  return false;
}

// Producer side: before filling step `it`'s stage, wait until the
// consumers have released what it held kStages steps ago.
__device__ __forceinline__ void wait_free(const Ring& r, int it) {
  if (it >= kStages)
    hopper_tc::mbar_wait(&r.empty[it % kStages], ((it / kStages) - 1) & 1);
}

// Consumer side: one tile's sums over `ktiles` steps into acc, this
// warpgroup's 64 rows (hopper_tc.cuh, Fragments). One wgmma group stays
// in flight, so a stage is released (one arrival of the warpgroup) while
// the next one's products run.
template <bool kGathered>
__device__ __forceinline__ void consume(float (&acc)[128], const Ring& r,
                                        int wg, int tw, int ktiles,
                                        int& it) {
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % kStages;
    hopper_tc::mbar_wait(&r.full[s], (it / kStages) & 1);
    if (kGathered) fence_proxy_async();
    const uint32_t a = smem_u32(r.a(s)) + wg * (kABytes / 2);
    const uint32_t b = smem_u32(r.b(s));
    hopper_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_n256(acc, hopper_tc::desc_kmajor(a, kk),
                 hopper_tc::desc_mnmajor(b, kk), kt > 0 || kk > 0);
    hopper_tc::wgmma_commit();
    wgmma_wait_one();
    if (kt > 0 && tw == 0)
      hopper_tc::mbar_arrive(&r.empty[(it - 1) % kStages]);
  }
  hopper_tc::wgmma_wait_all();
  hopper_tc::fence_regs(acc);
  if (tw == 0) hopper_tc::mbar_arrive(&r.empty[(it - 1) % kStages]);
}

// Consumer side: columns [64 sub, 64 sub + 64) of this warpgroup's 64
// rows of the tile, value(j, half) the bf16 pair of 8-column group j
// (hopper_tc.cuh, Fragments), into the output's map at (c0, c1): written
// to a staging subtile in shared memory, then stored by TMA while the
// warpgroup goes on. The two subtiles alternate; `stores` counts this
// warpgroup's.
template <class Value>
__device__ __forceinline__ void store_subtile(const Ring& r, int wg, int tw,
                                              int sub, int& stores,
                                              const CUtensorMap* map, int c0,
                                              int c1, Value value) {
  uint8_t* buf = r.epi + (2 * wg + (stores & 1)) * kSubBytes;
  if (tw == 0) store_wait_read_one();
  warpgroup_sync(wg);
  const int row = (tw / 32) * 16 + (tw % 32) / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const __nv_bfloat162 v = value(8 * sub + jj, half);
      *reinterpret_cast<__nv_bfloat162*>(
          buf + (row + 8 * half) * 128 + ((jj ^ (row & 7)) << 4) +
          (tw % 4) * 4) = v;
    }
  fence_proxy_async();
  warpgroup_sync(wg);
  if (tw == 0) tma_store_3d(map, buf, c0, c1, 0);
  ++stores;
}

// ----------------------------------------------------------- host side

// Tensor map of a bf16 array (d2, d1, d0), d0 contiguous, strides s1 and
// s2 in elements, read in 128-byte-swizzled boxes of box1 rows x 64
// columns.
inline bool encode(CUtensorMap* map, const void* base, long long d0,
                   long long d1, long long d2, long long s1, long long s2,
                   int box1) {
  hopper_tc::EncodeTiledFn fn = hopper_tc::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2};
  const cuuint32_t box[3] = {hopper_tc::kChunkCols,
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches `kernel` on a persistent grid: one block an SM, no more than
// the tiles.
template <class Kernel, class... Args>
int launch_persistent(Kernel* kernel, int tiles, cudaStream_t st,
                      Args... args) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe_tc
