// Building blocks of the scalar (CUDA-core, full f32 FMA) routes of the
// attention kernels (flash_fwd.cu, K3; flash_bwd_dkv.cu, K4;
// flash_bwd_dq.cu, K5): 16-byte cp.async copies into shared memory, f32
// reads of four consecutive f32 or bf16 elements, and the block sizing of
// the kernels whose warps own 8 query rows each.
//
// The three kernels share one shape: a warp owns kRows = 8 rows (query
// rows in K3 and K5, key rows in K4) for its whole loop, a block has 1, 2,
// 4 or 8 warps, and the operand the rows are multiplied with streams
// through a 2-stage ring of row tiles in shared memory, filled by
// cp.async while the previous tile is in use. Rows in shared memory are
// padded by 16 bytes, so the float4 reads of 8 consecutive rows hit
// distinct banks. Every sum of a row runs in one fixed order whatever
// block it lands in, so a row's result does not depend on the grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <numeric>

namespace scalar_route {

constexpr int kRows = 8;       // rows per warp
constexpr int kMaxWarps = 8;   // warps per block at most
constexpr int kStages = 2;     // ring depth

// One 16-byte copy into shared memory; with `valid` false the 16 bytes
// are zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// The same for one 4-byte word (a row's lse or delta, which need not lie
// on a 16-byte boundary).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four consecutive elements of shared memory as f32 (bf16 widens exactly).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b,
                                    float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows r0 .. r0 + rows - 1 of two row-major (S, HD) arrays into two
// shared tiles of row stride ld, by the whole block; rows at or past S
// arrive as zeros.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows2(T* d0, T* d1, const T* s0,
                                           const T* s1, int r0, int rows,
                                           int S, int ld) {
  constexpr int kEl = 16 / sizeof(T);
  constexpr int kChunks = HD / kEl;  // a power of two
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks;
    const int g = r0 + r;
    const size_t src = static_cast<size_t>(g < S ? g : 0) * HD + c * kEl;
    cp_async16(d0 + r * ld + c * kEl, s0 + src, g < S);
    cp_async16(d1 + r * ld + c * kEl, s1 + src, g < S);
  }
}

// The product lane layout of a warp's 8 rows x HD columns (K3's p.v, K4's
// dV and dK, K5's dQ): LR row groups x LD column groups; a lane holds rows
// vr + LR i (i < PR) and columns 4 vc + (HD / NCH) ch (ch < NCH), with
// vr = lane / LD, vc = lane % LD.
template <int HD>
struct RowTile {
  static constexpr int LD = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int NCH = HD / (4 * LD);
  static constexpr int LR = 32 / LD;
  static constexpr int PR = kRows / LR;
};

// The query-row kernels (K3, K5): warps per block, the most (8, 4, 2, 1)
// that still give at least one block per SM; the rows of a block take
// gb = gcd(group, rows) heads of one GQA group (block row r is head
// h0 + r % gb at position p0 + r / gb), so the group reads each K/V tile
// once. grid.y counts position tiles.
struct QueryGrid {
  int warps, gb_log2;
  dim3 grid;
};

inline QueryGrid query_grid(int B, int H, int KVH, int S, int sms) {
  QueryGrid g{};
  for (int nw = kMaxWarps;; nw >>= 1) {
    const int gb = std::gcd(H / KVH, kRows * nw);
    const int npos = kRows * nw / gb;
    const long long tiles = (S + npos - 1) / npos;
    g.warps = nw;
    g.gb_log2 = __builtin_ctz(gb);
    g.grid = dim3(B * H / gb, static_cast<unsigned>(tiles));
    if (nw == 1 || static_cast<long long>(B) * (H / gb) * tiles >= sms)
      return g;
  }
}

// The SMs of the current device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace scalar_route
