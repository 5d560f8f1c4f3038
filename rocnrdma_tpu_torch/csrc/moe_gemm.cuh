// The expert layer's grouped GEMM for Hopper (sm_90a), its few-row
// instance, shared by moe_gemm_up.cu (gate and up, silu(gate) * up out)
// and moe_gemm_down.cu (down, each row scaled by its routing weight); the
// many-row instance of a prefill chunk is moe_gemm_tc.cuh's.
//
// Replaces no Pallas kernel: the JAX package has no experts. The rows are
// the picks laid out by expert (ops/moe.py:align): each expert's rows
// padded to a multiple of the block's BM rows, so that one block of rows
// belongs to one expert (block_expert, n_experts for a block past the
// last expert's rows, which returns at once). The plain version is
// ops/moe.py:grouped_swiglu_reference.
//
// Bound on H100: in a decode step (64 tokens, 6 picks, ~6 rows an expert)
// bytes, every expert's weights read once. The few-row instance (BM 16):
// one block of rows an expert, 4 warps side by side along the columns,
// 64-deep tiles, 4 stages, so each expert's weights stream through shared
// memory once, with ~3 tiles in flight a block.
// Tiles travel by cp.async into shared rows padded by 16 bytes (ldmatrix
// reads them without bank conflicts); the products are mma.sync m16n8k16
// (bf16 in, f32 sums), A by ldmatrix, B (stored K-major rows, N
// contiguous) by ldmatrix.trans. Each output element's sum runs in one
// fixed order: two calls give the same bits.
//
// Contract (checked by the wrapper, ops/moe.py): bf16 operands, unit
// stride along the last dimension, row strides multiples of 8 elements,
// bases 16-byte aligned; K a multiple of 64 and N of 64, so no tile has a
// tail.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace moe {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory (cp.async, L2 only); with `valid`
// false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// A block's shape: BM x BN outputs (of each of NB weight matrices), BK
// deep tiles, warps of WM x WN outputs, STAGES tiles in flight.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_, int NB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, NB = NB_;
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles a warp
  static constexpr int LDA = BK + 8, LDB = BN + 8;  // padded rows
  static constexpr int kA = BM * LDA, kB = BK * LDB;  // elements a stage
  static constexpr int kStage = kA + NB * kB;
  // Shared bytes: each row's source offset, then the stages.
  static constexpr int kSmem = BM * 8 + STAGES * kStage * 2;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tiles");
};

// Copies tile `kt` (BK columns of A's rows, BK rows of each B) into one
// stage, as one cp.async group. A row r starts at a + a_off[r] (a_off < 0:
// a padding row, zeros); B matrix j at b[j] + k * ldb.
template <class T>
__device__ __forceinline__ void fetch(__nv_bfloat16* st,
                                      const __nv_bfloat16* a,
                                      const long long* a_off,
                                      const __nv_bfloat16* const* b,
                                      long long ldb, int kt, int n0,
                                      int tid) {
  constexpr int kChA = T::BK / 8, kChB = T::BN / 8;
  const int k0 = kt * T::BK;
  for (int i = tid; i < T::BM * kChA; i += T::kThreads) {
    const int r = i / kChA, c = i % kChA;
    const long long off = a_off[r];
    copy16(st + r * T::LDA + c * 8, off >= 0 ? a + off + k0 + c * 8 : a,
           off >= 0);
  }
#pragma unroll
  for (int j = 0; j < T::NB; ++j) {
    __nv_bfloat16* sb = st + T::kA + j * T::kB;
    for (int i = tid; i < T::BK * kChB; i += T::kThreads) {
      const int r = i / kChB, c = i % kChB;
      copy16(sb + r * T::LDB + c * 8,
             b[j] + (k0 + r) * ldb + n0 + c * 8, true);
    }
  }
  commit();
}

// The block's BM x BN outputs of each B over K, in acc[j][mt][nt][4]: the
// warp's mma tiles, rows wm0 + 16 mt (+ g, g + 8), columns wn0 + 8 nt
// (+ 2 tq, 2 tq + 1), as mma.sync lays them out.
template <class T>
__device__ __forceinline__ void mainloop(
    float (&acc)[T::NB][T::MT][T::NT][4], __nv_bfloat16* stages,
    const __nv_bfloat16* a, const long long* a_off,
    const __nv_bfloat16* const* b, long long ldb, int k, int n0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm0 = (warp / T::kWarpsN) * T::WM;
  const int wn0 = (warp % T::kWarpsN) * T::WN;
#pragma unroll
  for (int j = 0; j < T::NB; ++j)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        acc[j][mt][nt][0] = acc[j][mt][nt][1] = acc[j][mt][nt][2] =
            acc[j][mt][nt][3] = 0.f;

  const int ktiles = k / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles)
      fetch<T>(stages + s * T::kStage, a, a_off, b, ldb, s, n0, tid);
    else
      commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // Tile kt has landed once at most STAGES - 2 younger groups remain.
    wait_pending<T::STAGES - 2>();
    __syncthreads();
    // The stage read in step kt - 1 is free now: fill it with tile
    // kt + STAGES - 1 (an empty group past the last, so the count holds).
    const int next = kt + T::STAGES - 1;
    if (next < ktiles)
      fetch<T>(stages + (next % T::STAGES) * T::kStage, a, a_off, b, ldb,
               next, n0, tid);
    else
      commit();
    const __nv_bfloat16* st = stages + (kt % T::STAGES) * T::kStage;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 16) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldsm_x4(af[mt], st + (wm0 + mt * 16 + lane % 16) * T::LDA + kk +
                            (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < T::NB; ++j) {
        const __nv_bfloat16* sb = st + T::kA + j * T::kB;
#pragma unroll
        for (int nt = 0; nt < T::NT; nt += 2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, sb + (kk + lane % 8 + ((lane / 8) % 2) * 8) * T::LDB +
                            wn0 + nt * 8 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            mma(acc[j][mt][nt], af[mt], bf[0], bf[1]);
            mma(acc[j][mt][nt + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
  wait_pending<0>();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace moe
