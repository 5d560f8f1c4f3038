// Latent-attention decode for Hopper (sm_90a): the absorbed attention of
// a decode step over the bf16 latent cache, one query position a sequence.
//
// Replaces no Pallas kernel: the JAX package has no latent attention. It
// computes, for each sequence b and each of its 16 or 32 query heads h,
//   score_t = (q[b, h] . ckv[b, t]) / sqrt(nope + rope)   for t <= pos,
//   o[b, h] = softmax_t(score) . ckv[b, t, :512]
// where q is [q_lat | q_pe] (q_lat = W_UK . q_nope, the query absorbed
// into the latent) and a cache row is [c | k_pe]: 512 latent columns that
// are also the value, then 64 roped key columns that every head shares.
// The plain version is ops/mla_decode.py:mla_decode_reference.
//
// Contract: q (B, H, 576) and ckv (B, T, 576) bf16, H 16 or 32, read
// through their strides (the last one 1, the others multiples of 8
// elements, the bases 16-byte aligned); q_pos (1,) int64, the query's
// position, read on the device; out (B, H, 512) contiguous bf16. Key t
// weighs iff t <= pos.
//
// Bound on H100: bytes. A live position costs 16 * 2 * (576 + 512) flops
// against its 1,152-byte row: 30 flops a byte, under the bf16 tensor
// cores' ridge (~295) but over the f32 CUDA cores' (~20), so the products
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums) and the
// cache is the floor: B * (pos + 1) * 1152 bytes / 3.35 TB/s (0.089 ms at
// B 64, pos 4033).
//
// Design against that bound (FlashMLA's split, on mma.sync):
//   - Grid (B * H / 16, splits): a block holds 16 heads of one sequence,
//     the 16 rows of one mma tile, so it reads each cache row once for all
//     of them. At 32 heads a sequence's two head groups are neighbouring
//     blocks (x = 2b, 2b + 1), which run together and read the same rows,
//     so the second reads them from the L2 and HBM gives each live row
//     about once a sequence. Splits cut the keys into equal ranges so that
//     a small B still fills the card (ops/mla_decode.py:
//     mla_decode_splits), each block stopping at pos + 1: one captured
//     graph (T the whole cache) reads only the prefix in use at each
//     replay.
//   - Tiles of 32 keys travel by cp.async into two stages of shared
//     memory (rows padded by 16 bytes, so ldmatrix reads them without
//     bank conflicts), the next tile's copies running during this one's
//     products. 4 warps; q stays in shared memory.
//   - Scores: warp w takes keys 8w..8w+7 of the tile, 36 mma steps over
//     the 576 columns. Online softmax in f32, in log2 units (exp2f), one
//     row (head) per 8 threads; p is rounded to bf16 for the value product
//     (as K6 does), l sums the unrounded p.
//   - Values: warp w owns output columns 128w..128w+127 (16 mma tiles of
//     8, f32 accumulators in registers), rescaled by each tile's
//     correction before P . V; V is the tile's first 512 columns, read by
//     ldmatrix.trans from the same stage as the keys.
//   - With one split the block writes out = o / l; otherwise (m, l, o) to
//     f32 scratch, and mla_decode_combine merges the splits in split
//     order. Every sum runs in a fixed order: two calls give the same
//     bits.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// strides are int64 elements; part_o (B * H, splits, 512) and part_ml
// (B * H, splits, 2) are f32 scratch that the wrapper allocates (unused
// with one split); mla_decode returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeads = 16;               // query heads a block: an mma tile's rows
constexpr int kLat = 512;                // latent (and value) columns
constexpr int kRow = 576;                // a cache row: latent + rope
constexpr int kPad = kRow + 8;           // shared row stride (elements)
constexpr int kKeys = 32;                // keys a tile
constexpr int kPPad = kKeys + 8;         // probabilities' row stride
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = (kLat / kWarps) / 8;   // value mma tiles a warp
constexpr int kChunks = kRow / 8;             // 16-byte chunks a row
// Blocks an SM holds at once (shared memory: ~95 KB a block);
// ops/mla_decode.py:BLOCKS_PER_SM sizes the splits by it.
constexpr int kMinBlocks = 2;

constexpr int kSmemQ = kHeads * kPad * 2;
constexpr int kSmemKV = 2 * kKeys * kPad * 2;
constexpr int kSmemS = kHeads * (kKeys + 1) * 4;
constexpr int kSmemP = kHeads * kPPad * 2;
constexpr int kSmem = kSmemQ + kSmemKV + kSmemS + kSmemP + 3 * kHeads * 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory (cp.async, L2 only); with `valid`
// false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void mla_copy(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
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

// Copies of the cache rows base..base+31 (zeros from k1 on) into one
// stage, as one cp.async group.
__device__ __forceinline__ void mla_fetch(__nv_bfloat16* dst,
                                          const __nv_bfloat16* cb,
                                          long long cst, int base, int k1,
                                          int tid) {
  for (int i = tid; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, j = base + r;
    const bool ok = j < k1;
    mla_copy(dst + r * kPad + c * 8, ok ? cb + j * cst + c * 8 : cb, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
mla_decode_split(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ ckv,
                 const int64_t* __restrict__ q_pos,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                 float* __restrict__ part_ml, int t, int kps, int groups,
                 long long qsb, long long qsh, long long csb, long long cst,
                 float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem + kSmemQ);
  float* ss = reinterpret_cast<float*>(smem + kSmemQ + kSmemKV);
  __nv_bfloat16* sp =
      reinterpret_cast<__nv_bfloat16*>(smem + kSmemQ + kSmemKV + kSmemS);
  float* salpha = reinterpret_cast<float*>(smem + kSmemQ + kSmemKV + kSmemS +
                                           kSmemP);
  float* sm = salpha + kHeads;
  float* sl = sm + kHeads;
  const float ninf = -INFINITY;

  const int b = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const long long pos = q_pos[0];
  const int live = static_cast<int>(pos + 1 < t ? pos + 1 : t);
  const int k0 = split * kps;
  const int k1 = k0 + kps < live ? k0 + kps : live;

  const __nv_bfloat16* qb = q + b * qsb + grp * kHeads * qsh;
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    mla_copy(sq + r * kPad + c * 8, qb + r * qsh + c * 8, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const __nv_bfloat16* cb = ckv + b * csb;
  // Softmax state of row tid / 8, held by its 8 threads alike.
  const int srow = tid / 8, sj = (tid % 8) * 4;
  float m_run = ninf, l_run = 0.f;
  float acc[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (k0 < k1) mla_fetch(skv, cb, cst, k0, k1, tid);
  int buf = 0;
  for (int base = k0; base < k1; base += kKeys, buf ^= 1) {
    if (base + kKeys < k1) {
      mla_fetch(skv + (buf ^ 1) * kKeys * kPad, cb, cst, base + kKeys, k1,
                tid);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* kt = skv + buf * kKeys * kPad;

    // Scores of keys 8w..8w+7 for the 16 heads.
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = 0; kk < kRow; kk += 16) {
      uint32_t a[4], bk[2];
      ldsm_x4(a, sq + (lane % 16) * kPad + kk + (lane / 16) * 8);
      ldsm_x2(bk, kt + (warp * 8 + lane % 8) * kPad + kk + ((lane / 8) % 2) * 8);
      mma(sc, a, bk[0], bk[1]);
    }
    const int key = warp * 8 + 2 * tq;
    ss[g * (kKeys + 1) + key] = sc[0];
    ss[g * (kKeys + 1) + key + 1] = sc[1];
    ss[(g + 8) * (kKeys + 1) + key] = sc[2];
    ss[(g + 8) * (kKeys + 1) + key + 1] = sc[3];
    __syncthreads();

    // Online softmax of row srow over its 4 keys a thread, 8 threads a row.
    {
      float v[4], mx = ninf;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = base + sj + u < k1 ? ss[srow * (kKeys + 1) + sj + u] * scale2
                                  : ninf;
        mx = fmaxf(mx, v[u]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = v[u] == ninf ? 0.f : exp2f(v[u] - m_new);
        psum += p;
        sp[srow * kPPad + sj + u] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      if (tid % 8 == 0) salpha[srow] = alpha;
    }
    __syncthreads();

    // o = o * alpha + P . V over this warp's 128 columns.
    const float a0 = salpha[g], a1 = salpha[g + 8];
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      uint32_t pa[4];
      ldsm_x4(pa, sp + (lane % 16) * kPPad + kk + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kTiles; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, kt + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kPad +
                          warp * (kLat / kWarps) + n * 8 + (lane / 16) * 8);
        mma(acc[n], pa, vb[0], vb[1]);
        mma(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid % 8 == 0) {
    sm[srow] = m_run;
    sl[srow] = l_run;
  }
  __syncthreads();

  const long long row0 = static_cast<long long>(blockIdx.x) * kHeads;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int h = g + 8 * half;
    const long long row = row0 + h;
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      const int col = warp * (kLat / kWarps) + n * 8 + 2 * tq;
      const float o0 = acc[n][2 * half], o1 = acc[n][2 * half + 1];
      if (nsplit == 1) {
        const float inv = 1.f / sl[h];
        *reinterpret_cast<__nv_bfloat162*>(out + row * kLat + col) =
            __floats2bfloat162_rn(o0 * inv, o1 * inv);
      } else {
        const long long at = row * nsplit + split;
        *reinterpret_cast<float2*>(part_o + at * kLat + col) =
            make_float2(o0, o1);
      }
    }
  }
  if (nsplit > 1 && tid < kHeads) {
    const long long at = (row0 + tid) * nsplit + split;
    part_ml[2 * at] = sm[tid];
    part_ml[2 * at + 1] = sl[tid];
  }
}

// One block per (sequence, head), 4 columns a thread: the splits'
// partials merged in split order.
__global__ void mla_decode_combine(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   __nv_bfloat16* __restrict__ out,
                                   int nsplit) {
  const float ninf = -INFINITY;
  const long long row = blockIdx.x;
  const float* ml = part_ml + 2 * row * nsplit;
  float mx = ninf;
  for (int z = 0; z < nsplit; ++z) mx = fmaxf(mx, ml[2 * z]);
  for (int d = threadIdx.x; d < kLat; d += blockDim.x) {
    float lsum = 0.f, osum = 0.f;
    for (int z = 0; z < nsplit; ++z) {
      const float mz = ml[2 * z];
      if (mz > ninf) {
        const float w = exp2f(mz - mx);
        lsum = fmaf(w, ml[2 * z + 1], lsum);
        osum = fmaf(w, part_o[(row * nsplit + z) * kLat + d], osum);
      }
    }
    out[row * kLat + d] = __float2bfloat16_rn(osum / lsum);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int mla_decode(const void* q, const void* ckv, const void* q_pos,
                          void* out, void* part_o, void* part_ml, int b,
                          int heads, int t, int splits, long long qsb,
                          long long qsh,
                          long long csb, long long cst, float scale2,
                          void* stream) {
  const int groups = heads / kHeads;
  bool ok = b > 0 && (heads == kHeads || heads == 2 * kHeads) && t > 0 &&
            splits > 0 && splits <= 65535 && aligned(q) &&
            aligned(ckv) && aligned(out) &&
            (splits == 1 || (part_o != nullptr && part_ml != nullptr));
  const long long strides[4] = {qsb, qsh, csb, cst};
  for (long long st : strides) ok = ok && st % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_split, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int kps = (t + splits - 1) / splits;
  kps = (kps + kKeys - 1) / kKeys * kKeys;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_decode_split<<<dim3(b * groups, splits), kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const int64_t*>(q_pos), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), t, kps,
      groups, qsb, qsh, csb, cst, scale2);
  if (splits > 1) {
    mla_decode_combine<<<b * heads, 128, 0, st>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
        static_cast<__nv_bfloat16*>(out), splits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
