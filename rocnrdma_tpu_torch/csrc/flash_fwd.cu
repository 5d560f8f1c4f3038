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
// Bound on H100. A (b, h) pair costs 4*D flops per visible (query, key)
// pair, ~2*D*S^2 causal, against (2 + 2/group)*S*D*elt bytes of q, out
// and its share of k, v: in bf16 at D = 128 that is ~0.4*S flops per byte
// for group 4 and ~0.33*S for group 2. The H100's ridge is ~295 flop/byte
// (989 TFLOP/s bf16 over 3.35 TB/s), so the llama3-8b prefill (S = 512,
// group 4) is bound by bytes, and the llama3-1b training shape (S = 2048,
// group 2) by operations: its flops at the tensor-core peak.
//
// Two instances, chosen by dtype and D alone (hopper_tc::route):
//
// Tensor-core route, bf16 at D = 64 and 128 (flash_fwd_tc_kernel). One
// block per (b, h, 64-query tile): one consumer warpgroup and one
// producer warp, 80 KB of shared memory at D = 128 and 133 registers, so
// two blocks share an SM.
//   - Operations: both products run on the tensor cores as warpgroup
//     wgmma, S = Q K^T (m64n64k16, Q and K from shared memory, K-major as
//     stored) and O += P V (P from registers, V from shared memory
//     MN-major), with f32 accumulators. Softmax works on the S
//     accumulator fragment in registers (softmax_tile): the row max and
//     sum across the 4 lanes that share a row (__shfl_xor_sync), exp2f
//     with scale * log2 e folded in, P rounded to bf16 in the A-register
//     layout. The -inf mask runs only on the diagonal and ragged tail
//     tiles; the loop stops at the causal diagonal (the _last_kv_block
//     rule), and the grid starts with the longest causal q tiles so the
//     tail of the grid is short. Within a block the two products and the
//     softmax follow one another; the two blocks on an SM interleave them.
//   - Bytes: the producer warp loads Q once and K/V tiles of 64 keys by TMA
//     (one 3-D tensor map per operand over (D, S, B*heads), so rows past S
//     arrive as zeros and no tile reads another head) into a 2-stage ring
//     of 128-byte-swizzled tiles with mbarriers, overlapping the next
//     tile's copy with this tile's products. q head h reads kv head
//     h / group in place (the reference's _clamp_kv map); the heads of a
//     group read the same K/V tiles, from L2 after the first. A block
//     that served all heads of a group from one K/V stream (one warpgroup
//     per head) measured 5-9% slower on the H100: its warpgroups wait on
//     the same barriers, so their softmaxes coincide and the tensor cores
//     idle. Out is written once in bf16 from the accumulators, query rows
//     past S never.
//
// Scalar route, f32 at every D and bf16 at D = 16 and 32
// (flash_fwd_kernel): one block of 256 threads per (b, h, tile of 64
// query rows) loops over kv tiles of 32 rows held in f32 shared memory,
// m, l and the accumulator in f32 registers, scalar f32 FMA products
// (full f32, which the f32 card-vs-CPU parity needs; TF32 would not hold
// it).
// The loop stops at the causal diagonal and masks the ragged tail.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; flash_fwd returns cudaGetLastError(),
// flash_fwd_route(D, dtype) the instance flash_fwd launches (1 tensor
// core, 0 scalar, -1 refused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

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


// ------------------------------------------------------ tensor-core route

namespace tc {

using namespace hopper_tc;

constexpr int kBQ = 64;      // query rows per consumer warpgroup
constexpr int kBK = 64;      // keys per kv tile (== kBQ: the causal stop
                             // and the diagonal test assume it)
constexpr int kStages = 2;   // K/V ring depth

template <int HD>
struct Layout {
  static constexpr int kTile = (HD / kChunkCols) * kChunkBytes;  // 64 x HD
  static constexpr int kQ = 0;                       // the Q tile
  static constexpr int kK = kQ + kTile;              // [kStages] K tiles
  static constexpr int kV = kK + kStages * kTile;    // [kStages] V tiles
  static constexpr int kBar = kV + kStages * kTile;  // full, empty, q
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

// Online softmax of one 64 x 64 score tile held in the accumulator
// fragment sc (this thread: rows qi and qi + 8, of every 8 columns the two
// at col0 of key tile k0): scores to log2 units, the running max m and
// this thread's share of the row sum l updated, alpha = exp2(m_old - m)
// for the caller's rescale of O, and p = exp2(s - m) left in sc. Only an
// `edge` tile (the diagonal or the ragged tail) is masked: a masked key is
// -inf, so its p is exactly 0 and a row that sees no key of the tile keeps
// a finite max.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2, int qi, int col0,
                                             int k0, int S, int causal,
                                             bool edge) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float v = sc[i] * sl2;
    if (edge) {
      const int kj = k0 + 8 * (i / 4) + col0 + (i & 1);
      if (!(kj < S && (!causal || kj <= qi + 8 * r))) v = -INFINITY;
    }
    sc[i] = v;
    mx[r] = fmaxf(mx[r], v);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(sc[i] - m[r]);
    rs[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int HD>
__global__ void __launch_bounds__(160, 2)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int H, int KVH, int S, float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KVH);
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kBQ;
  const int nk = (S + kBK - 1) / kBK;
  const int n_kv = causal ? min(nk, qt + 1) : nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer warp: one elected lane issues every copy.
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(qbar, L::kTile);
      for (int c = 0; c < HD / kChunkCols; ++c)
        tma_load_3d(smem + L::kQ + c * kChunkBytes, &tq, qbar,
                    c * kChunkCols, q0, bh);
      const int bkv = b * KVH + kvh;
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        for (int c = 0; c < HD / kChunkCols; ++c) {
          tma_load_3d(smem + L::kK + s * L::kTile + c * kChunkBytes, &tk,
                      &full[s], c * kChunkCols, kt * kBK, bkv);
          tma_load_3d(smem + L::kV + s * L::kTile + c * kChunkBytes, &tv,
                      &full[s], c * kChunkCols, kt * kBK, bkv);
        }
      }
    }
    return;
  }

  // Consumer warpgroup: rows q0 .. q0 + 63 of head bh. This thread owns
  // tile rows row0 and row0 + 8 and, of every 8 columns, the two at col0
  // (hopper_tc.cuh, Fragments).
  const int t = threadIdx.x;
  const int row0 = (t / 32) * 16 + (t % 32) / 4;
  const int col0 = 2 * (t % 4);
  const float sl2 = scale * kLog2e;
  const uint32_t q_tile = smem_u32(smem + L::kQ);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t k_tile = smem_u32(smem + L::kK + s * L::kTile);
    const uint32_t v_tile = smem_u32(smem + L::kV + s * L::kTile);

    float sc[32], alpha[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor(q_tile, kk),
                   desc_kmajor(k_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, sl2, q0 + row0, col0, k0, S, causal,
                 k0 + kBK > S || (causal && k0 + kBK > q0 + 1));
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) a_fragment(sc, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk], desc_mnmajor(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + row0 + 8 * r;
    if (qi >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * S + qi) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / lc,
                                o[4 * j + 2 * r + 1] / lc);
    if ((t & 3) == 0) lse[static_cast<size_t>(bh) * S + qi] = m[r] * kLn2 + logf(lc);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  using L = Layout<HD>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, q, HD, S, B * H) ||
      !encode_rows(&tk, k, HD, S, B * KVH) ||
      !encode_rows(&tv, v, HD, S, B * KVH))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ), block(160);
  flash_fwd_tc_kernel<HD><<<grid, block, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      H, KVH, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

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

extern "C" int flash_fwd_route(int D, int dtype) {
  return hopper_tc::route(D, dtype);
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int KVH, int S,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hopper_tc::route(D, dtype)) {
    case hopper_tc::kRouteTensorCore:
      e = D == 64 ? tc::launch<64>(q, k, v, out, lse, B, H, KVH, S, scale,
                                   causal, s)
                  : tc::launch<128>(q, k, v, out, lse, B, H, KVH, S, scale,
                                    causal, s);
      break;
    case hopper_tc::kRouteScalar:
      e = dtype == 0 ? dispatch<float>(D, q, k, v, out, lse, B, H, KVH, S,
                                       scale, causal, s)
                     : dispatch<__nv_bfloat16>(D, q, k, v, out, lse, B, H,
                                               KVH, S, scale, causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
