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
// (flash_fwd_kernel), on the CUDA cores in full f32 (fmaf; TF32 would
// not hold the f32 card-vs-CPU parity). It serves the f32 paths: the
// serving prefill of PagedDecoder (one request at a time: B 1, H 16,
// KVH 8, D 128 at llama3-1b, prompts of 85-256 tokens), generate in f32
// and the f32 parity gates (S 200, the ring's 512-token shards).
//   - What bounds it. At S 2048 the products: 4 * D flops per visible
//     pair at the 67 TFLOP/s of the f32 FMA units, 0.257 ms for B 1
//     H 16 (the kernel reaches about 40% of that on the H100). At the
//     serving prompts the products are a few microseconds of that peak;
//     the time is the chain one warp walks (its rows against every key
//     up to the diagonal), the copies that feed it (every position tile
//     re-reads its K/V through L2; the first tile's latency) and the
//     launch, and whether every SM has a chain to walk at all.
//   - Rows. A warp owns 8 query rows for the whole loop (softmax
//     reductions are shuffles inside the warp, P and the rescale factors
//     pass through a per-warp slice of shared memory), so a chain is 8
//     rows long whatever the block size. A block has 1, 2, 4 or 8 warps,
//     the most that still give at least one block per SM (launch picks
//     it from B, H, S and the card's SM count): 1 at S 85, 2 at S 225
//     and 256, 4 at S 512, 8 at S 2048 (B 1, H 16, KVH 8). The rows of a
//     block are the heads of one GQA group (up to gcd(group, rows)) at
//     consecutive positions, interleaved, so the group reads each K/V
//     tile once and the rows of a warp end near one causal diagonal. The
//     grid starts with the longest causal position tiles.
//   - Bytes. K and V tiles of 32 keys reach shared memory by cp.async
//     16-byte copies into a 2-stage ring, the next tile's copies started
//     right after the one barrier of each tile, so they overlap this
//     tile's products; keys past S arrive as zeros. bf16 tiles stay bf16
//     in shared memory and widen to f32 in registers as they are read.
//     A warp skips a tile past its last row's diagonal and masks only
//     the tiles that cross its diagonal or S.
//   - Products, register-blocked. q.k^T: a lane holds a 2 x 4 score
//     tile (rows r, r + 4; keys j, j + 8, j + 16, j + 24) and reads 2 Q
//     and 4 K float4s for 32 FMAs (the previous kernel: 6 scalar loads
//     for 8); a warp's load is 4 or 8 distinct 16-byte words, one
//     shared-memory wavefront. p.v: a
//     lane holds PR rows x 4 (or 8) columns of O and reads P as float4s
//     along the keys and V as float4s along the columns: 12 loads for
//     128 FMAs at D 128. Every sum runs in a fixed order (d, then keys
//     in order, tile after tile), so the result is bitwise repeatable
//     and independent of the block size chosen.
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
#include "scalar_route.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------- scalar route

using namespace scalar_route;

constexpr int kBK = 32;        // keys per kv tile
constexpr int kPStride = kBK + 8;  // P row stride in floats: 8 banks apart

// Shared memory of a block of nw warps: the Q rows, the K/V ring (both in
// T, rows padded by 16 bytes so that the float4 reads of 8 consecutive
// rows hit distinct banks), then per warp its P tile and its rows'
// rescale factors and sums (f32).
template <typename T, int HD>
struct Smem {
  static constexpr int kLd = HD + 16 / sizeof(T);         // row stride
  static constexpr int kChunks = HD * sizeof(T) / 16;     // copies a row
  static constexpr int kTile = kBK * kLd;                 // one K or V tile
  static constexpr size_t bytes(int nw) {
    return sizeof(T) * (static_cast<size_t>(kRows * nw * kLd) +
                        2 * kStages * kTile) +
           sizeof(float) * static_cast<size_t>(nw * kRows * (kPStride + 2));
  }
};

// One block: the heads h0 .. h0 + gb - 1 of one kv head (gb = 1 << gb_log2)
// at npos consecutive positions from p0; block row r is head
// h0 + r % gb at position p0 + r / gb, and warp w owns rows 8 w .. 8 w + 7.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int KVH, int S, float scale,
                 int causal, int gb_log2) {
  using L = Smem<T, HD>;
  constexpr int kEl = 16 / sizeof(T);
  // p.v lane layout (RowTile).
  constexpr int LD = RowTile<HD>::LD, NCH = RowTile<HD>::NCH;
  constexpr int LR = RowTile<HD>::LR, PR = RowTile<HD>::PR;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nw = blockDim.x >> 5;
  const int nrows = kRows * nw;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + nrows * L::kLd;
  float* pbase = reinterpret_cast<float*>(ring + 2 * kStages * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ps = pbase + warp * kRows * kPStride;
  float* Al = pbase + nw * kRows * kPStride + warp * 2 * kRows;
  float* Ls = Al + kRows;

  const int gb = 1 << gb_log2;
  const int groups = H >> gb_log2;              // head groups per batch row
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) << gb_log2;
  const int kvh = h0 / (H / KVH);
  const int npos = nrows >> gb_log2;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * npos;  // longest first
  const int p_last = min(S - 1, p0 + npos - 1);
  const int n_kv = causal ? p_last / kBK + 1 : (S + kBK - 1) / kBK;

  const T* kp = k + static_cast<size_t>(b * KVH + kvh) * S * HD;
  const T* vp = v + static_cast<size_t>(b * KVH + kvh) * S * HD;

  for (int e = threadIdx.x; e < nrows * L::kChunks; e += blockDim.x) {
    const int r = e / L::kChunks, c = e % L::kChunks;
    const int pos = p0 + (r >> gb_log2);
    const int h = h0 + (r & (gb - 1));
    const size_t src =
        (static_cast<size_t>(b * H + h) * S + (pos < S ? pos : 0)) * HD +
        c * kEl;
    cp_async16(Qs + r * L::kLd + c * kEl, q + src, pos < S);
  }
  copy_rows2<T, HD>(ring, ring + L::kTile, kp, vp, 0, kBK, S, L::kLd);
  cp_async_commit();

  // Positions of this warp's first and last row; a warp whose rows all
  // lie past S only helps with the copies.
  const int row0 = warp * kRows;
  const int pw_lo = p0 + (row0 >> gb_log2);
  const int pw_hi = min(S - 1, p0 + ((row0 + kRows - 1) >> gb_log2));
  const bool live = pw_lo < S;

  // q.k^T lane layout: rows qr and qr + 4, keys qk + 8 j.
  const int qr = lane >> 3, qk = lane & 7;
  const int qpos[2] = {p0 + ((row0 + qr) >> gb_log2),
                       p0 + ((row0 + qr + 4) >> gb_log2)};
  const T* qrow0 = Qs + (row0 + qr) * L::kLd;
  const T* qrow1 = qrow0 + 4 * L::kLd;
  const int vr = lane / LD, vc = lane % LD;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[PR][NCH][4];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ch][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    // Tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kv) {
      T* next = ring + ((kt + 1) & 1) * 2 * L::kTile;
      copy_rows2<T, HD>(next, next + L::kTile, kp, vp, (kt + 1) * kBK, kBK,
                        S, L::kLd);
      cp_async_commit();
    }
    const int k0 = kt * kBK;
    if (!live || (causal && k0 > pw_hi)) continue;  // warp-uniform
    const T* Ks = ring + (kt & 1) * 2 * L::kTile;
    const T* Vs = Ks + L::kTile;

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 a0 = ld4(qrow0 + d), a1 = ld4(qrow1 + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kb = ld4(Ks + (qk + 8 * j) * L::kLd + d);
        s[0][j] = fmaf(a0.x, kb.x, s[0][j]);
        s[0][j] = fmaf(a0.y, kb.y, s[0][j]);
        s[0][j] = fmaf(a0.z, kb.z, s[0][j]);
        s[0][j] = fmaf(a0.w, kb.w, s[0][j]);
        s[1][j] = fmaf(a1.x, kb.x, s[1][j]);
        s[1][j] = fmaf(a1.y, kb.y, s[1][j]);
        s[1][j] = fmaf(a1.z, kb.z, s[1][j]);
        s[1][j] = fmaf(a1.w, kb.w, s[1][j]);
      }
    }

    // Online softmax of the lane's two rows; the 8 lanes of a row
    // (lane bits 0-2) reduce by butterfly, so all hold the same m and l.
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > pw_lo);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + qk + 8 * j;
        ok[j] = !edge || (kj < S && (!causal || kj <= qpos[i]));
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      // A masked key contributes exactly 0, so a row that sees no key in
      // this tile keeps alpha = 1 and never turns into NaN.
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(qr + 4 * i) * kPStride + qk + 8 * j] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (qk == 0) Al[qr + 4 * i] = alpha;
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const float a = Al[vr + LR * i];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][ch][e] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i)
        p[i] = ld4(Ps + (vr + LR * i) * kPStride + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const float4 vv =
              ld4(Vs + (c + kk) * L::kLd + 4 * vc + (HD / NCH) * ch);
#pragma unroll
          for (int i = 0; i < PR; ++i) {
            const float pk = comp(p[i], kk);
            acc[i][ch][0] = fmaf(pk, vv.x, acc[i][ch][0]);
            acc[i][ch][1] = fmaf(pk, vv.y, acc[i][ch][1]);
            acc[i][ch][2] = fmaf(pk, vv.z, acc[i][ch][2]);
            acc[i][ch][3] = fmaf(pk, vv.w, acc[i][ch][3]);
          }
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + qr + 4 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    if (qk == 0) {
      Ls[qr + 4 * i] = l[i];
      if (qpos[i] < S)
        lse[static_cast<size_t>(b * H + h0 + (r & (gb - 1))) * S +
            qpos[i]] = m[i] + logf(lc);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = row0 + vr + LR * i;
    const int pos = p0 + (r >> gb_log2);
    if (pos >= S) continue;
    const float lc = fmaxf(Ls[vr + LR * i], 1e-30f);
    T* orow = out + (static_cast<size_t>(b * H + h0 + (r & (gb - 1))) * S +
                     pos) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      st4(orow + 4 * vc + (HD / NCH) * ch, acc[i][ch][0] / lc,
          acc[i][ch][1] / lc, acc[i][ch][2] / lc, acc[i][ch][3] / lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  using L = Smem<T, HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kMaxWarps)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const QueryGrid g = query_grid(B, H, KVH, S, sms);
  if (g.grid.y > 65535) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, HD><<<g.grid, 32 * g.warps, L::bytes(g.warps),
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, KVH, S, scale, causal, g.gb_log2);
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

// The scalar instances: f32 at every D, bf16 at D 16 and 32 (bf16 at D
// 64 and 128 takes the tensor-core route).
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, void* out, void* lse, int B, int H,
                     int KVH, int S, float scale, int causal,
                     cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 1000 + D) {
    case 16: return launch<float, 16>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 32: return launch<float, 32>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 64: return launch<float, 64>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 128: return launch<float, 128>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 1016: return launch<bf16, 16>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
    case 1032: return launch<bf16, 32>(q, k, v, out, lse, B, H, KVH, S, scale, causal, s);
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
      e = dispatch(D, dtype, q, k, v, out, lse, B, H, KVH, S, scale,
                   causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
