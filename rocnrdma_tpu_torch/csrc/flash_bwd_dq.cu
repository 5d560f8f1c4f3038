// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: rocnrdma_tpu/ops/attention.py:_bwd_dq_kernel (launched by
// _flash_backward; tile math _bwd_tile, here flash_bwd_common.cuh). Same
// contract: q, dO (B,H,S,D), k, v (B,KVH,S,D) in bf16 or f32, lse and
// delta = rowsum(dO * out) (B,H,S,1) f32; dQ (B,H,S,D) in q's dtype.
// Query head h reads kv head h / (H/KVH) in place.
//
// Bound on H100: operations. Per (b, h) it does 6*D flops for every
// visible (query, key) pair (Q K^T, dO V^T and dS K) against
// (3 + 2/group) * S * D * elt + 8 * S bytes, above the ~295 flop/byte
// ridge at S = 2048, D = 128: the floor is the flops over the tensor-core
// peak.
//
// Two instances, chosen by dtype and D alone (hopper_tc::route):
//
// Tensor-core route, bf16 at D = 64 and 128 (flash_bwd_dq_tc_kernel).
// One block per (b, h, 64 query rows): two consumer warpgroups and a
// producer warp. Q and dO of the block arrive once by TMA; the block
// walks the kv tiles of 64 keys up to the causal diagonal (the
// _last_kv_block rule). Tile kt goes to warpgroup kt % 2, so one
// warpgroup's softmax gradient overlaps the other's products; each keeps
// a dQ partial sum in f32 registers, and at the end the two are added in a
// fixed order through shared memory and written once in bf16: two calls
// give bitwise equal outputs. The grid starts with the longest causal q
// tiles, and the heads of one GQA group are neighbours in it, so they
// read the same K/V tiles, from L2 after the first.
//   - Operations: all three products are warpgroup wgmma on bf16 tiles in
//     query-row orientation: S = Q K^T and dP = dO V^T (m64n64k16, both
//     operands from shared memory, K-major as stored), then dQ += dS K
//     (dS from registers, rounded to bf16 in the A layout; K from shared
//     memory, MN-major). dS is rebuilt in the dP accumulator registers by
//     the shared rule (bwd_visible, bwd_p, bwd_ds); a thread's two query
//     rows are fixed, so it reads their lse and delta once, before the
//     loop.
//   - Bytes: K and V tiles of 64 rows come by TMA (3-D tensor maps over
//     (D, S, B*heads): rows past S arrive as zeros) into a 4-stage ring
//     (two stages per warpgroup) of 128-byte-swizzled tiles with
//     mbarriers.
//   - Registers: at D = 128, dQ is 64 f32 per consumer thread, S and dP
//     64 more and the bf16 dS fragments 16. The producer is a whole
//     warpgroup of which one thread works, so setmaxnreg can give the
//     consumers 232 registers and the producer 40 (3 x 168 at entry, one
//     block of 384 threads per SM).
//
// Scalar route, f32 at every D and bf16 at D = 16 and 32
// (flash_bwd_dq_kernel), on the CUDA cores in full f32 (fmaf; TF32 would
// not hold the f32 card-vs-CPU parity), the shape of K3's scalar route.
//   - What bounds it. At S 2048 the products: 6 * D flops per visible
//     pair at the 67 TFLOP/s of the f32 FMA units, 0.385 ms for B 1 H 16
//     causal. At S 200 the chain one warp walks and the card's fill.
//   - Rows. A warp owns 8 query rows for the whole kv loop and keeps their
//     dQ in registers; their lse and delta are read once. A block has 1,
//     2, 4 or 8 warps, the most that still give every SM a block (launch
//     picks it from B, H, S and the SM count); its rows are the heads of
//     one GQA group at consecutive positions, interleaved, so the group
//     shares each K/V tile of the block. The grid starts with the longest
//     causal position tiles.
//   - Bytes. K and V tiles of 32 keys reach shared memory by cp.async into
//     a 2-stage ring, the next tile's copies started right after the one
//     barrier of each tile; keys past S arrive as zeros and query rows
//     past S are masked and never written. A warp skips a tile past its
//     last row's diagonal.
//   - Products, register-blocked. s = Q K^T and dp = dO V^T by warp_dot
//     (flash_bwd_common.cuh): a lane sums a quarter of D for all 8 rows
//     against 4 keys, 12 float4 reads for 128 FMAs a step of 4 along D,
//     and two shuffle exchanges add the quarters. ds comes from the
//     shared rule in registers and passes through the warp's own slice
//     (__syncwarp); dQ += ds K reads ds as float4s along the keys and K as
//     float4s along the columns: 12 loads for 128 FMAs at D 128. dQ sums
//     the keys in order, so it is bitwise independent of the block size.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; flash_bwd_dq returns
// cudaGetLastError(), flash_bwd_dq_route(D, dtype) the instance it
// launches (1 tensor core, 0 scalar, -1 refused).

#include "flash_bwd_common.cuh"
#include "hopper_tc.cuh"
#include "scalar_route.cuh"

namespace {

using namespace flash_bwd;
using namespace scalar_route;

// ------------------------------------------------------------ scalar route

// Shared memory of a block of nw warps: its Q and dO rows and the K/V
// ring (all in T, rows padded by 16 bytes), then per warp its ds slice
// (f32).
template <typename T, int HD>
struct Smem {
  static constexpr int kLd = HD + 16 / sizeof(T);  // row stride
  static constexpr int kTile = kBT * kLd;          // one K or V tile
  static constexpr size_t bytes(int nw) {
    return sizeof(T) * (2 * static_cast<size_t>(kRows * nw * kLd) +
                        2 * kStages * kTile) +
           sizeof(float) * static_cast<size_t>(nw * kRows * kPStride);
  }
};

// One block: the heads h0 .. h0 + gb - 1 of one kv head (gb = 1 << gb_log2)
// at npos consecutive positions from p0; block row r is head
// h0 + r % gb at position p0 + r / gb, and warp w owns rows 8 w .. 8 w + 7.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KVH, int S, float scale, int causal,
                    int gb_log2) {
  using L = Smem<T, HD>;
  constexpr int kEl = 16 / sizeof(T);
  constexpr int kChunks = HD / kEl;
  constexpr int LD = RowTile<HD>::LD, NCH = RowTile<HD>::NCH;
  constexpr int LR = RowTile<HD>::LR, PR = RowTile<HD>::PR;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nw = blockDim.x >> 5;
  const int nrows = kRows * nw;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + nrows * L::kLd;
  T* ring = dOs + nrows * L::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ds = reinterpret_cast<float*>(ring + 2 * kStages * L::kTile) +
              warp * kRows * kPStride;

  const int gb = 1 << gb_log2;
  const int groups = H >> gb_log2;  // head groups per batch row
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) << gb_log2;
  const int kvh = h0 / (H / KVH);
  const int npos = nrows >> gb_log2;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * npos;  // longest first
  const int p_last = min(S - 1, p0 + npos - 1);
  const int n_kv = causal ? p_last / kBT + 1 : (S + kBT - 1) / kBT;

  const T* kp = k + static_cast<size_t>(b * KVH + kvh) * S * HD;
  const T* vp = v + static_cast<size_t>(b * KVH + kvh) * S * HD;

  for (int e = threadIdx.x; e < nrows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks;
    const int pos = p0 + (r >> gb_log2);
    const int h = h0 + (r & (gb - 1));
    const size_t src =
        (static_cast<size_t>(b * H + h) * S + (pos < S ? pos : 0)) * HD +
        c * kEl;
    cp_async16(Qs + r * L::kLd + c * kEl, q + src, pos < S);
    cp_async16(dOs + r * L::kLd + c * kEl, dout + src, pos < S);
  }
  copy_rows2<T, HD>(ring, ring + L::kTile, kp, vp, 0, kBT, S, L::kLd);
  cp_async_commit();

  // Positions of this warp's first and last row; a warp whose rows all
  // lie past S only helps with the copies.
  const int row0 = warp * kRows;
  const int pw_lo = p0 + (row0 >> gb_log2);
  const int pw_hi = min(S - 1, p0 + ((row0 + kRows - 1) >> gb_log2));
  const bool live = pw_lo < S;

  // s / dp lane layout (warp_dot): rows 2 quarter and 2 quarter + 1 of
  // the warp, keys qk + 8 j; the rows' lse and delta are read once.
  const int quarter = lane >> 3, qk = lane & 7;
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 2 * quarter + i;
    qpos[i] = p0 + (r >> gb_log2);
    const size_t g =
        static_cast<size_t>(b * H + h0 + (r & (gb - 1))) * S + qpos[i];
    lse_r[i] = qpos[i] < S ? lse[g] : 0.f;
    delta_r[i] = qpos[i] < S ? delta[g] : 0.f;
  }
  const int vr = lane / LD, vc = lane % LD;

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
      copy_rows2<T, HD>(next, next + L::kTile, kp, vp, (kt + 1) * kBT, kBT,
                        S, L::kLd);
      cp_async_commit();
    }
    const int k0 = kt * kBT;
    if (!live || (causal && k0 > pw_hi)) continue;  // warp-uniform
    const T* Ks = ring + (kt & 1) * 2 * L::kTile;
    const T* Vs = Ks + L::kTile;

    float s[2][kNJ], dp[2][kNJ];
    warp_dot<T, HD>(Qs + row0 * L::kLd, Ks, L::kLd, lane, s);
    warp_dot<T, HD>(dOs + row0 * L::kLd, Vs, L::kLd, lane, dp);

    // ds by the shared rule, into the warp's slice.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float p = bwd_visible(qpos[i], k0 + qk + 8 * j, S, causal)
                            ? bwd_p(s[i][j], scale, lse_r[i])
                            : 0.f;
        Ds[(2 * quarter + i) * kPStride + qk + 8 * j] =
            bwd_ds(p, dp[i][j], delta_r[i], scale);
      }
    __syncwarp();

    // dQ += ds K, keys in order.
#pragma unroll 2
    for (int c = 0; c < kBT; c += 4) {
      float4 ds4[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i)
        ds4[i] = ld4(Ds + (vr + LR * i) * kPStride + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const float4 kv =
              ld4(Ks + (c + kk) * L::kLd + 4 * vc + (HD / NCH) * ch);
#pragma unroll
          for (int i = 0; i < PR; ++i) {
            const float dsk = comp(ds4[i], kk);
            acc[i][ch][0] = fmaf(dsk, kv.x, acc[i][ch][0]);
            acc[i][ch][1] = fmaf(dsk, kv.y, acc[i][ch][1]);
            acc[i][ch][2] = fmaf(dsk, kv.z, acc[i][ch][2]);
            acc[i][ch][3] = fmaf(dsk, kv.w, acc[i][ch][3]);
          }
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = row0 + vr + LR * i;
    const int pos = p0 + (r >> gb_log2);
    if (pos >= S) continue;
    T* row = dq + (static_cast<size_t>(b * H + h0 + (r & (gb - 1))) * S +
                   pos) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      st4(row + 4 * vc + (HD / NCH) * ch, acc[i][ch][0], acc[i][ch][1],
          acc[i][ch][2], acc[i][ch][3]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  using L = Smem<T, HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kMaxWarps)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const QueryGrid g = query_grid(B, H, KVH, S, sms);
  if (g.grid.y > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, HD><<<g.grid, 32 * g.warps, L::bytes(g.warps),
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, KVH, S, scale, causal, g.gb_log2);
  return cudaGetLastError();
}

// ------------------------------------------------------ tensor-core route

namespace tc {

using namespace hopper_tc;

constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 64;     // keys per kv tile (== kBQ: the causal stop
                            // and the diagonal test assume it)
constexpr int kNWG = 2;     // consumer warpgroups; tile kt goes to kt % kNWG
constexpr int kStages = 4;  // K/V ring depth: two stages per warpgroup
// The producer is a whole warpgroup (one thread works) so that setmaxnreg
// can move registers: ptxas sizes the entry for 384 threads (168 each);
// the producer gives back to 40, the consumers take 232.
constexpr int kThreadsTC = (kNWG + 1) * 128;

template <int HD>
struct Layout {
  static constexpr int kTile = (HD / kChunkCols) * kChunkBytes;  // 64 x HD
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kTile;
  static constexpr int kK = kdO + kTile;               // [kStages]
  static constexpr int kV = kK + kStages * kTile;      // [kStages]
  static constexpr int kBar = kV + kStages * kTile;    // full, empty, q
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
  // The second warpgroup's dQ partial sums, after the loop, over the K/V
  // stages: HD / 2 f32 per consumer thread.
  static_assert(128 * (HD / 2) * 4 <= 2 * kStages * kTile,
                "reduction buffer");
};

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int KVH, int S,
                       float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.x;  // grid.y walks q tiles: causal-heavy first
  const int b = bh / H;
  const int bkv = b * KVH + (bh % H) / (H / KVH);
  const int qt = gridDim.y - 1 - blockIdx.y;
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

  if (threadIdx.x >= kNWG * 128) {
    // Producer warpgroup: one thread starts every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kNWG * 128) return;
    mbar_arrive_expect_tx(qbar, 2 * L::kTile);
    for (int c = 0; c < HD / kChunkCols; ++c) {
      tma_load_3d(smem + L::kQ + c * kChunkBytes, &tq, qbar, c * kChunkCols,
                  q0, bh);
      tma_load_3d(smem + L::kdO + c * kChunkBytes, &tdo, qbar,
                  c * kChunkCols, q0, bh);
    }
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
    return;
  }

  // Consumer warpgroup wg takes kv tiles wg, wg + kNWG, ...: query rows
  // q0 + row0 and q0 + row0 + 8; of every 8 keys of a tile, the two at
  // col0 (hopper_tc.cuh, Fragments).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int row0 = (t / 32) * 16 + (t % 32) / 4;
  const int col0 = 2 * (t % 4);
  const uint32_t q_tile = smem_u32(smem + L::kQ);
  const uint32_t do_tile = smem_u32(smem + L::kdO);

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    const size_t g = static_cast<size_t>(bh) * S + qi;
    lse_r[r] = qi < S ? lse[g] : 0.f;
    delta_r[r] = qi < S ? delta[g] : 0.f;
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = wg; kt < n_kv; kt += kNWG) {
    const int s = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t k_tile = smem_u32(smem + L::kK + s * L::kTile);
    const uint32_t v_tile = smem_u32(smem + L::kV + s * L::kTile);

    float st[32], dp[32];  // S and dP: 64 queries x 64 keys
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(st, desc_kmajor(q_tile, kk), desc_kmajor(k_tile, kk), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(do_tile, kk), desc_kmajor(v_tile, kk),
                   1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dp);

    // dS into dp by the rule K4 uses, every pair tested: a test skipped
    // off the diagonal under a branch made ptxas serialise the wgmma
    // (C7520).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int kj = k0 + 8 * (i / 4) + col0 + (i & 1);
      const float p =
          flash_bwd::bwd_visible(q0 + row0 + 8 * r, kj, S, causal)
              ? flash_bwd::bwd_p(st[i], scale, lse_r[r])
              : 0.f;
      dp[i] = flash_bwd::bwd_ds(p, dp[i], delta_r[r], scale);
    }
    uint32_t dsa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) a_fragment(dp, kk, dsa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<HD>(acc, dsa[kk], desc_mnmajor(k_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // Sum the two warpgroups' partials in a fixed order (warpgroup 0 +
  // warpgroup 1) through shared memory: once both have left the loop,
  // every copy the producer started has been consumed and the K/V stages
  // are free. A warpgroup that took no tile adds zeros.
  float* red = reinterpret_cast<float*>(smem + L::kK);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kNWG * 128) : "memory");
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) red[i * 128 + t] = acc[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kNWG * 128) : "memory");
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] += red[i * 128 + t];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 8 * r;
      if (qi >= S) continue;
      __nv_bfloat16* row = dq + (static_cast<size_t>(bh) * S + qi) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col0) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KVH, int S, float scale,
                   int causal, cudaStream_t stream) {
  using L = Layout<HD>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(&tq, q, HD, S, B * H) ||
      !encode_rows(&tk, k, HD, S, B * KVH) ||
      !encode_rows(&tv, v, HD, S, B * KVH) ||
      !encode_rows(&tdo, dout, HD, S, B * H))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ), block(kThreadsTC);
  flash_bwd_dq_tc_kernel<HD><<<grid, block, L::kBytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      KVH, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc


// The scalar instances: f32 at every D, bf16 at D 16 and 32 (bf16 at D
// 64 and 128 takes the tensor-core route).
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int KVH,
                     int S, float scale, int causal, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 1000 + D) {
    case 16: return launch<float, 16>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    case 32: return launch<float, 32>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    case 64: return launch<float, 64>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    case 128: return launch<float, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    case 1016: return launch<bf16, 16>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    case 1032: return launch<bf16, 32>(q, k, v, dout, lse, delta, dq, B, H, KVH, S, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_bwd_dq_route(int D, int dtype) {
  return hopper_tc::route(D, dtype);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int KVH, int S, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hopper_tc::route(D, dtype)) {
    case hopper_tc::kRouteTensorCore:
      e = D == 64 ? tc::launch<64>(q, k, v, dout, lse, delta, dq, B, H, KVH,
                                   S, scale, causal, s)
                  : tc::launch<128>(q, k, v, dout, lse, delta, dq, B, H,
                                    KVH, S, scale, causal, s);
      break;
    case hopper_tc::kRouteScalar:
      e = dispatch(D, dtype, q, k, v, dout, lse, delta, dq, B, H, KVH, S,
                   scale, causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
