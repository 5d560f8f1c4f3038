// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: rocnrdma_tpu/ops/attention.py:_bwd_dkv_kernel (launched by
// _flash_backward; tile math _bwd_tile, here the per-element rule of
// flash_bwd_common.cuh). Same contract: q, dO (B,H,S,D), k, v (B,KVH,S,D)
// in bf16 or f32, lse and delta = rowsum(dO * out) (B,H,S,1) f32; dK, dV
// (B,KVH,S,D) in k's dtype. Query head h belongs to kv head h / (H/KVH).
//
// Bound on H100: operations. Per (b, h) it does 8*D flops for every
// visible (query, key) pair (the products Q K^T, dO V^T, P^T dO and
// dS^T Q) against (2 + 4/group) * S * D * elt + 8 * S bytes of inputs
// and outputs (q, dO; k, v, dK, dV shared by the group; lse, delta),
// which at S = 2048, D = 128 sits above the ~295 flop/byte ridge: the
// floor is the flops over the tensor-core peak.
//
// Two instances, chosen by dtype and D alone (hopper_tc::route):
//
// Tensor-core route, bf16 at D = 64 and 128 (flash_bwd_dkv_tc_kernel).
// One block per (b, kv head, 64 key rows): two consumer warpgroups and a
// producer warp. K and V of the block arrive once by TMA; the block walks
// every query head of the GQA group and, for each, the q tiles from the
// causal diagonal on (the _first_q_block skip). Item it of that walk goes
// to warpgroup it % 2, so one warpgroup's softmax gradient overlaps the
// other's products; each keeps dK and dV partial sums in f32 registers
// across its items, and at the end the two are added in a fixed order
// through shared memory and written once in bf16. The group sum needs no
// atomics: two calls give bitwise equal outputs.
//   - Operations: all four products are warpgroup wgmma on bf16 tiles in
//     key-row orientation, so every A operand is in shared memory or
//     already in registers: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//     operands from shared memory, K-major as stored), then dV += P^T dO
//     and dK += dS^T Q (P^T and dS^T from registers, rounded to bf16 in
//     the A layout; dO and Q from shared memory, MN-major). P^T and dS^T
//     are rebuilt in the S^T and dP^T accumulator registers by the shared
//     rule (bwd_visible, bwd_p, bwd_ds), lse and delta read per column.
//   - Bytes: Q and dO tiles of 64 rows come by TMA (3-D tensor maps over
//     (D, S, B*heads): rows past S arrive as zeros) into a 4-stage ring
//     (two stages per warpgroup) of 128-byte-swizzled tiles with
//     mbarriers; the producer warp copies each tile's 64 lse and delta
//     values beside it, so the next item's copy overlaps this one's
//     products.
//   - Registers: at D = 128, dK + dV are 128 f32 per consumer thread and
//     S^T + dP^T 64 more, both finished before the register-sourced
//     products start. The producer is a whole warpgroup of which one warp
//     works, so setmaxnreg can give the consumers 232 registers and the
//     producer 40 (3 x 168 at entry, one block of 384 threads per SM).
//
// Scalar route, f32 at every D and bf16 at D = 16 and 32
// (flash_bwd_dkv_kernel), on the CUDA cores in full f32 (fmaf; TF32 would
// not hold the f32 card-vs-CPU parity). It serves every f32 backward: the
// f32 training parity (llama3-1b, S 200), the f32 sequence-parallel
// parity's 512-token shards and the f32 mesh parity.
//   - What bounds it. At S 2048 the products: 8 * D flops per visible
//     pair at the 67 TFLOP/s of the f32 FMA units, 0.513 ms for B 1 H 16
//     causal. At S 200 the chain one warp walks (its keys against every
//     query of the group from its diagonal on) and the card's fill.
//   - Rows. A warp owns 8 key rows for its whole walk and keeps their dK
//     and dV in registers; for each query head of the group in turn it
//     walks the query tiles from its diagonal on (sums over heads, then
//     query rows ascending), and the group sum needs no atomics. A block
//     has 1, 2, 4 or 8 warps on consecutive keys, the most that still give
//     every SM a block (launch picks it from B, KVH, S and the SM count);
//     grid.y walks the key tiles from the first, so the blocks with the
//     longest causal walk launch first.
//   - Bytes. The block's K and V rows arrive once by cp.async; Q, dO, lse
//     and delta of 32 query rows reach a 2-stage ring by cp.async, the
//     next tile's copies started right after the one barrier of each
//     tile, so they overlap this tile's products. bf16 stays bf16 in
//     shared memory and widens in registers.
//   - Products, register-blocked. s^T = K Q^T and dp^T = V dO^T by
//     warp_dot (flash_bwd_common.cuh): a lane sums a quarter of D for the
//     warp's 8 keys against 4 queries, 12 float4 reads for 128 FMAs a step
//     of 4 along D, and two shuffle exchanges add the quarters. p^T
//     and ds^T come from the shared rule in registers and pass to the
//     warp's own p and ds slices (__syncwarp); dV += p^T dO and
//     dK += ds^T Q then read p and ds as float4s along the queries and dO
//     and Q as float4s along the columns: 24 loads for 256 FMAs at D 128.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; flash_bwd_dkv returns
// cudaGetLastError(), flash_bwd_dkv_route(D, dtype) the instance it
// launches (1 tensor core, 0 scalar, -1 refused).

#include "flash_bwd_common.cuh"
#include "hopper_tc.cuh"
#include "scalar_route.cuh"

namespace {

using namespace flash_bwd;
using namespace scalar_route;

// ------------------------------------------------------------ scalar route

// Shared memory of a block of nw warps: its K and V rows and the Q/dO
// ring (all in T, rows padded by 16 bytes), then the ring's lse and delta
// and per warp its p and ds slices (f32).
template <typename T, int HD>
struct Smem {
  static constexpr int kLd = HD + 16 / sizeof(T);  // row stride
  static constexpr int kTile = kBT * kLd;          // one Q or dO tile
  static constexpr size_t bytes(int nw) {
    return sizeof(T) * (2 * static_cast<size_t>(kRows * nw * kLd) +
                        2 * kStages * kTile) +
           sizeof(float) * (2 * kStages * kBT +
                            static_cast<size_t>(nw * 2 * kRows * kPStride));
  }
};

// One block: the key rows kb .. kb + 8 nw - 1 of kv head bkv (warp w owns
// kb + 8 w .. kb + 8 w + 7); it walks every query head of the GQA group in
// turn and, for each, the q tiles from the block's causal diagonal on.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KVH, int S, float scale,
                     int causal) {
  using L = Smem<T, HD>;
  constexpr int LD = RowTile<HD>::LD, NCH = RowTile<HD>::NCH;
  constexpr int LR = RowTile<HD>::LR, PR = RowTile<HD>::PR;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nw = blockDim.x >> 5;
  const int nrows = kRows * nw;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + nrows * L::kLd;
  T* ring = Vs + nrows * L::kLd;  // [stage][Q, dO]
  float* rows_f = reinterpret_cast<float*>(ring + 2 * kStages * L::kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ps = rows_f + 2 * kStages * kBT + warp * 2 * kRows * kPStride;
  float* dSs = Ps + kRows * kPStride;

  const int bkv = blockIdx.x;
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH;
  const int kb = blockIdx.y * nrows;  // grid.y ascending: longest walk first
  const int nq = (S + kBT - 1) / kBT;
  const int first_qt = causal ? kb / kBT : 0;
  const int per_head = nq - first_qt;
  const int n_it = group * per_head;  // (query head, q tile) items

  const size_t kv_off = static_cast<size_t>(bkv) * S * HD;
  copy_rows2<T, HD>(Ks, Vs, k + kv_off, v + kv_off, kb, nrows, S, L::kLd);
  // Item it's Q, dO, lse and delta into ring stage st.
  auto load_item = [&](int it, int st) {
    const int bh = b * H + kvh * group + it / per_head;
    const int q0 = (first_qt + it % per_head) * kBT;
    const size_t off = static_cast<size_t>(bh) * S * HD;
    T* t = ring + st * 2 * L::kTile;
    copy_rows2<T, HD>(t, t + L::kTile, q + off, dout + off, q0, kBT, S,
                      L::kLd);
    float* lt = rows_f + st * 2 * kBT;
    for (int r = threadIdx.x; r < kBT; r += blockDim.x) {
      const int g = q0 + r;
      const size_t src = static_cast<size_t>(bh) * S + (g < S ? g : 0);
      cp_async4(lt + r, lse + src, g < S);
      cp_async4(lt + kBT + r, delta + src, g < S);
    }
  };
  load_item(0, 0);
  cp_async_commit();

  // s^T / dp^T lane layout (warp_dot): key rows 2 quarter and
  // 2 quarter + 1 of the warp's 8, queries qc + 8 j of the tile.
  const int kw = kb + warp * kRows;  // the warp's first key
  const bool live = kw < S;
  const int quarter = lane >> 3, qc = lane & 7;
  const int vr = lane / LD, vc = lane % LD;

  float acc_k[PR][NCH][4], acc_v[PR][NCH][4];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[i][ch][e] = acc_v[i][ch][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    // Item it has landed for every thread, and every warp is done with
    // item it - 1, whose stage the next copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) {
      load_item(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int q0 = (first_qt + it % per_head) * kBT;
    if (!live || (causal && q0 + kBT - 1 < kw)) continue;  // warp-uniform
    const T* Qt = ring + (it & 1) * 2 * L::kTile;
    const T* dOt = Qt + L::kTile;
    const float* lse_t = rows_f + (it & 1) * 2 * kBT;
    const float* delta_t = lse_t + kBT;

    float st[2][kNJ], dpt[2][kNJ];
    warp_dot<T, HD>(Ks + warp * kRows * L::kLd, Qt, L::kLd, lane, st);
    warp_dot<T, HD>(Vs + warp * kRows * L::kLd, dOt, L::kLd, lane, dpt);

    // p^T and ds^T by the shared rule, into the warp's slices.
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = qc + 8 * j;
      const float l = lse_t[c], dl = delta_t[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * quarter + i;
        const float p = bwd_visible(q0 + c, kw + r, S, causal)
                            ? bwd_p(st[i][j], scale, l)
                            : 0.f;
        Ps[r * kPStride + c] = p;
        dSs[r * kPStride + c] = bwd_ds(p, dpt[i][j], dl, scale);
      }
    }
    __syncwarp();

    // dV += p^T dO and dK += ds^T Q, queries in order.
#pragma unroll 2
    for (int c = 0; c < kBT; c += 4) {
      float4 p4[PR], s4[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        p4[i] = ld4(Ps + (vr + LR * i) * kPStride + c);
        s4[i] = ld4(dSs + (vr + LR * i) * kPStride + c);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int col = 4 * vc + (HD / NCH) * ch;
          const float4 ov = ld4(dOt + (c + kk) * L::kLd + col);
          const float4 qv = ld4(Qt + (c + kk) * L::kLd + col);
#pragma unroll
          for (int i = 0; i < PR; ++i) {
            const float pk = comp(p4[i], kk), sk = comp(s4[i], kk);
            acc_v[i][ch][0] = fmaf(pk, ov.x, acc_v[i][ch][0]);
            acc_v[i][ch][1] = fmaf(pk, ov.y, acc_v[i][ch][1]);
            acc_v[i][ch][2] = fmaf(pk, ov.z, acc_v[i][ch][2]);
            acc_v[i][ch][3] = fmaf(pk, ov.w, acc_v[i][ch][3]);
            acc_k[i][ch][0] = fmaf(sk, qv.x, acc_k[i][ch][0]);
            acc_k[i][ch][1] = fmaf(sk, qv.y, acc_k[i][ch][1]);
            acc_k[i][ch][2] = fmaf(sk, qv.z, acc_k[i][ch][2]);
            acc_k[i][ch][3] = fmaf(sk, qv.w, acc_k[i][ch][3]);
          }
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int kj = kw + vr + LR * i;
    if (kj >= S) continue;
    const size_t row = kv_off + static_cast<size_t>(kj) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col = 4 * vc + (HD / NCH) * ch;
      st4(dk + row + col, acc_k[i][ch][0], acc_k[i][ch][1], acc_k[i][ch][2],
          acc_k[i][ch][3]);
      st4(dv + row + col, acc_v[i][ch][0], acc_v[i][ch][1], acc_v[i][ch][2],
          acc_v[i][ch][3]);
    }
  }
}

// Warps per block: the most (8, 4, 2, 1) that still give at least one
// block per SM; grid.y counts key tiles.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int S,
                   float scale, int causal, cudaStream_t stream) {
  using L = Smem<T, HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kMaxWarps)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  int nw = kMaxWarps;
  long long tiles = 0;
  for (;; nw >>= 1) {
    tiles = (S + kRows * nw - 1) / (kRows * nw);
    if (nw == 1 || static_cast<long long>(B) * KVH * tiles >= sms) break;
  }
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * KVH, static_cast<unsigned>(tiles));
  flash_bwd_dkv_kernel<T, HD><<<grid, 32 * nw, L::bytes(nw), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, KVH, S, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------ tensor-core route

namespace tc {

using namespace hopper_tc;

constexpr int kBQ = 64;     // query rows per q tile
constexpr int kBK = 64;     // key rows per block (== kBQ: the causal skip
                            // assumes it)
constexpr int kNWG = 2;     // consumer warpgroups; item it goes to it % kNWG
constexpr int kStages = 4;  // Q/dO ring depth: two stages per warpgroup
// The producer is a whole warpgroup (one warp works) so that setmaxnreg
// can move registers: ptxas sizes the entry for 384 threads (168 each);
// the producer gives back to 40, the consumers take 232.
constexpr int kThreadsTC = (kNWG + 1) * 128;

template <int HD>
struct Layout {
  static constexpr int kTile = (HD / kChunkCols) * kChunkBytes;  // 64 x HD
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                 // [kStages]
  static constexpr int kdO = kQ + kStages * kTile;      // [kStages]
  static constexpr int kLse = kdO + kStages * kTile;    // [kStages][kBQ]
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kBar = kDelta + kStages * kBQ * 4;  // full, empty, kv
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
  // The second warpgroup's dK, dV partial sums, after the loop, over the
  // Q/dO stages: HD f32 per consumer thread.
  static_assert(128 * HD * 4 <= 2 * kStages * kTile, "reduction buffer");
};

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int H, int KVH, int S,
                        float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int bkv = blockIdx.x;  // grid.y walks key tiles: causal-heavy first
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * kBK;
  const int nq = (S + kBQ - 1) / kBQ;
  const int first_q = causal ? k0 / kBQ : 0;
  const int per_head = nq - first_q;
  const int n_it = group * per_head;  // (query head, q tile) items

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kNWG * 128) {
    // Producer warpgroup; its first warp works: lane 0 issues the TMA
    // copies; every lane copies two of the item's lse and delta values and
    // arrives on the stage's barrier, lane 0 with the bytes its copies
    // will bring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int lane = threadIdx.x - kNWG * 128;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * L::kTile);
      for (int c = 0; c < HD / kChunkCols; ++c) {
        tma_load_3d(smem + L::kK + c * kChunkBytes, &tk, kvbar,
                    c * kChunkCols, k0, bkv);
        tma_load_3d(smem + L::kV + c * kChunkBytes, &tv, kvbar,
                    c * kChunkCols, k0, bkv);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int bh = b * H + kvh * group + it / per_head;
      const int q0 = (first_q + it % per_head) * kBQ;
      if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
      for (int r = lane; r < kBQ; r += 32) {
        const int qi = q0 + r;
        const size_t g = static_cast<size_t>(bh) * S + qi;
        lse_s[s * kBQ + r] = qi < S ? lse[g] : 0.f;
        delta_s[s * kBQ + r] = qi < S ? delta[g] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        for (int c = 0; c < HD / kChunkCols; ++c) {
          tma_load_3d(smem + L::kQ + s * L::kTile + c * kChunkBytes, &tq,
                      &full[s], c * kChunkCols, q0, bh);
          tma_load_3d(smem + L::kdO + s * L::kTile + c * kChunkBytes, &tdo,
                      &full[s], c * kChunkCols, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumer warpgroup wg takes items wg, wg + kNWG, ...: key rows
    // k0 + row0 and k0 + row0 + 8; of every 8 query columns of a tile,
    // the two at col0 (hopper_tc.cuh, Fragments).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int row0 = (t / 32) * 16 + (t % 32) / 4;
    const int col0 = 2 * (t % 4);
    const uint32_t k_tile = smem_u32(smem + L::kK);
    const uint32_t v_tile = smem_u32(smem + L::kV);

    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = wg; it < n_it; it += kNWG) {
      const int s = it % kStages;
      const int q0 = (first_q + it % per_head) * kBQ;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t q_tile = smem_u32(smem + L::kQ + s * L::kTile);
      const uint32_t do_tile = smem_u32(smem + L::kdO + s * L::kTile);

      float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 queries
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(st, desc_kmajor(k_tile, kk),
                     desc_kmajor(q_tile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpt, desc_kmajor(v_tile, kk),
                     desc_kmajor(do_tile, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T into st, dS^T into dpt, by the rule K5 uses.
      const float* lse_t = lse_s + s * kBQ;
      const float* delta_t = delta_s + s * kBQ;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + col0 + (i & 1);
        const int kj = k0 + row0 + 8 * ((i >> 1) & 1);
        const float p = flash_bwd::bwd_visible(q0 + c, kj, S, causal)
                            ? flash_bwd::bwd_p(st[i], scale, lse_t[c])
                            : 0.f;
        dpt[i] = flash_bwd::bwd_ds(p, dpt[i], delta_t[c], scale);
        st[i] = p;
      }
      uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        a_fragment(st, kk, pa[kk]);
        a_fragment(dpt, kk, dsa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<HD>(acc_v, pa[kk], desc_mnmajor(do_tile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<HD>(acc_k, dsa[kk], desc_mnmajor(q_tile, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(&empty[s]);
    }

    // Sum the two warpgroups' partials in a fixed order (warpgroup 0 +
    // warpgroup 1) through shared memory: once both have left the loop,
    // every copy the producer issued has been consumed and the Q/dO stages
    // are free.
    float* red = reinterpret_cast<float*>(smem + L::kQ);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kNWG * 128) : "memory");
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        red[i * 128 + t] = acc_k[i];
        red[(HD / 2 + i) * 128 + t] = acc_v[i];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kNWG * 128) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        acc_k[i] += red[i * 128 + t];
        acc_v[i] += red[(HD / 2 + i) * 128 + t];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k0 + row0 + 8 * r;
        if (kj >= S) continue;
        const size_t row = (static_cast<size_t>(bkv) * S + kj) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + col0) =
              __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + col0) =
              __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
        }
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int S,
                   float scale, int causal, cudaStream_t stream) {
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
        flash_bwd_dkv_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(B * KVH, (S + kBK - 1) / kBK), block(kThreadsTC);
  flash_bwd_dkv_tc_kernel<HD><<<grid, block, L::kBytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, KVH, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

// The scalar instances: f32 at every D, bf16 at D 16 and 32 (bf16 at D
// 64 and 128 takes the tensor-core route).
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int KVH, int S, float scale, int causal,
                     cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 1000 + D) {
    case 16: return launch<float, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    case 32: return launch<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    case 64: return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    case 128: return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    case 1016: return launch<bf16, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    case 1032: return launch<bf16, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_bwd_dkv_route(int D, int dtype) {
  return hopper_tc::route(D, dtype);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int KVH, int S, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 ||
      B * KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hopper_tc::route(D, dtype)) {
    case hopper_tc::kRouteTensorCore:
      e = D == 64 ? tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   KVH, S, scale, causal, s)
                  : tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    KVH, S, scale, causal, s);
      break;
    case hopper_tc::kRouteScalar:
      e = dispatch(D, dtype, q, k, v, dout, lse, delta, dk, dv, B, H, KVH,
                   S, scale, causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
