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
// (flash_bwd_dkv_kernel): one block of 256 threads per (b, kv head, tile
// of 64 key rows), K and V in f32 shared memory for the whole block; for
// every query head of the group and every q tile from the diagonal on it
// loads Q, dO, lse and delta, rebuilds P and dS (softmax_grad_tile) and
// adds P^T dO into dV and dS^T Q into dK by scalar f32 FMA (full f32
// products, which the f32 card-vs-CPU parity needs), accumulators in f32
// registers, outputs written once.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// dtype 0 = float32, 1 = bfloat16; flash_bwd_dkv returns
// cudaGetLastError(), flash_bwd_dkv_route(D, dtype) the instance it
// launches (1 tensor core, 0 scalar, -1 refused).

#include "flash_bwd_common.cuh"
#include "hopper_tc.cuh"

namespace {

using namespace flash_bwd;

template <int HD>
constexpr int smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and delta.
  return 2 * kBK * (HD + 1) + 2 * kBQ * (HD + 1) + 2 * kBQ * (kBK + 1) +
         2 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KVH, int S, float scale,
                     int causal) {
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);       // [kBK][HD + 1]
  float* Qs = Vs + kBK * (HD + 1);       // [kBQ][HD + 1]
  float* dOs = Qs + kBQ * (HD + 1);      // [kBQ][HD + 1]
  float* Ps = dOs + kBQ * (HD + 1);      // [kBQ][kBK + 1]
  float* dSs = Ps + kBQ * (kBK + 1);     // [kBQ][kBK + 1]
  float* lse_s = dSs + kBQ * (kBK + 1);  // [kBQ]
  float* delta_s = lse_s + kBQ;          // [kBQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * kBK;

  const size_t kv_off = static_cast<size_t>(bkv) * S * HD;
  load_tile<T, HD>(Ks, k + kv_off, k0, kBK, S);
  load_tile<T, HD>(Vs, v + kv_off, k0, kBK, S);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (S + kBQ - 1) / kBQ;
  const int first_q = causal ? k0 / kBQ : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * H + kvh * group + gi;
    const size_t q_off = static_cast<size_t>(bh) * S * HD;
    for (int qt = first_q; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // previous tile's Q/dO/P/dS fully consumed
      load_tile<T, HD>(Qs, q + q_off, q0, kBQ, S);
      load_tile<T, HD>(dOs, dout + q_off, q0, kBQ, S);
      load_rows(lse_s, delta_s, lse + static_cast<size_t>(bh) * S,
                delta + static_cast<size_t>(bh) * S, q0, S);
      __syncthreads();
      softmax_grad_tile<HD>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, scale,
                            causal, Ps, dSs);
      __syncthreads();
      // dV[kc] += sum_r P[r][kc] * dO[r];  dK[kc] += sum_r dS[r][kc] * Q[r]
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * (kBK + 1) + ty + 16 * i];
          sv[i] = dSs[r * (kBK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dOs[r * (HD + 1) + tx + 16 * c];
          const float qv = Qs[r * (HD + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const size_t row = kv_off + static_cast<size_t>(kj) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = from_f<T>(acc_k[i][c]);
      dv[row + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KVH, int S,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBK - 1) / kBK, B * KVH), block(kThreads);
  flash_bwd_dkv_kernel<T, HD><<<grid, block, smem, stream>>>(
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

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int KVH, int S,
                     float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                           scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S,
                            scale, causal, s);
    default:
      return cudaErrorInvalidValue;
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
      e = dtype == 0
              ? dispatch<float>(D, q, k, v, dout, lse, delta, dk, dv, B, H,
                                KVH, S, scale, causal, s)
              : dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv,
                                        B, H, KVH, S, scale, causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
