// Decode attention for Hopper (sm_90a): the cached grouped-query product
// of a decode step, q against the KV cache up to each query's position.
//
// Replaces no Pallas kernel. It stands for the JAX package's pair of
// einsums at rocnrdma_tpu/models/llama.py:238-246 (Attention.__call__ with
// a cache): scores = q . k^T with bf16 operands and f32 sums
// (preferred_element_type=f32), / sqrt(hd), keys past each query's
// position at -inf, softmax in f32, the probabilities cast to the model
// dtype, then probs . v with f32 sums, cast back. The port's plain
// version (ops/decode_attention.py:cached_attention_reference) widened
// the whole cache to f32 for two f32 GEMMs; this kernel reads the cache
// as it is stored.
//
// Contract: q (B, H, s, hd) and k/v (B, KVH, T, hd) read through their
// strides (the last one 1, the others multiples of a 16-byte vector, the
// bases 16-byte aligned), bf16 or f32, one dtype; q_pos (s,) int64 the
// absolute position of each query; out (B, H, s, hd) contiguous in q's
// dtype. q head h reads kv head h / (H / KVH). Key j weighs in query i's
// row iff j <= q_pos[i].
//
// Bound on H100: bytes. Each live key costs 4 * hd flops per query head
// (rep of them per kv head) against 2 * hd * elt bytes of K and V: at
// rep 4 in bf16 that is 4 flops per byte, against a ridge of ~295 (~20
// for f32 on the CUDA cores). The floor is the live K/V read once,
// 2 * B * KVH * live * hd * elt / 3.35 TB/s (0.150 ms a layer at B 128,
// KVH 8, hd 128, ~960 live keys).
//
// Design against that bound:
//   - Grid (B * KVH, splits, row groups). A block of 128 threads holds 4
//     query rows of one kv head (the rep * s rows of its group, rep = 4
//     and s = 1 in decode), so it reads each K/V row once for all of
//     them. Splits cut the keys into equal ranges so that a small
//     B * KVH still fills the card; the wrapper picks their number from
//     B * KVH, T and the SM count (ops/decode_attention.py:decode_splits).
//   - Only live keys are read. Each block reads its rows' positions from
//     device memory and stops at max(q_pos) + 1, so one captured graph
//     (T = the whole cache) reads only the prefix in use at each replay;
//     a split past it reads nothing and writes the neutral partial
//     (m = -inf, l = 0).
//   - Bytes. hd / (16 / elt) lanes own one key row, each a 16-byte slice
//     of it, so a warp reads whole rows and neighbouring lane groups
//     neighbouring rows. A group takes 4 keys a step. The slices travel
//     by cp.async into two stages of shared memory, each lane into its
//     own slots, so the next step's copies run during this step's
//     arithmetic and no barrier is needed. That keeps registers at 128
//     and shared memory at 33 KB a block: 4 blocks (16 warps) an SM.
//     Nothing is widened in memory: bf16 turns into f32 in registers,
//     exactly (a shift).
//   - Products on the CUDA cores in f32 (fmaf): each lane's slice of
//     q . k, then a butterfly over the row's lanes, which leaves the same
//     sum in every lane. bf16 x bf16 products are exact in f32, so only
//     the summation order differs from the plain version's GEMM.
//   - Online softmax per lane group in f32, in log2 units (the scale
//     carries log2(e), and exp is exp2f): the running max moves once a
//     step of 4 keys at most; p is rounded to q's dtype before it meets
//     V (the plain version rounds after normalising), l sums the
//     unrounded p. Only a step that reaches past k1 or past some row's
//     position is masked. The block merges its groups in a fixed order
//     through shared memory (where the stages were); with one split it
//     writes out = o / l, otherwise (m, l, o) to scratch, and
//     decode_attn_combine merges the splits in split order. Every sum
//     runs in a fixed order, so two calls give the same bits.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// strides are int64 elements, dtype 0 = float32, 1 = bfloat16; part_o
// (rows, splits, hd) and part_ml (rows, splits, 2) are f32 scratch that
// the wrapper allocates (unused with one split); decode_attn returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;    // query rows a block holds
constexpr int kUnroll = 4;  // keys a lane group takes a step
// Blocks an SM holds at once (registers: 65536 / (128 * 4) = 128 a
// thread); ops/decode_attention.py:BLOCKS_PER_SM sizes the splits by it.
constexpr int kMinBlocks = 4;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte vector
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float round_p(float p) { return p; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // Element 2i is the low half of word i: widening is a shift.
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float round_p(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

// 16 bytes from device to shared memory, asynchronously (cp.async, L2
// only); with `valid` false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void decode_attn_copy(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Start the copies of this lane's K and V slices for keys base + u * G + g
// (u < kUnroll) into its own slots of one stage, zeros past `end`, as one
// cp.async group. A lane reads back only what it copied, so waiting for
// its own groups is enough: no barrier.
template <typename T, int G>
__device__ __forceinline__ void decode_attn_fetch(
    const T* kb, const T* vb, long long kst, long long vst, int base, int g,
    int end, uint4 (*ks)[kThreads], uint4 (*vs)[kThreads], int tid) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * G + g;
    const bool ok = j < end;
    decode_attn_copy(&ks[u][tid], ok ? kb + j * kst : kb, ok);
    decode_attn_copy(&vs[u][tid], ok ? vb + j * vst : vb, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One step of a lane group: keys base + u * G + g (u < kUnroll), whose K
// and V slices are in this lane's slots of ks, vs. Scores are in log2
// units (scale2 = log2(e) / sqrt(hd)), so p = 2^(s - m) is exp of the
// natural score less its max. MASK: some key of the step lies past k1 or
// past a row's position.
template <typename T, int N, int LPK, int G, bool MASK>
__device__ __forceinline__ void decode_attn_step(
    const uint4 (*ks)[kThreads], const uint4 (*vs)[kThreads], int tid,
    const float (&qf)[kRows][N], const long long* pos, int base, int g,
    int k1, float scale2, float* m, float* l, float (&o)[kRows][N]) {
  using V = Vec<T>;
  const float ninf = -INFINITY;
  float sc[kUnroll][kRows];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    float kf[N];
    V::load(ks[u][tid], kf);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) d = fmaf(qf[r][e], kf[e], d);
      sc[u][r] = d;
    }
  }
#pragma unroll
  for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * G + g;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      sc[u][r] *= scale2;
      if (MASK && !(j < k1 && j <= pos[r])) sc[u][r] = ninf;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float mx = sc[0][r];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][r]);
    if (mx > m[r]) {
      const float a = exp2f(m[r] - mx);
      l[r] *= a;
#pragma unroll
      for (int e = 0; e < N; ++e) o[r][e] *= a;
      m[r] = mx;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    float vf[N];
    V::load(vs[u][tid], vf);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p = exp2f(sc[u][r] - m[r]);
      if (MASK && sc[u][r] == ninf) p = 0.f;
      l[r] += p;
      const float pr = V::round_p(p);
#pragma unroll
      for (int e = 0; e < N; ++e) o[r][e] = fmaf(pr, vf[e], o[r][e]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attn_split(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int64_t* __restrict__ q_pos,
                  T* __restrict__ out, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int kvh, int rep, int s, int t,
                  int kps, long long qsb, long long qsh, long long qss,
                  long long ksb, long long ksh, long long kst, long long vsb,
                  long long vsh, long long vst, float scale2) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr int LPK = HD / N;         // lanes that share one key row
  constexpr int G = kThreads / LPK;   // key groups in the block
  constexpr int STEP = G * kUnroll;   // keys the block takes a step
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "lanes per key");
  const float ninf = -INFINITY;

  const int rows = rep * s;
  const int bk = blockIdx.x;
  const int b = bk / kvh, hk = bk % kvh;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, g = tid / LPK, li = tid % LPK;

  // This block's rows, their positions, and the keys any of them sees.
  long long pos[kRows];
  long long first = t, last = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    pos[r] = row < rows ? q_pos[row % s] : -1;
    last = pos[r] > last ? pos[r] : last;
    if (row < rows) first = pos[r] < first ? pos[r] : first;
  }
  const int live = static_cast<int>(last + 1 < t ? last + 1 : t);
  const int k0 = split * kps;
  const int k1 = k0 + kps < live ? k0 + kps : live;

  float qf[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row < rows) {
      const T* qr = q + b * qsb + (hk * rep + row / s) * qsh +
                    (row % s) * qss + li * N;
      V::load(__ldg(reinterpret_cast<const uint4*>(qr)), qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) qf[r][e] = 0.f;
    }
  }

  float m[kRows], l[kRows], o[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = ninf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) o[r][e] = 0.f;
  }

  const T* kb = k + b * ksb + hk * ksh + li * N;
  const T* vb = v + b * vsb + hk * vsh + li * N;
  // Keys below `full` are visible to every row of the block: their steps
  // need no mask.
  const int full = static_cast<int>(first + 1 < k1 ? first + 1 : k1);
  // Two stages of K/V slices, a lane's own slots in each: the next step's
  // copies run while this step computes.
  __shared__ __align__(16) uint4 stage[2][2][kUnroll][kThreads];
  if (k0 < k1)
    decode_attn_fetch<T, G>(kb, vb, kst, vst, k0, g, k1, stage[0][0],
                            stage[0][1], tid);
  int buf = 0;
  for (int base = k0; base < k1; base += STEP, buf ^= 1) {
    decode_attn_fetch<T, G>(kb, vb, kst, vst, base + STEP, g, k1,
                            stage[buf ^ 1][0], stage[buf ^ 1][1], tid);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    if (base + STEP <= full) {
      decode_attn_step<T, N, LPK, G, false>(stage[buf][0], stage[buf][1],
                                            tid, qf, pos, base, g, k1,
                                            scale2, m, l, o);
    } else {
      decode_attn_step<T, N, LPK, G, true>(stage[buf][0], stage[buf][1],
                                           tid, qf, pos, base, g, k1,
                                           scale2, m, l, o);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Merge the block's key groups, in group order; their outputs go where
  // the stages were.
  __shared__ float sm_m[G][kRows], sm_l[G][kRows];
  static_assert(sizeof(float) * G * kRows * HD <= sizeof(stage), "merge");
  float (*sm_o)[kRows][HD] = reinterpret_cast<float (*)[kRows][HD]>(stage);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (li == 0) {
      sm_m[g][r] = m[r];
      sm_l[g][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(&sm_o[g][r][li * N + e]) =
          make_float4(o[r][e], o[r][e + 1], o[r][e + 2], o[r][e + 3]);
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    if (row >= rows) continue;
    float mx = ninf;
    for (int gg = 0; gg < G; ++gg) mx = fmaxf(mx, sm_m[gg][r]);
    float lsum = 0.f, osum = 0.f;
    if (mx > ninf) {
      for (int gg = 0; gg < G; ++gg) {
        const float mg = sm_m[gg][r];
        if (mg > ninf) {
          const float w = exp2f(mg - mx);
          lsum = fmaf(w, sm_l[gg][r], lsum);
          osum = fmaf(w, sm_o[gg][r][d], osum);
        }
      }
    }
    const long long orow = static_cast<long long>(bk) * rows + row;
    if (nsplit == 1) {
      out[orow * HD + d] = V::from_f(osum / lsum);
    } else {
      const long long at = orow * nsplit + split;
      part_o[at * HD + d] = osum;
      if (d == 0) {
        part_ml[2 * at] = mx;
        part_ml[2 * at + 1] = lsum;
      }
    }
  }
}

// One block per output row (b, kv head, row of its group), one thread per
// element: the splits' partials merged in split order.
template <typename T>
__global__ void decode_attn_combine(const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, int nsplit, int hd) {
  const float ninf = -INFINITY;
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * row * nsplit;
  const float* po = part_o + row * nsplit * hd + d;
  float mx = ninf;
  for (int z = 0; z < nsplit; ++z) mx = fmaxf(mx, ml[2 * z]);
  float lsum = 0.f, osum = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float mz = ml[2 * z];
    if (mz > ninf) {
      const float w = exp2f(mz - mx);
      lsum = fmaf(w, ml[2 * z + 1], lsum);
      osum = fmaf(w, po[static_cast<long long>(z) * hd], osum);
    }
  }
  out[row * hd + d] = Vec<T>::from_f(osum / lsum);
}

struct Args {
  const void *q, *k, *v, *q_pos;
  void *out, *part_o, *part_ml;
  int b, kvh, rep, s, t, splits;
  long long qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst;
  float scale2;
};

template <typename T, int HD>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int G = kThreads / (HD / Vec<T>::N);
  constexpr int STEP = G * kUnroll;
  const int rows = a.rep * a.s;
  int kps = (a.t + a.splits - 1) / a.splits;
  kps = (kps + STEP - 1) / STEP * STEP;
  const dim3 grid(a.b * a.kvh, a.splits, (rows + kRows - 1) / kRows);
  decode_attn_split<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int64_t*>(a.q_pos),
      static_cast<T*>(a.out), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), a.kvh, a.rep, a.s, a.t, kps, a.qsb,
      a.qsh, a.qss, a.ksb, a.ksh, a.kst, a.vsb, a.vsh, a.vst, a.scale2);
  if (a.splits > 1) {
    decode_attn_combine<T><<<a.b * a.kvh * rows, HD, 0, stream>>>(
        static_cast<const float*>(a.part_o),
        static_cast<const float*>(a.part_ml), static_cast<T*>(a.out),
        a.splits, HD);
  }
}

template <typename T>
int dispatch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(a, stream); break;
    case 32: launch<T, 32>(a, stream); break;
    case 64: launch<T, 64>(a, stream); break;
    case 128: launch<T, 128>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* q_pos, void* out, void* part_o,
                           void* part_ml, int b, int kvh, int rep, int s,
                           int t, int hd, int splits, long long qsb,
                           long long qsh, long long qss, long long ksb,
                           long long ksh, long long kst, long long vsb,
                           long long vsh, long long vst, float scale2,
                           int dtype, void* stream) {
  const Args a{q, k, v, q_pos, out, part_o, part_ml, b, kvh, rep, s, t,
               splits, qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, scale2};
  const int n = dtype == 1 ? 8 : 4;
  const long long strides[9] = {qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst};
  bool ok = b > 0 && kvh > 0 && rep > 0 && s > 0 && t > 0 && splits > 0 &&
            splits <= 65535 && (dtype == 0 || dtype == 1) && aligned(q) &&
            aligned(k) && aligned(v) && aligned(out) &&
            (splits == 1 || (part_o != nullptr && part_ml != nullptr));
  for (long long st : strides) ok = ok && st % n == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(a, hd, st)
                    : dispatch<float>(a, hd, st);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
