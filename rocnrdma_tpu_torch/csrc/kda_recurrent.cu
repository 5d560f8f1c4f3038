// Kimi Delta Attention's short convolution and recurrence for Hopper
// (sm_90a): the gated delta rule over T tokens of each (sequence, head),
// from a state held in place, on q, k and v made from the raw projections.
//
// Replaces no Pallas kernel: the JAX package has no linear attention. It
// computes, for each sequence b, head h and token t in order, from the raw
// projections x (q's, k's and v's channels of the head) and the last
// K - 1 = 3 raw rows before them (conv_state):
//   y      = SiLU(sum_u w[u] x[t - 3 + u])        per channel, f32
//   q, k   = y_q / |y_q| * scale, y_k / |y_k|      (|.| with 1e-6 under the
//   v      = y_v                                    root), all f32
// and with the state S (128 x 128, f32; row i a key channel, column j a
// value channel), alpha = exp(g[b, t, h]) (128), beta = beta[b, t, h]:
//   S     <- Diag(alpha) S
//   u_j    = sum_i k_i S[i, j]
//   S[i,j] += k_i * beta * (v_j - u_j)
//   o_j    = sum_i q_i S[i, j]
// and leaves S and the last 3 raw rows in place for the next launch. The
// plain version is ops/kda.py:kda_reference.
//
// Contract: x (B, T, 3 * H * 128) contiguous bf16, q's channels first,
// then k's, then v's, head h's at h * 128; conv_w (3 * H * 128, 4)
// contiguous bf16, tap 3 on the current row; conv_state (B, 3, 3 * H * 128)
// contiguous bf16, oldest row first, read at the start and written at the
// end; g (B, T, H, 128) contiguous f32, the log of the decay; beta (B, T, H)
// contiguous f32; state (B, H, 128, 128) contiguous f32, read at the start
// and written at the end; out (B, T, H, 128) contiguous bf16. T may be 1
// (the graphed decode step) or a prompt's length (the eager prefill, one
// launch a row chunk, both states carried across launches).
//
// Bound on H100: a token and head cost 7 * 128 * 128 operations (the
// decay, u, the rank-1 update, o) against 1,540 bytes of its own (x's 384
// channels and o in bf16, g and beta in f32) and the state's 128 KB read
// and written once a launch. At T = 1 (a decode step) the state is the
// floor: 2 * 64 KB a (sequence, head) over 3.35 TB/s. Over a prompt the
// work is a chain of T dependent steps a (sequence, head), on the f32 CUDA
// cores.
//
// Design against that bound:
//   - Every column j of S is independent of the others (u_j, the update
//     and o_j read column j alone), so a block of 256 threads holds one
//     (sequence, head)'s state, lanes 2j and 2j + 1 owning column j's rows
//     0-63 and 64-127: 64 f32 registers a thread (a thread a whole column
//     needs 128 and spills), and the two halves of u_j and o_j meet by
//     one shuffle, added rows 0-63 first in both lanes. The state is read
//     once into registers and written once at the end.
//   - Tokens go in chunks of kChunk. The block loads the chunk's raw rows
//     of the head (every load in flight at once) and the taps into shared
//     memory; threads 0-127 convolve q's and k's channel of their index,
//     threads 128-255 v's, each carrying its channels' last 3 raw inputs
//     in registers from chunk to chunk, and write q, k, alpha = exp(g)
//     and v as f32 rows in shared memory, a warp a row's sum of squares
//     for the l2norms. The recurrence reads q, k and alpha as float4s that
//     a warp's lanes share (the second half of a row 4 floats on, off the
//     first half's banks). ~53 KB of dynamic shared memory and registers
//     capped to fit two blocks an SM.
//   - u and o are summed over i in four interleaved partial sums (fixed
//     order), which breaks the chain of dependent adds.
//   - Grid (H, B): any B, one launch on the caller's stream that a CUDA
//     graph captures; no scratch, no atomics.
//
// C interface (bound with ctypes): pointers and the stream are void*;
// kda_recurrent returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;              // key and value channels of a head
constexpr int kHalf = kDim / 2;        // state rows a thread holds
constexpr int kChunk = 16;             // tokens staged a round
constexpr int kThreads = 2 * kDim;     // two threads a column
constexpr int kRow = kDim + 4;         // staged row: halves 4 floats apart
constexpr int kTaps = 4;               // the short convolution's width
constexpr int kCh = 3 * kDim;          // a head's q, k and v channels
constexpr float kL2Eps = 1e-6f;        // l2norm's epsilon under the root
// Blocks an SM holds at once: the registers a thread are capped to fit
// two (the state's 64 and the recurrence's partial sums).
constexpr int kMinBlocks = 2;

// Dynamic shared memory: q, k and alpha rows (f32, padded), v rows (f32),
// the chunk's raw rows (bf16), the taps (f32), beta and the l2norms.
constexpr int kSmemQKA = 3 * kChunk * kRow * 4;
constexpr int kSmemV = kChunk * kDim * 4;
constexpr int kSmemX = kChunk * kCh * 2;
constexpr int kSmemW = kCh * kTaps * 4;
constexpr int kSmem = kSmemQKA + kSmemV + kSmemX + kSmemW + kChunk * 4 +
                      kChunk * 2 * 4;

__device__ __forceinline__ float silu(float y) {
  return y / (1.f + expf(-y));
}

// Where channel c of a staged q, k or alpha row lives.
__device__ __forceinline__ int staged(int c) {
  return c + (c >= kHalf ? 4 : 0);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
kda_recurrent_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ conv_w,
                     __nv_bfloat16* __restrict__ conv_state,
                     const float* __restrict__ g,
                     const float* __restrict__ beta,
                     float* __restrict__ state,
                     __nv_bfloat16* __restrict__ out, int t_len, int heads,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*sq)[kRow] = reinterpret_cast<float (*)[kRow]>(smem);
  float (*sk)[kRow] = sq + kChunk;
  float (*sa)[kRow] = sk + kChunk;
  float (*sv)[kDim] = reinterpret_cast<float (*)[kDim]>(smem + kSmemQKA);
  __nv_bfloat16 (*sx)[kCh] = reinterpret_cast<__nv_bfloat16 (*)[kCh]>(
      smem + kSmemQKA + kSmemV);
  float (*sw)[kTaps] = reinterpret_cast<float (*)[kTaps]>(
      smem + kSmemQKA + kSmemV + kSmemX);
  float* sb = reinterpret_cast<float*>(smem + kSmemQKA + kSmemV + kSmemX +
                                       kSmemW);
  float (*srn)[2] = reinterpret_cast<float (*)[2]>(sb + kChunk);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // Lanes 2j and 2j + 1 hold column j, rows 0-63 and 64-127.
  const int j = tid >> 1, half = tid & 1;
  const long long bh = static_cast<long long>(b) * heads + h;
  float* st = state + (bh * kDim + half * kHalf) * kDim + j;
  float s[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) s[i] = st[i * kDim];

  // A head's channel l of kCh (q's 0-127, k's 128-255, v's 256-383) is
  // channel (l / 128) * H * 128 + h * 128 + l % 128 of a raw row.
  const int c_all = heads * kDim, row3 = 3 * c_all;
  for (int l = tid; l < kCh; l += kThreads) {
    const int ch = (l / kDim) * c_all + h * kDim + l % kDim;
#pragma unroll
    for (int u = 0; u < kTaps; ++u)
      sw[l][u] = __bfloat162float(conv_w[ch * kTaps + u]);
  }
  // The convolution: threads 0-127 take q's and k's channel tid, threads
  // 128-255 v's channel tid - 128, each carrying its channels' last
  // kTaps - 1 raw inputs (from conv_state at the start).
  const int col = tid % kDim;
  const bool qk = tid < kDim;
  const int l0 = qk ? col : 2 * kDim + col, l1 = kDim + col;
  const int ch0 = (qk ? 0 : 2 * c_all) + h * kDim + col;
  const int ch1 = c_all + h * kDim + col;
  __nv_bfloat16* cs = conv_state + static_cast<long long>(b) * (kTaps - 1) *
                                       row3;
  float p0[kTaps - 1], p1[kTaps - 1];
#pragma unroll
  for (int r = 0; r < kTaps - 1; ++r) {
    p0[r] = __bfloat162float(cs[r * row3 + ch0]);
    p1[r] = qk ? __bfloat162float(cs[r * row3 + ch1]) : 0.f;
  }

  const __nv_bfloat16* xb = x + static_cast<long long>(b) * t_len * row3;
  // Token t of this (b, h) in g and out starts at ((b * T + t) * H + h) * 128.
  const long long tok_stride = static_cast<long long>(heads) * kDim;
  const long long base = (static_cast<long long>(b) * t_len * heads + h) *
                         kDim;
  const int mine = half * (kHalf + 4);
  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    __syncthreads();
    // The chunk's raw rows of this head, every load in flight at once.
    for (int i = tid; i < n * kCh; i += kThreads) {
      const int c = i / kCh, l = i % kCh;
      sx[c][l] = xb[static_cast<long long>(t0 + c) * row3 +
                    (l / kDim) * c_all + h * kDim + l % kDim];
    }
    if (qk) {
      for (int c = 0; c < n; ++c)
        sa[c][staged(col)] = expf(g[base + (t0 + c) * tok_stride + col]);
    } else if (col < n) {
      sb[col] = beta[(static_cast<long long>(b) * t_len + t0 + col) * heads +
                     h];
    }
    __syncthreads();
    // SiLU(conv) of the chunk's tokens.
    for (int c = 0; c < n; ++c) {
      const float r0 = __bfloat162float(sx[c][l0]);
      float y0 = sw[l0][kTaps - 1] * r0;
#pragma unroll
      for (int u = 0; u < kTaps - 1; ++u) y0 = fmaf(sw[l0][u], p0[u], y0);
#pragma unroll
      for (int u = 0; u < kTaps - 2; ++u) p0[u] = p0[u + 1];
      p0[kTaps - 2] = r0;
      if (qk) {
        const float r1 = __bfloat162float(sx[c][l1]);
        float y1 = sw[l1][kTaps - 1] * r1;
#pragma unroll
        for (int u = 0; u < kTaps - 1; ++u) y1 = fmaf(sw[l1][u], p1[u], y1);
#pragma unroll
        for (int u = 0; u < kTaps - 2; ++u) p1[u] = p1[u + 1];
        p1[kTaps - 2] = r1;
        sq[c][staged(col)] = silu(y0);
        sk[c][staged(col)] = silu(y1);
      } else {
        sv[c][col] = silu(y0);
      }
    }
    __syncthreads();
    // l2norm of q and k: warp w takes rows (token, q or k) w, w + 8, ...
    for (int r = warp; r < 2 * n; r += kThreads / 32) {
      const float* row = (r & 1) ? sk[r >> 1] : sq[r >> 1];
      float ss = 0.f;
#pragma unroll
      for (int u = 0; u < kDim / 32; ++u) {
        const float v = row[staged(lane + 32 * u)];
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) srn[r >> 1][r & 1] = rsqrtf(ss + kL2Eps);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      if (qk)
        sq[c][staged(col)] *= srn[c][0] * scale;
      else
        sk[c][staged(col)] *= srn[c][1];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const long long at = base + (t0 + c) * tok_stride + j;
      const float vj = sv[c][j];
      const float4* a4 = reinterpret_cast<const float4*>(sa[c] + mine);
      const float4* k4 = reinterpret_cast<const float4*>(sk[c] + mine);
      const float4* q4 = reinterpret_cast<const float4*>(sq[c] + mine);
      float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; i += 4) {
        const float4 a = a4[i / 4], kk = k4[i / 4];
        s[i] *= a.x;
        s[i + 1] *= a.y;
        s[i + 2] *= a.z;
        s[i + 3] *= a.w;
        u0 = fmaf(kk.x, s[i], u0);
        u1 = fmaf(kk.y, s[i + 1], u1);
        u2 = fmaf(kk.z, s[i + 2], u2);
        u3 = fmaf(kk.w, s[i + 3], u3);
      }
      float u = (u0 + u1) + (u2 + u3);
      // Both halves of the column hold the same sum, rows 0-63 first.
      const float other = __shfl_xor_sync(0xffffffffu, u, 1);
      u = half ? other + u : u + other;
      const float delta = sb[c] * (vj - u);
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; i += 4) {
        const float4 kk = k4[i / 4], qq = q4[i / 4];
        s[i] = fmaf(kk.x, delta, s[i]);
        s[i + 1] = fmaf(kk.y, delta, s[i + 1]);
        s[i + 2] = fmaf(kk.z, delta, s[i + 2]);
        s[i + 3] = fmaf(kk.w, delta, s[i + 3]);
        o0 = fmaf(qq.x, s[i], o0);
        o1 = fmaf(qq.y, s[i + 1], o1);
        o2 = fmaf(qq.z, s[i + 2], o2);
        o3 = fmaf(qq.w, s[i + 3], o3);
      }
      float o = (o0 + o1) + (o2 + o3);
      const float o_other = __shfl_xor_sync(0xffffffffu, o, 1);
      if (!half) out[at] = __float2bfloat16_rn(o + o_other);
    }
  }
#pragma unroll
  for (int i = 0; i < kHalf; ++i) st[i * kDim] = s[i];
  // The raw inputs the next launch's first tokens reach back to.
#pragma unroll
  for (int r = 0; r < kTaps - 1; ++r) {
    cs[r * row3 + ch0] = __float2bfloat16_rn(p0[r]);
    if (qk) cs[r * row3 + ch1] = __float2bfloat16_rn(p1[r]);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int kda_recurrent(const void* x, const void* conv_w,
                             void* conv_state, const void* g,
                             const void* beta, void* state, void* out, int b,
                             int t, int heads, int dim, float scale,
                             void* stream) {
  if (b <= 0 || b > 65535 || t <= 0 || heads <= 0 || dim != kDim ||
      !aligned(state) || !aligned(g))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kda_recurrent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kda_recurrent_kernel<<<dim3(heads, b), kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(conv_w),
      static_cast<__nv_bfloat16*>(conv_state), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<float*>(state),
      static_cast<__nv_bfloat16*>(out), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
