// The expert layer's combine for Hopper (sm_90a): each token's top_k
// picked rows of the down GEMM's output summed, plus the shared experts'.
//
// Replaces no Pallas kernel: the JAX package has no experts. It stands
// for the torch loop that followed the grouped GEMMs (ops/moe.py,
// combine_reference): per pick an index_select of the picked rows, a
// bf16 -> f32 copy and an f32 add, the sum rounded to bf16, then
// `routed + shared` in bf16. Each of those was a pass over device memory
// (~17 GB in a 62,400-token prefill chunk at d 2048), and in the graphed
// decode step each was a launch of its own (19 an expert layer).
//
// Contract: out (rows, d) bf16, the down GEMM's padded rows, its rows
// `out_stride` elements apart; dest (n, k) int64 contiguous, each pick's
// row of out (ops/moe.py:align), or -1 for a pick of an expert another
// card holds, which reads as a row of zeros (+0.0 in f32, so it adds
// nothing); add (n, d) bf16 contiguous or null;
// res (n, d) bf16 contiguous. For each token t and column c:
//   acc = f32(out[dest[t, 0], c]); acc += f32(out[dest[t, j], c]), j = 1..k-1
//   r = bf16(acc)                             (round to nearest even, once)
//   res[t, c] = add ? bf16(f32(r) + f32(add[t, c])) : r
// which is bitwise the torch loop: the adds are plain f32 adds in pick
// order (no multiply, so nothing contracts into an FMA), and torch adds
// two bf16 tensors in f32 and rounds once.
//
// Bound on H100: bytes. Each token reads its k picked rows, the shared
// row and its k indices once and writes one row:
// n * (k * d * 2 + 2 * d * 2 + k * 8) bytes against n * d * k adds.
// 2.05 GB, 0.61 ms at 3.35 TB/s, for a 62,400-token chunk at k 6, d 2048.
//
// Design against that bound:
//   - A thread owns one 16-byte vector (8 columns) of one token: it reads
//     the token's k indices, then issues all k 16-byte loads before any
//     add, so their latencies overlap. A block of 128 threads covers 1024
//     columns of one token, whole 16-byte-aligned row segments, so a
//     warp reads 512 contiguous bytes of each picked row. Grid (n, d /
//     1024 rounded up): the tokens in x, which takes any n.
//   - k is a template argument (1-8): the loads unroll into registers.
//   - No shared memory, no atomics, no scratch: one launch on the
//     caller's stream that a CUDA graph captures.
//
// C interface (bound with ctypes): pointers and the stream are void*;
// moe_combine returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // bf16 columns a 16-byte vector
constexpr int kMaxPicks = 8;

// Element 2i is the low half of word i: widening is a shift, exact.
__device__ __forceinline__ void widen(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const __nv_bfloat16* __restrict__ out,
                   const int64_t* __restrict__ dest,
                   const __nv_bfloat16* __restrict__ add,
                   __nv_bfloat16* __restrict__ res, int d,
                   long long out_stride) {
  const long long t = blockIdx.x;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  if (col >= d) return;
  int64_t rows[K];
#pragma unroll
  for (int j = 0; j < K; ++j) rows[j] = dest[t * K + j];
  uint4 v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = rows[j] >= 0 ? *reinterpret_cast<const uint4*>(
                              out + rows[j] * out_stride + col)
                        : make_uint4(0, 0, 0, 0);
  }
  uint4 s = make_uint4(0, 0, 0, 0);
  if (add != nullptr) {
    s = *reinterpret_cast<const uint4*>(add + t * d + col);
  }
  float acc[kVec], p[kVec];
  widen(v[0], acc);
#pragma unroll
  for (int j = 1; j < K; ++j) {
    widen(v[j], p);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
  }
  uint4 r = make_uint4(pack(acc[0], acc[1]), pack(acc[2], acc[3]),
                       pack(acc[4], acc[5]), pack(acc[6], acc[7]));
  if (add != nullptr) {
    widen(r, acc);
    widen(s, p);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
    r = make_uint4(pack(acc[0], acc[1]), pack(acc[2], acc[3]),
                   pack(acc[4], acc[5]), pack(acc[6], acc[7]));
  }
  *reinterpret_cast<uint4*>(res + t * d + col) = r;
}

template <int K>
void launch(const void* out, const void* dest, const void* add, void* res,
            int n, int d, long long out_stride, cudaStream_t st) {
  const dim3 grid(n, (d / kVec + kThreads - 1) / kThreads);
  moe_combine_kernel<K><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const int64_t*>(dest),
      static_cast<const __nv_bfloat16*>(add),
      static_cast<__nv_bfloat16*>(res), d, out_stride);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int moe_combine(const void* out, const void* dest, const void* add,
                           void* res, int n, int k, int d,
                           long long out_stride, void* stream) {
  const bool ok = n > 0 && k >= 1 && k <= kMaxPicks && d > 0 &&
                  d % kVec == 0 && out_stride % kVec == 0 && aligned(out) &&
                  aligned(res) && (add == nullptr || aligned(add)) &&
                  dest != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(out, dest, add, res, n, d, out_stride, st); break;
    case 2: launch<2>(out, dest, add, res, n, d, out_stride, st); break;
    case 3: launch<3>(out, dest, add, res, n, d, out_stride, st); break;
    case 4: launch<4>(out, dest, add, res, n, d, out_stride, st); break;
    case 5: launch<5>(out, dest, add, res, n, d, out_stride, st); break;
    case 6: launch<6>(out, dest, add, res, n, d, out_stride, st); break;
    case 7: launch<7>(out, dest, add, res, n, d, out_stride, st); break;
    case 8: launch<8>(out, dest, add, res, n, d, out_stride, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
