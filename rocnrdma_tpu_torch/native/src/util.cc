// Socket plumbing + thread-local error slot.
#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdlib>
#include <thread>

#include "common.h"

namespace tdr {

static thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }
const char *get_error() { return g_error.c_str(); }

bool env_set(const char *name) {
  const char *env = getenv(name);
  return env && *env && *env != '0';
}

int ring_timeout_ms() {
  const char *env = getenv("TDR_RING_TIMEOUT_MS");
  if (env && *env) {
    long long v = atoll(env);
    if (v >= 100) return static_cast<int>(v);
  }
  return 30000;
}

int coll_deadline_ms() {
  const char *env = getenv("TDR_COLL_DEADLINE_MS");
  if (env && *env) {
    long long v = atoll(env);
    if (v >= 1 && v <= 86400000) return static_cast<int>(v);
  }
  return 0;
}

uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer (Steele/Lea/Flood) — the shared deterministic
  // jitter mix for netem delay and NAK backoff.
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

uint32_t local_features() {
  uint32_t f = 0;
  if (!env_set("TDR_NO_FOLDBACK") && !env_set("TDR_NO_FUSED2"))
    f |= FEAT_FOLDBACK;
  if (!env_set("TDR_NO_FUSED2")) f |= FEAT_FUSED2;
  if (!env_set("TDR_NO_SEAL")) f |= FEAT_SEAL;
  // Full payload CRC on the CMA tier is an OPT-IN (tests forcing the
  // whole detect→NAK→retransmit ladder over same-host worlds); the
  // default there seals the tag only — see FEAT_SEAL_CMA_FULL.
  if (env_set("TDR_SEAL_CMA")) f |= FEAT_SEAL_CMA_FULL;
  // Wire-carried collective trace ids ride only when this rank is
  // recording: with telemetry off the advertisement — and with it the
  // frame-header extension — vanishes, keeping frames byte-identical
  // to the pre-trace-id format (the one-branch-guard contract's wire
  // counterpart).
  if (tel_on()) f |= FEAT_COLL_ID;
  // Hung-peer probe frames (OP_PING/OP_PONG): on by default — a probe
  // is observational and its frames appear only when the stall
  // escalation path asks for them — but TDR_NO_PROBE drops the
  // advertisement so legacy-wire tests can pin byte-identical frames.
  if (!env_set("TDR_NO_PROBE")) f |= FEAT_PROBE;
  // int8 wire compression: on by default (the quantized pieces are
  // ordinary sealed SENDs, so advertising costs nothing on the wire);
  // TDR_NO_WIRE_Q8 drops it so byte-neutrality tests can pin that the
  // feature-off wire is identical and the q8 schedule refuses to run.
  if (!env_set("TDR_NO_WIRE_Q8")) f |= FEAT_WIRE_Q8;
  return f;
}

int seal_retry_budget() {
  const char *env = getenv("TDR_SEAL_RETRY");
  if (env && *env) {
    long long v = atoll(env);
    if (v >= 0 && v <= 100) return static_cast<int>(v);
  }
  return 3;
}

// ------------------------------------------------------------------
// CRC32C — the seal's checksum. Hardware path rides the SSE4.2 crc32
// instruction when the build enables it (TUNE=native does on any
// modern x86); the software path is a standard reflected-0x82F63B78
// byte table, bit-identical to the hardware result.

#if !defined(__SSE4_2__)
namespace {

const uint32_t *crc32c_table() {
  static const uint32_t *table = [] {
    static uint32_t t[256];
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  return table;
}

}  // namespace
#endif

uint32_t crc32c(const void *data, size_t len, uint32_t seed) {
  const unsigned char *p = static_cast<const unsigned char *>(data);
  uint32_t crc = ~seed;
#if defined(__SSE4_2__)
  while (len >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    crc = static_cast<uint32_t>(__builtin_ia32_crc32di(crc, v));
    p += 8;
    len -= 8;
  }
  while (len > 0) {
    crc = __builtin_ia32_crc32qi(crc, *p++);
    len--;
  }
#else
  const uint32_t *t = crc32c_table();
  while (len > 0) {
    crc = t[(crc ^ *p++) & 0xff] ^ (crc >> 8);
    len--;
  }
#endif
  return ~crc;
}

// Integrity counters: process-wide like the fault-plan counters (all
// QPs share them), so a test can assert the whole detect→retransmit
// path fired without threading handles around.
static std::atomic<uint64_t> g_seal_counters[4];

void seal_count(int which) {
  if (which >= 0 && which < 4)
    g_seal_counters[which].fetch_add(1, std::memory_order_relaxed);
}

uint64_t seal_counter(int which) {
  return (which >= 0 && which < 4)
             ? g_seal_counters[which].load(std::memory_order_relaxed)
             : 0;
}

void seal_counters_reset() {
  for (auto &c : g_seal_counters) c.store(0, std::memory_order_relaxed);
}

// Hung-peer probe counters: same process-wide discipline as the seal
// counters — the health ladder reads them through the registry.
static std::atomic<uint64_t> g_probe_counters[3];

void probe_count(int which) {
  if (which >= 0 && which < 3)
    g_probe_counters[which].fetch_add(1, std::memory_order_relaxed);
}

uint64_t probe_counter(int which) {
  return (which >= 0 && which < 3)
             ? g_probe_counters[which].load(std::memory_order_relaxed)
             : 0;
}

size_t dtype_size(int dt) {
  switch (dt) {
    case TDR_DT_F32:
    case TDR_DT_I32:
      return 4;
    case TDR_DT_F64:
    case TDR_DT_I64:
      return 8;
    case TDR_DT_BF16:
      return 2;
    case TDR_DT_U8:
    case TDR_DT_I8:
      return 1;
    default:
      return 0;
  }
}

// ------------------------------------------------------------------
// Vectorized f32 sum — the fold kernel the ring's phase-1 reduction
// spends most of its ALU time in. ISA-guarded explicitly (AVX → SSE →
// scalar) instead of trusting autovectorization: the scratch-window
// fold now runs on dedicated fold workers where a scalar loop would
// make the offload pointless. Element-wise float adds, so the result
// is bitwise identical to the scalar loop regardless of the path.

namespace {

void sum_f32(float *dst, const float *src, size_t n) {
  size_t i = 0;
#if defined(__AVX__)
  for (; i + 8 <= n; i += 8)
    _mm256_storeu_ps(dst + i,
                     _mm256_add_ps(_mm256_loadu_ps(dst + i),
                                   _mm256_loadu_ps(src + i)));
#elif defined(__SSE__)
  for (; i + 4 <= n; i += 4)
    _mm_storeu_ps(dst + i,
                  _mm_add_ps(_mm_loadu_ps(dst + i), _mm_loadu_ps(src + i)));
#endif
  for (; i < n; i++) dst[i] += src[i];
}

}  // namespace

namespace {

float bf16_to_f32(uint16_t v) {
  uint32_t u = static_cast<uint32_t>(v) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

uint16_t f32_to_bf16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  // round-to-nearest-even, matching TPU bf16 semantics
  uint32_t rounding = 0x7fff + ((u >> 16) & 1);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

template <typename T>
void reduce_typed(T *dst, const T *src, size_t n, int op) {
  switch (op) {
    case TDR_RED_SUM:
      for (size_t i = 0; i < n; i++) dst[i] += src[i];
      break;
    case TDR_RED_MAX:
      for (size_t i = 0; i < n; i++)
        if (src[i] > dst[i]) dst[i] = src[i];
      break;
    case TDR_RED_MIN:
      for (size_t i = 0; i < n; i++)
        if (src[i] < dst[i]) dst[i] = src[i];
      break;
  }
}

// Op as a template parameter keeps the inner loop branch-free so the
// compiler can vectorize the convert-accumulate-convert pipeline.
template <int kOp>
void reduce_bf16_op(uint16_t *dst, const uint16_t *src, size_t n) {
  for (size_t i = 0; i < n; i++) {
    float a = bf16_to_f32(dst[i]), b = bf16_to_f32(src[i]);
    float r;
    if (kOp == TDR_RED_SUM)
      r = a + b;
    else if (kOp == TDR_RED_MAX)
      r = b > a ? b : a;
    else
      r = b < a ? b : a;
    dst[i] = f32_to_bf16(r);
  }
}

void reduce_bf16(uint16_t *dst, const uint16_t *src, size_t n, int op) {
  switch (op) {
    case TDR_RED_SUM:
      reduce_bf16_op<TDR_RED_SUM>(dst, src, n);
      break;
    case TDR_RED_MAX:
      reduce_bf16_op<TDR_RED_MAX>(dst, src, n);
      break;
    case TDR_RED_MIN:
      reduce_bf16_op<TDR_RED_MIN>(dst, src, n);
      break;
  }
}

}  // namespace

namespace {

// Fused exchange fold: r = d op s, stored to BOTH d and s in the same
// pass (the element was just loaded, so both lines are cache-resident
// and the second store costs no extra DRAM read). Both sides end with
// bit-identical results — for bf16 the rounding happens once.
template <typename T>
void reduce2_typed(T *d, T *s, size_t n, int op) {
  switch (op) {
    case TDR_RED_SUM:
      for (size_t i = 0; i < n; i++) {
        T v = d[i] + s[i];
        d[i] = v;
        s[i] = v;
      }
      break;
    case TDR_RED_MAX:
      for (size_t i = 0; i < n; i++) {
        T v = s[i] > d[i] ? s[i] : d[i];
        d[i] = v;
        s[i] = v;
      }
      break;
    case TDR_RED_MIN:
      for (size_t i = 0; i < n; i++) {
        T v = s[i] < d[i] ? s[i] : d[i];
        d[i] = v;
        s[i] = v;
      }
      break;
  }
}

template <int kOp>
void reduce2_bf16_op(uint16_t *d, uint16_t *s, size_t n) {
  for (size_t i = 0; i < n; i++) {
    float a = bf16_to_f32(d[i]), b = bf16_to_f32(s[i]);
    float r;
    if (kOp == TDR_RED_SUM)
      r = a + b;
    else if (kOp == TDR_RED_MAX)
      r = b > a ? b : a;
    else
      r = b < a ? b : a;
    uint16_t v = f32_to_bf16(r);
    d[i] = v;
    s[i] = v;
  }
}

void reduce2_bf16(uint16_t *d, uint16_t *s, size_t n, int op) {
  switch (op) {
    case TDR_RED_SUM:
      reduce2_bf16_op<TDR_RED_SUM>(d, s, n);
      break;
    case TDR_RED_MAX:
      reduce2_bf16_op<TDR_RED_MAX>(d, s, n);
      break;
    case TDR_RED_MIN:
      reduce2_bf16_op<TDR_RED_MIN>(d, s, n);
      break;
  }
}

}  // namespace

void reduce2_any(void *dst, void *src, size_t n, int dt, int op) {
  switch (dt) {
    case TDR_DT_F32:
      reduce2_typed(static_cast<float *>(dst), static_cast<float *>(src), n,
                    op);
      break;
    case TDR_DT_F64:
      reduce2_typed(static_cast<double *>(dst), static_cast<double *>(src), n,
                    op);
      break;
    case TDR_DT_I32:
      reduce2_typed(static_cast<int32_t *>(dst), static_cast<int32_t *>(src),
                    n, op);
      break;
    case TDR_DT_I64:
      reduce2_typed(static_cast<int64_t *>(dst), static_cast<int64_t *>(src),
                    n, op);
      break;
    case TDR_DT_BF16:
      reduce2_bf16(static_cast<uint16_t *>(dst),
                   static_cast<uint16_t *>(src), n, op);
      break;
  }
}

void reduce_any(void *dst, const void *src, size_t n, int dt, int op) {
  switch (dt) {
    case TDR_DT_F32:
      if (op == TDR_RED_SUM) {
        sum_f32(static_cast<float *>(dst), static_cast<const float *>(src),
                n);
        break;
      }
      reduce_typed(static_cast<float *>(dst), static_cast<const float *>(src),
                   n, op);
      break;
    case TDR_DT_F64:
      reduce_typed(static_cast<double *>(dst),
                   static_cast<const double *>(src), n, op);
      break;
    case TDR_DT_I32:
      reduce_typed(static_cast<int32_t *>(dst),
                   static_cast<const int32_t *>(src), n, op);
      break;
    case TDR_DT_I64:
      reduce_typed(static_cast<int64_t *>(dst),
                   static_cast<const int64_t *>(src), n, op);
      break;
    case TDR_DT_BF16:
      reduce_bf16(static_cast<uint16_t *>(dst),
                  static_cast<const uint16_t *>(src), n, op);
      break;
  }
}

// ------------------------------------------------------------------
// int8 wire-compression kernels — the q8 schedule's counterparts of
// the bf16 fold above. The fold is a REQUANTIZING dequant-fold: both
// operands are dequantized under their own symmetric scales, summed
// in f32, and requantized under the SUMMED scale s_l + s_f. Because
// |s_l*q_l + s_f*q_f| <= (s_l + s_f) * 127, the requantized magnitude
// never exceeds 127 at any hop of the ring — no clipping, so the
// per-rank error-feedback residual stays the only loss the trainer
// has to absorb (plus one bounded rounding per hop, the bf16
// schedule's round-per-fold analogue).

void fold_q8(int8_t *q_l, float s_l, const int8_t *q_f, float s_f,
             size_t n) {
  float s_n = s_l + s_f;
  if (s_n == 0.0f) {
    // Both buckets all-zero (absmax 0 on every contributing rank).
    memset(q_l, 0, n);
    return;
  }
  float inv = 1.0f / s_n;
  for (size_t i = 0; i < n; i++) {
    float v = (s_l * static_cast<float>(q_l[i]) +
               s_f * static_cast<float>(q_f[i])) *
              inv;
    long r = lrintf(v);
    // Mathematically |r| <= 127; the clamp only guards fp-rounding at
    // the boundary.
    if (r > 127) r = 127;
    if (r < -127) r = -127;
    q_l[i] = static_cast<int8_t>(r);
  }
}

void dequant_q8(float *out, const int8_t *q, size_t n, float scale) {
  for (size_t i = 0; i < n; i++)
    out[i] = static_cast<float>(q[i]) * scale;
}

void tune_socket(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int buf = 8 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
}

static bool make_addr(const char *host, int port, sockaddr_in *out,
                      std::string *err) {
  memset(out, 0, sizeof(*out));
  out->sin_family = AF_INET;
  out->sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &out->sin_addr) != 1) {
    if (err) *err = std::string("bad IPv4 address: ") + host;
    return false;
  }
  return true;
}

int tcp_listen_accept(const char *bind_host, int port, std::string *err,
                      int timeout_ms) {
  sockaddr_in addr;
  if (!make_addr(bind_host, port, &addr, err)) return -1;
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) {
    if (err) *err = std::string("socket: ") + strerror(errno);
    return -1;
  }
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (bind(lfd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) < 0 ||
      ::listen(lfd, 1) < 0) {
    if (err) *err = std::string("bind/listen: ") + strerror(errno);
    close(lfd);
    return -1;
  }
  if (timeout_ms >= 0) {
    // Bounded accept: a rendezvous whose peer never arrives must
    // return (releasing the port for the next attempt), not strand a
    // thread in accept holding the listener open.
    pollfd pfd{lfd, POLLIN, 0};
    int pr;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    for (;;) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
      if (left < 0) left = 0;
      pr = poll(&pfd, 1, static_cast<int>(left));
      if (pr < 0 && errno == EINTR) continue;
      break;
    }
    if (pr <= 0) {
      if (err)
        *err = pr == 0 ? ("accept timeout on port " + std::to_string(port))
                       : (std::string("poll: ") + strerror(errno));
      close(lfd);
      return -1;
    }
  }
  int fd = accept(lfd, nullptr, nullptr);
  int saved = errno;
  close(lfd);
  if (fd < 0) {
    if (err) *err = std::string("accept: ") + strerror(saved);
    return -1;
  }
  tune_socket(fd);
  return fd;
}

int tcp_connect_retry(const char *host, int port, int timeout_ms,
                      std::string *err) {
  sockaddr_in addr;
  if (!make_addr(host, port, &addr, err)) return -1;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 0);
  for (;;) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      if (err) *err = std::string("socket: ") + strerror(errno);
      return -1;
    }
    if (::connect(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) ==
        0) {
      tune_socket(fd);
      return fd;
    }
    close(fd);
    if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline) {
      if (err)
        *err = std::string("connect timeout to ") + host + ":" +
               std::to_string(port);
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
}

bool read_full(int fd, void *buf, size_t len) {
  char *p = static_cast<char *>(buf);
  while (len > 0) {
    ssize_t n = ::read(fd, p, len);
    if (n == 0) return false;  // EOF
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool write_full(int fd, const void *buf, size_t len) {
  const char *p = static_cast<const char *>(buf);
  while (len > 0) {
    ssize_t n = ::write(fd, p, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Header + payload in one gathered submission so the payload bytes go
// straight from the registered memory to the socket — the emulated
// analogue of the NIC reading the MR directly (no bounce buffer).
bool write_hdr_payload(int fd, const void *hdr, size_t hdrlen,
                       const void *payload, size_t len) {
  iovec iov[2];
  iov[0].iov_base = const_cast<void *>(hdr);
  iov[0].iov_len = hdrlen;
  iov[1].iov_base = const_cast<void *>(payload);
  iov[1].iov_len = len;
  size_t total = hdrlen + len;
  size_t sent = 0;
  int iovidx = 0;
  while (sent < total) {
    msghdr msg;
    memset(&msg, 0, sizeof(msg));
    msg.msg_iov = &iov[iovidx];
    msg.msg_iovlen = 2 - iovidx;
    ssize_t n = sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    sent += static_cast<size_t>(n);
    size_t adv = static_cast<size_t>(n);
    while (adv > 0 && iovidx < 2) {
      if (adv >= iov[iovidx].iov_len) {
        adv -= iov[iovidx].iov_len;
        iov[iovidx].iov_len = 0;
        iovidx++;
      } else {
        iov[iovidx].iov_base = static_cast<char *>(iov[iovidx].iov_base) + adv;
        iov[iovidx].iov_len -= adv;
        adv = 0;
      }
    }
  }
  return true;
}

}  // namespace tdr
