// Parallel data movement — the emulated NIC's DMA-engine array.
//
// A real HCA moves payloads with dedicated DMA engines that scale past
// any single CPU core; the emulated backend's equivalent is this
// process-wide worker pool. Large copies/reduces are split into
// dynamically-balanced slices executed across the pool (the posting /
// progress thread participates, so a 1-core machine runs exactly the
// old inline path with zero extra threads of overhead).
//
// Slices are element-disjoint, so parallel reductions are bit-exact
// with the serial ones regardless of the split.

#include <sched.h>
#include <sys/uio.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include "common.h"

namespace tdr {

// Usable cores: the affinity mask (the container/cgroup truth) first,
// hardware_concurrency as the fallback, 1 when both are dark. Shared
// by every pool in this file — only the env override and clamp policy
// differ per pool — and by the progress-shard sizing policy
// (ring_allreduce.cc), so pools and shards cannot disagree about the
// host.
size_t usable_cores() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) {
    int n = CPU_COUNT(&set);
    if (n >= 1) return static_cast<size_t>(n);
  }
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? hc : 1;
}

namespace {

// Slice granularity: big enough that per-slice dispatch cost vanishes,
// small enough for dynamic balance across NUMA-variable memcpy speeds.
constexpr size_t kGrain = 4u << 20;

size_t pool_threads() {
  const char *env = getenv("TDR_COPY_THREADS");
  if (env && *env) {
    long v = atol(env);
    if (v >= 1) return static_cast<size_t>(std::min(v, 64L));
  }
  return std::min(usable_cores(), static_cast<size_t>(16));
}

}  // namespace

// Non-temporal copy for large cold destinations. Plain memcpy below
// libc's (cache-sized, i.e. enormous here) non-temporal threshold
// pays a read-for-ownership on every destination line — 3 bytes of
// DRAM traffic per byte copied; streaming stores cut that to 2, a
// measured ~1.4x on chunk-sized (MBs) copies. The destination is NOT
// cached afterwards, so this is only for payload landing (the
// consumer is a later pass anyway), never for small control copies.
void copy_nt(char *dst, const char *src, size_t len) {
#if defined(__x86_64__) || defined(__i386__)
  // Align the destination for streaming stores (32B covers both the
  // AVX2 and SSE2 paths).
  uintptr_t mis = reinterpret_cast<uintptr_t>(dst) & 31;
  if (mis) {
    size_t head = 32 - mis;
    if (head > len) head = len;
    memcpy(dst, src, head);
    dst += head;
    src += head;
    len -= head;
  }
#if defined(__AVX2__)
  for (; len >= 64; dst += 64, src += 64, len -= 64) {
    __m256i x0 = _mm256_loadu_si256(reinterpret_cast<const __m256i *>(src));
    __m256i x1 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i *>(src + 32));
    _mm256_stream_si256(reinterpret_cast<__m256i *>(dst), x0);
    _mm256_stream_si256(reinterpret_cast<__m256i *>(dst + 32), x1);
  }
#else
  for (; len >= 64; dst += 64, src += 64, len -= 64) {
    __m128i x0 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(src));
    __m128i x1 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(src + 16));
    __m128i x2 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(src + 32));
    __m128i x3 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(src + 48));
    _mm_stream_si128(reinterpret_cast<__m128i *>(dst), x0);
    _mm_stream_si128(reinterpret_cast<__m128i *>(dst + 16), x1);
    _mm_stream_si128(reinterpret_cast<__m128i *>(dst + 32), x2);
    _mm_stream_si128(reinterpret_cast<__m128i *>(dst + 48), x3);
  }
#endif
  if (len) memcpy(dst, src, len);
  _mm_sfence();
#else
  memcpy(dst, src, len);
#endif
}

namespace {
// Streaming pays off once the destination clearly exceeds L1/L2-hot
// sizes; below this plain memcpy wins (and keeps the bytes cached).
// There is deliberately NO upper ceiling: the previous 64 MiB cutoff
// assumed libc memcpy switches to non-temporal stores for huge copies
// — measured false on this class of host (1 GiB memcpy: 3.5 GB/s vs
// 8.1 GB/s streamed; the RFO traffic of cached stores doubles the
// effective bytes), and it was the reason bench sizes ≥ 64 MiB fell
// off a cliff while the 512 KiB–64 MiB tier ran 1.5–2× faster.
constexpr size_t kNtThreshold = 512u << 10;

// Per-tier byte counters (bench/diagnostics: which copy path carried
// the traffic — tdr_copy_counters).
std::atomic<uint64_t> g_nt_bytes{0};
std::atomic<uint64_t> g_plain_bytes{0};

// Flight recorder: copy-pool job ordinal (pairs COPY_ENQ/COPY_RUN).
std::atomic<uint64_t> g_copy_seq{0};

inline void fast_copy(void *dst, const void *src, size_t len) {
  if (len >= kNtThreshold) {
    g_nt_bytes.fetch_add(len, std::memory_order_relaxed);
    copy_nt(static_cast<char *>(dst), static_cast<const char *>(src), len);
  } else {
    g_plain_bytes.fetch_add(len, std::memory_order_relaxed);
    memcpy(dst, src, len);
  }
}
}  // namespace

void copy_counters(uint64_t *nt, uint64_t *plain) {
  if (nt) *nt = g_nt_bytes.load(std::memory_order_relaxed);
  if (plain) *plain = g_plain_bytes.load(std::memory_order_relaxed);
}

bool cma_copy_from(pid_t pid, void *dst, uint64_t src, size_t len) {
  if (pid == kCmaSameProcess) {
    memcpy(dst, reinterpret_cast<const void *>(src), len);
    return true;
  }
  char *d = static_cast<char *>(dst);
  while (len > 0) {
    iovec liov{d, len};
    iovec riov{reinterpret_cast<void *>(src), len};
    ssize_t n = process_vm_readv(pid, &liov, 1, &riov, 1, 0);
    if (n <= 0) return false;
    d += n;
    src += static_cast<uint64_t>(n);
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool cma_copy_to(pid_t pid, uint64_t dst, const void *src, size_t len) {
  if (pid == kCmaSameProcess) {
    memcpy(reinterpret_cast<void *>(dst), src, len);
    return true;
  }
  const char *s = static_cast<const char *>(src);
  while (len > 0) {
    iovec liov{const_cast<char *>(s), len};
    iovec riov{reinterpret_cast<void *>(dst), len};
    ssize_t n = process_vm_writev(pid, &liov, 1, &riov, 1, 0);
    if (n <= 0) return false;
    s += n;
    dst += static_cast<uint64_t>(n);
    len -= static_cast<size_t>(n);
  }
  return true;
}

class CopyPool {
 public:
  static CopyPool &instance() {
    // Leaked intentionally: QP progress threads may still be moving
    // bytes during static destruction; a destructed pool would hang
    // or crash them. The OS reclaims the threads at exit.
    static CopyPool *p = new CopyPool(pool_threads());
    return *p;
  }

  size_t workers() const { return nthreads_; }

  // Run fn over [0, n) in ~grain-sized slices across the pool; the
  // calling thread participates. One region at a time — concurrent
  // callers queue on region_mu_, which is fine because every caller
  // is itself a full-bandwidth participant.
  void parfor(size_t n, size_t grain,
              const std::function<void(size_t, size_t)> &fn) {
    if (n == 0) return;
    // Flight recorder: enqueue/run bracket for the pool job (the
    // emulated DMA engine's dispatch trace). Serial fallbacks record
    // too — a 1-core host still "runs the DMA engine", inline.
    uint64_t tel_seq = 0, tel_t0 = 0;
    if (tel_on()) {
      tel_seq = g_copy_seq.fetch_add(1, std::memory_order_relaxed) + 1;
      tel_t0 = tel_now_ns();
      tel_emit(TDR_TEL_COPY_ENQ, 0, 0, tel_seq, n);
    }
    if (nthreads_ <= 1 || n <= grain) {
      fn(0, n);
    } else {
      std::lock_guard<std::mutex> region(region_mu_);
      Job job;
      job.fn = &fn;
      job.n = n;
      job.grain = grain;
      {
        std::lock_guard<std::mutex> g(mu_);
        job_ = &job;
      }
      cv_.notify_all();
      run_slices(job);
      std::unique_lock<std::mutex> lk(mu_);
      done_cv_.wait(lk, [&] {
        return job.active.load(std::memory_order_acquire) == 0;
      });
      job_ = nullptr;  // still under mu_: no worker can deref after this
    }
    if (tel_t0)
      tel_emit(TDR_TEL_COPY_RUN, 0, 0, tel_seq,
               (tel_now_ns() - tel_t0) / 1000);
  }

 private:
  struct Job {
    const std::function<void(size_t, size_t)> *fn = nullptr;
    size_t n = 0;
    size_t grain = 0;
    std::atomic<size_t> next{0};
    std::atomic<int> active{0};
  };

  explicit CopyPool(size_t nthreads) : nthreads_(nthreads) {
    for (size_t i = 1; i < nthreads_; i++)
      threads_.emplace_back([this] { worker(); });
  }

  static void run_slices(Job &j) {
    for (;;) {
      size_t b = j.next.fetch_add(j.grain, std::memory_order_relaxed);
      if (b >= j.n) break;
      (*j.fn)(b, std::min(b + j.grain, j.n));
    }
  }

  void worker() {
    for (;;) {
      Job *j = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] {
          return job_ && job_->next.load(std::memory_order_relaxed) < job_->n;
        });
        j = job_;
        j->active.fetch_add(1, std::memory_order_acq_rel);
      }
      run_slices(*j);
      {
        std::lock_guard<std::mutex> lk(mu_);
        j->active.fetch_sub(1, std::memory_order_acq_rel);
      }
      done_cv_.notify_all();
    }
  }

  const size_t nthreads_;
  std::vector<std::thread> threads_;
  std::mutex region_mu_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  Job *job_ = nullptr;
};

size_t copy_pool_workers() { return CopyPool::instance().workers(); }

// ------------------------------------------------------------------
// Fold-offload pool: the ring layer's scratch-window folds, off the
// poll loop. Distinct from CopyPool on purpose: CopyPool::parfor is a
// BLOCKING fork-join (the caller participates and waits), which is
// exactly what the poll loop must stop doing — here jobs are
// fire-and-forget closures whose completion the ring tracks itself
// (per-chunk flags gating scratch-slot reuse). TDR_FOLD_THREADS
// overrides the worker count; 0 — and any 1-core host — degrades to
// inline execution on the calling thread, zero extra threads.
// ------------------------------------------------------------------

namespace {

size_t fold_threads() {
  const char *env = getenv("TDR_FOLD_THREADS");
  if (env && *env) {
    long v = atol(env);
    if (v >= 0) return static_cast<size_t>(std::min(v, 16L));
  }
  size_t n = usable_cores();
  // A 1-core host gains nothing from an offload thread (pure context-
  // switch tax); otherwise a small pool — the folds are memory-bound,
  // more workers than memory channels just thrash.
  return n <= 1 ? 0 : std::min(n, static_cast<size_t>(4));
}

std::atomic<uint64_t> g_fold_jobs{0};
std::atomic<uint64_t> g_fold_busy_us{0};
// Submitted-but-not-finished depth: completion signaling back to the
// submitter is the CLOSURE's job (the ring's fold jobs publish their
// watermark and notify the schedule's condvar themselves); this gauge
// is the pool-side view — sampled by diagnostics to tell "fold pool
// is the bottleneck" (deep queue, idle wire) from the converse.
std::atomic<uint64_t> g_fold_pending{0};

class FoldPool {
 public:
  static FoldPool &instance() {
    // Leaked for the same reason as CopyPool: jobs may still be
    // draining at static-destruction time.
    static FoldPool *p = new FoldPool(fold_threads());
    return *p;
  }

  size_t workers() const { return nthreads_; }

  void submit(std::function<void()> fn) {
    g_fold_pending.fetch_add(1, std::memory_order_relaxed);
    if (nthreads_ == 0) {
      run_one(fn);
      return;
    }
    {
      std::lock_guard<std::mutex> g(mu_);
      q_.push_back(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  static void run_one(const std::function<void()> &fn) {
    // Busy time is tracked unconditionally (one clock pair per
    // MB-scale fold — noise): the bench reads occupancy with the
    // flight recorder off, where a telemetry-gated clock would read 0.
    uint64_t t0 = tel_now_ns();
    fn();
    g_fold_jobs.fetch_add(1, std::memory_order_relaxed);
    g_fold_busy_us.fetch_add((tel_now_ns() - t0) / 1000,
                             std::memory_order_relaxed);
    g_fold_pending.fetch_sub(1, std::memory_order_relaxed);
  }

  explicit FoldPool(size_t nthreads) : nthreads_(nthreads) {
    for (size_t i = 0; i < nthreads_; i++)
      threads_.emplace_back([this] { worker(); });
  }

  void worker() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return !q_.empty(); });
        fn = std::move(q_.front());
        q_.pop_front();
      }
      run_one(fn);
    }
  }

  const size_t nthreads_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> q_;
};

}  // namespace

size_t fold_pool_workers() { return FoldPool::instance().workers(); }

void fold_submit(std::function<void()> fn) {
  FoldPool::instance().submit(std::move(fn));
}

uint64_t fold_jobs() {
  return g_fold_jobs.load(std::memory_order_relaxed);
}

uint64_t fold_busy_us() {
  return g_fold_busy_us.load(std::memory_order_relaxed);
}

uint64_t fold_pending() {
  return g_fold_pending.load(std::memory_order_relaxed);
}

void par_memcpy(void *dst, const void *src, size_t len) {
  if (tel_on()) tel_hist_add(TDR_HIST_COPY_BYTES, len);
  CopyPool::instance().parfor(len, kGrain, [&](size_t b, size_t e) {
    fast_copy(static_cast<char *>(dst) + b,
              static_cast<const char *>(src) + b, e - b);
  });
}

void par_reduce(void *dst, const void *src, size_t n, int dt, int op) {
  size_t esz = dtype_size(dt);
  if (esz == 0) return;
  CopyPool::instance().parfor(n, kGrain / esz, [&](size_t b, size_t e) {
    reduce_any(static_cast<char *>(dst) + b * esz,
               static_cast<const char *>(src) + b * esz, e - b, dt, op);
  });
}

bool par_cma_copy_from(pid_t pid, void *dst, uint64_t src, size_t len) {
  if (pid == kCmaSameProcess) {
    par_memcpy(dst, reinterpret_cast<const void *>(src), len);
    return true;
  }
  std::atomic<bool> ok{true};
  CopyPool::instance().parfor(len, kGrain, [&](size_t b, size_t e) {
    if (!cma_copy_from(pid, static_cast<char *>(dst) + b, src + b, e - b))
      ok.store(false, std::memory_order_relaxed);
  });
  return ok.load();
}

bool par_cma_copy_to(pid_t pid, uint64_t dst, const void *src, size_t len) {
  if (pid == kCmaSameProcess) {
    par_memcpy(reinterpret_cast<void *>(dst), src, len);
    return true;
  }
  std::atomic<bool> ok{true};
  CopyPool::instance().parfor(len, kGrain, [&](size_t b, size_t e) {
    if (!cma_copy_to(pid, dst + b, static_cast<const char *>(src) + b, e - b))
      ok.store(false, std::memory_order_relaxed);
  });
  return ok.load();
}

void par_reduce2_local(void *dst, void *src, size_t n, int dt, int op) {
  size_t esz = dtype_size(dt);
  if (esz == 0) return;
  CopyPool::instance().parfor(n, kGrain / esz, [&](size_t b, size_t e) {
    reduce2_any(static_cast<char *>(dst) + b * esz,
                static_cast<char *>(src) + b * esz, e - b, dt, op);
  });
}

// Cross-process exchange fold: pull a window of peer bytes, fold it
// into dst while writing the folded values back into the window, and
// push the window back — one pass over dst, two kernel copies of the
// (cache-resident) window.
bool par_cma_reduce2(pid_t pid, void *dst, uint64_t src, size_t bytes,
                     int dt, int op) {
  size_t esz = dtype_size(dt);
  if (esz == 0 || bytes % esz != 0) return false;
  if (pid == kCmaSameProcess) {
    par_reduce2_local(dst, reinterpret_cast<void *>(src), bytes / esz, dt,
                      op);
    return true;
  }
  std::atomic<bool> ok{true};
  size_t grain = kGrain - kGrain % esz;
  CopyPool::instance().parfor(bytes, grain, [&](size_t b, size_t e) {
    char window[256 << 10];
    const size_t step = sizeof(window) - sizeof(window) % esz;
    char *d = static_cast<char *>(dst) + b;
    uint64_t s = src + b;
    size_t left = e - b;
    while (left > 0) {
      size_t chunk = left < step ? left : step;
      if (!cma_copy_from(pid, window, s, chunk)) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      reduce2_any(d, window, chunk / esz, dt, op);
      if (!cma_copy_to(pid, s, window, chunk)) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      d += chunk;
      s += chunk;
      left -= chunk;
    }
  });
  return ok.load();
}


// dst[i] op= peer_mem[i]: same-process folds read the peer buffer in
// place; cross-process slices stream through per-slice stack windows
// (cache-resident, so the fold costs one pass of DRAM traffic).
bool par_cma_reduce_from(pid_t pid, void *dst, uint64_t src, size_t bytes,
                         int dt, int op) {
  size_t esz = dtype_size(dt);
  if (esz == 0 || bytes % esz != 0) return false;
  if (pid == kCmaSameProcess) {
    par_reduce(dst, reinterpret_cast<const void *>(src), bytes / esz, dt, op);
    return true;
  }
  std::atomic<bool> ok{true};
  size_t grain = kGrain - kGrain % esz;
  CopyPool::instance().parfor(bytes, grain, [&](size_t b, size_t e) {
    char window[256 << 10];
    const size_t step = sizeof(window) - sizeof(window) % esz;
    char *d = static_cast<char *>(dst) + b;
    uint64_t s = src + b;
    size_t left = e - b;
    while (left > 0) {
      size_t chunk = left < step ? left : step;
      if (!cma_copy_from(pid, window, s, chunk)) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      reduce_any(d, window, chunk / esz, dt, op);
      d += chunk;
      s += chunk;
      left -= chunk;
    }
  });
  return ok.load();
}

}  // namespace tdr
