// afp_tpu_torch host staging copy: a block's bytes from the caller's pageable
// memory into the pinned buffer the host→device copy reads.
//
// Replaces no TPU kernel: on the TPU the runtime stages host buffers itself.
// On the card's host this copy sets the serving pump's pace (PERF.md §5): it
// is bound by the host's memory bandwidth, not by the card.  What the design
// does about that:
//
// - A persistent pool of worker threads, parked on one atomic word (a futex)
//   between copies.  A copy cuts the block into one contiguous slice per
//   thread, cache-line aligned in the destination; the calling thread copies
//   the first slice itself and then waits for the others.
// - SSE2 streaming stores (baseline x86-64, no -march flag) into the
//   destination: the pinned buffer is only read again by the card's DMA, so
//   its lines are written around the caches, without the read for ownership
//   that an ordinary store makes.  A scalar head brings the destination to 16
//   bytes, a scalar tail ends it, and each slice ends with _mm_sfence.  Other
//   architectures take memcpy.
// - A software prefetch of the source two pages ahead.
//
// Measured on the card's host in a pump emulation (PERF.md §5, 8 CPUs, no
// NUMA node seen): 64 MiB blocks at 33 GiB/s against 20 for torch's copy;
// streaming stores without the prefetch 25, the prefetch with ordinary
// stores 20.  The stage takes it from a size measured in the served pump.
//
// Pure C ABI, loaded with ctypes (which releases the GIL around each call).
// The library touches no memory but the two ranges of a copy.

#include <unistd.h>
#if defined(__linux__)
#include <linux/futex.h>
#include <sys/syscall.h>
#endif

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

void copy_slice(char* dst, const char* src, size_t n) {
#if defined(__SSE2__)
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  std::memcpy(dst, src, head);
  dst += head;
  src += head;
  n -= head;
  const size_t body = n & ~size_t(63);
  for (size_t i = 0; i < body; i += 64) {
    // two pages ahead: the pageable source misses the TLB at every 4 KiB
    // page, where the hardware prefetcher stops (a prefetch never faults)
    _mm_prefetch(src + i + 8192, _MM_HINT_T0);
    const __m128i* in = reinterpret_cast<const __m128i*>(src + i);
    __m128i* out = reinterpret_cast<__m128i*>(dst + i);
    const __m128i a = _mm_loadu_si128(in), b = _mm_loadu_si128(in + 1);
    const __m128i c = _mm_loadu_si128(in + 2), d = _mm_loadu_si128(in + 3);
    _mm_stream_si128(out, a);
    _mm_stream_si128(out + 1, b);
    _mm_stream_si128(out + 2, c);
    _mm_stream_si128(out + 3, d);
  }
  std::memcpy(dst + body, src + body, n - body);
  _mm_sfence();  // the streaming stores are visible before the slice is done
#else
  std::memcpy(dst, src, n);
#endif
}

void spin_pause() {
#if defined(__SSE2__)
  _mm_pause();
#endif
}

// Park on `word` while it holds `seen` (spurious returns are fine: callers
// loop), and wake every thread parked on it.
void park(std::atomic<uint32_t>* word, uint32_t seen) {
#if defined(__linux__)
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAIT_PRIVATE,
          seen, nullptr, nullptr, 0);
#else
  (void)word;
  (void)seen;
  std::this_thread::yield();
#endif
}

void wake_all(std::atomic<uint32_t>* word) {
#if defined(__linux__)
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAKE_PRIVATE,
          INT_MAX, nullptr, nullptr, 0);
#else
  (void)word;
#endif
}

struct Pool {
  std::mutex call;  // one copy at a time through the pool
  std::vector<std::thread> threads;
  // bumped by each copy, in units of 256, with the copy's slice count in
  // the low byte: a worker reads both in one load.  The workers park on it
  // (a futex on Linux) between copies.
  std::atomic<uint32_t> job{0};
  std::atomic<bool> stop{false};
  // the copy in progress: slice k covers [bounds[k], bounds[k+1])
  char* dst = nullptr;
  const char* src = nullptr;
  std::vector<size_t> bounds;
  std::atomic<int> pending{0};
  pid_t pid = 0;  // a forked child has none of these threads
};

void worker(Pool* p, int index) {
  uint32_t seen = 0;
  for (;;) {
    uint32_t job;
    while ((job = p->job.load(std::memory_order_acquire)) == seen)
      park(&p->job, seen);
    seen = job;
    if (p->stop.load(std::memory_order_acquire)) return;
    // a copy waits for every slice it handed out, so the fields stay put
    // until this worker's slice is done
    if (index >= static_cast<int>(job & 255)) continue;
    const size_t a = p->bounds[index], b = p->bounds[index + 1];
    copy_slice(p->dst + a, p->src + a, b - a);
    p->pending.fetch_sub(1, std::memory_order_release);
  }
}

}  // namespace

extern "C" {

// A pool of `n_workers` parked worker threads: a copy through it uses
// n_workers + 1 threads, the workers and the caller.  NULL when a thread
// cannot be started.
void* afp_copier_create(int n_workers) {
  Pool* p = new Pool;
  p->pid = getpid();
  try {
    for (int i = 0; i < n_workers; ++i)
      p->threads.emplace_back(worker, p, i + 1);
  } catch (...) {
    p->stop.store(true, std::memory_order_release);
    p->job.fetch_add(256, std::memory_order_release);
    wake_all(&p->job);
    for (auto& t : p->threads) t.join();
    delete p;
    return nullptr;
  }
  return p;
}

void afp_copier_destroy(void* h) {
  Pool* p = static_cast<Pool*>(h);
  if (!p) return;
  p->stop.store(true, std::memory_order_release);
  p->job.fetch_add(256, std::memory_order_release);
  wake_all(&p->job);
  if (getpid() == p->pid)
    for (auto& t : p->threads) t.join();
  else
    for (auto& t : p->threads) t.detach();
  delete p;
}

// Copy n bytes from src to dst (the ranges do not overlap) in one slice a
// thread: the caller's and each worker's (the caller's alone in a forked
// child, which has no workers).  Returns the threads used.
int afp_copy(void* h, void* dst, const void* src, uint64_t n) {
  Pool* p = static_cast<Pool*>(h);
  int k = 1;
  if (p && getpid() == p->pid) k = static_cast<int>(p->threads.size()) + 1;
  if (k > 255) k = 255;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (k == 1) {
    copy_slice(d, s, n);
    return 1;
  }
  std::lock_guard<std::mutex> call(p->call);
  // slice edges on the destination's cache lines
  const uintptr_t base = reinterpret_cast<uintptr_t>(d);
  p->bounds.assign(k + 1, 0);
  for (int i = 1; i < k; ++i) {
    const uintptr_t edge = (base + n * i / k + 63) & ~uintptr_t(63);
    size_t off = static_cast<size_t>(edge - base);
    if (off > n) off = n;
    if (off < p->bounds[i - 1]) off = p->bounds[i - 1];
    p->bounds[i] = off;
  }
  p->bounds[k] = n;
  p->dst = d;
  p->src = s;
  p->pending.store(k - 1, std::memory_order_relaxed);
  const uint32_t job = p->job.load(std::memory_order_relaxed);
  p->job.store(((job >> 8) + 1) << 8 | static_cast<uint32_t>(k),
               std::memory_order_release);
  wake_all(&p->job);
  copy_slice(d, s, p->bounds[1]);
  for (int spins = 0; p->pending.load(std::memory_order_acquire); ++spins) {
    if (spins < 4096) spin_pause();
    else std::this_thread::yield();
  }
  return k;
}

}  // extern "C"
