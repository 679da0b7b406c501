// Row copier for the GPU engine's host staging: the first `row_bytes` of
// each of `rows` source rows, `src_stride` bytes apart, into contiguous
// destination rows (the wire path's x||y words out of [n, 32] u32 point
// rows, and [n, 8] u32 scalar rows whole).
//
// Loads are unaligned. Where the destination is 32-byte aligned and a row
// is whole 32-byte lanes, the stores are streaming (non-temporal): the
// destination is pinned memory that the device's copy engine reads next,
// not the CPU, so the stores bypass the cache; elsewhere they are plain.
//
// A copy is split over a pool of workers made once a process (one fewer
// than the CPUs the process may run on), which sleep on a condition
// variable between copies, and the calling thread, all pulling chunks of
// rows from one atomic counter: a worker that loses its core holds up one
// chunk, not a fixed share. No OpenMP: its idle workers spin.
//
// Exposed through a C ABI for ctypes, which releases the GIL for the call.
//
// Build: g++ -O3 -march=native -pthread -shared -fPIC
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>

#include <sched.h>
#include <unistd.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// About 256 KiB of destination a chunk: 4 096 x||y rows, 8 192 scalar rows.
constexpr size_t CHUNK_BYTES = size_t(1) << 18;

struct Job {
  uint8_t* dst;
  const uint8_t* src;
  size_t rows, row_bytes, src_stride, chunk_rows, n_chunks;
  std::atomic<size_t> next{0};
};

void copy_span(const Job& j, size_t lo, size_t hi) {
  uint8_t* d = j.dst + lo * j.row_bytes;
  const uint8_t* s = j.src + lo * j.src_stride;
#if defined(__AVX2__)
  if (j.row_bytes % 32 == 0 && reinterpret_cast<uintptr_t>(j.dst) % 32 == 0) {
    const size_t lanes = j.row_bytes / 32;
    for (size_t r = lo; r < hi; ++r, d += j.row_bytes, s += j.src_stride) {
      for (size_t k = 0; k < lanes; ++k) {
        _mm256_stream_si256(reinterpret_cast<__m256i*>(d) + k,
                            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s) + k));
      }
    }
    _mm_sfence();  // the streaming stores are visible before the copy returns
    return;
  }
#endif
  for (size_t r = lo; r < hi; ++r, d += j.row_bytes, s += j.src_stride) {
    std::memcpy(d, s, j.row_bytes);
  }
}

void drain(Job& j) {
  for (size_t c; (c = j.next.fetch_add(1, std::memory_order_relaxed)) < j.n_chunks;) {
    copy_span(j, c * j.chunk_rows, std::min(j.rows, (c + 1) * j.chunk_rows));
  }
}

int cpus() {
  cpu_set_t set;
  return sched_getaffinity(0, sizeof set, &set) == 0 ? CPU_COUNT(&set) : 1;
}

class Pool {
 public:
  const pid_t pid = getpid();
  const int workers;

  explicit Pool(int n) : workers(n) {
    for (int i = 0; i < n; ++i) std::thread([this] { work(); }).detach();
  }

  // Copy `job` with the workers; false, having copied nothing, if another
  // thread's copy holds the pool.
  bool run(Job& job) {
    std::unique_lock<std::mutex> busy(busy_, std::try_to_lock);
    if (!busy.owns_lock()) return false;
    {
      std::lock_guard<std::mutex> lk(m_);
      job_ = &job;
      ++generation_;
    }
    wake_.notify_all();
    drain(job);
    // Every chunk is taken; wait for the workers still copying theirs. A
    // worker that wakes after this finds no job and sleeps again.
    std::unique_lock<std::mutex> lk(m_);
    job_ = nullptr;
    idle_.wait(lk, [this] { return active_ == 0; });
    return true;
  }

 private:
  void work() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      wake_.wait(lk, [&] { return generation_ != seen; });
      seen = generation_;
      Job* job = job_;
      if (job == nullptr) continue;
      ++active_;
      lk.unlock();
      drain(*job);
      lk.lock();
      if (--active_ == 0) idle_.notify_one();
    }
  }

  std::mutex busy_;  // one copy at a time
  std::mutex m_;     // guards job_, generation_, active_
  std::condition_variable wake_, idle_;
  Job* job_ = nullptr;
  uint64_t generation_ = 0;
  int active_ = 0;
};

std::mutex pool_m;
Pool* pool = nullptr;  // never freed: its detached workers live as long as the process

// The process's pool, made at its first use; a child process after fork()
// makes its own, since the parent's workers did not follow it. Null while
// another thread holds this lock (that caller then copies alone), or when
// the process may run on one CPU.
Pool* get_pool() {
  std::unique_lock<std::mutex> lk(pool_m, std::try_to_lock);
  if (!lk.owns_lock()) return nullptr;
  if (pool == nullptr || pool->pid != getpid()) pool = new Pool(cpus() - 1);
  return pool->workers > 0 ? pool : nullptr;
}

}  // namespace

extern "C" {

// Copy the first `row_bytes` of `rows` source rows, `src_stride` bytes
// apart, into `rows` contiguous destination rows of `row_bytes`. With
// `parallel` the copy is shared with the pool. Returns 1 if the pool took
// part, else 0 (the calling thread copied alone).
int row_copy(void* dst, const void* src, size_t rows, size_t row_bytes, size_t src_stride,
             int parallel) {
  if (rows == 0 || row_bytes == 0) return 0;
  Job job;
  job.dst = static_cast<uint8_t*>(dst);
  job.src = static_cast<const uint8_t*>(src);
  job.rows = rows;
  job.row_bytes = row_bytes;
  job.src_stride = src_stride;
  job.chunk_rows = std::max<size_t>(1, CHUNK_BYTES / row_bytes);
  job.n_chunks = (rows + job.chunk_rows - 1) / job.chunk_rows;
  Pool* p = parallel && job.n_chunks > 1 ? get_pool() : nullptr;
  if (p != nullptr && p->run(job)) return 1;
  drain(job);
  return 0;
}

// The pool's workers, besides the calling thread: one fewer than the CPUs
// this process may run on.
int row_copy_workers() { return cpus() - 1; }

}  // extern "C"
