// The subbands of one picture arith-coded concurrently on a pool of host
// threads, and the same pool lent to other independent jobs (`pool_for`:
// the low-delay slices' packing).
//
// Each subband is its own arithmetic stream (the contexts restart and the
// parse unit carries its length), so the bands of a picture do not depend
// on each other; only the order of their payloads in the parse unit is
// fixed, and the caller writes them in that order.  Every band is coded by
// schro_coding.cpp's `subband_encode_arith`, unchanged, so each payload is
// the per-band call's byte for byte.
//
// The pool is one set of std::threads per process, started at the first
// pooled batch, one fewer than the CPUs the process may run on: the calling
// thread codes too.  A batch's bands are handed out largest first through
// an atomic index, so a caller always finishes its own batch even when no
// worker is free, and several callers (GOP shards, the api's threads) may
// batch at once.  A process forked from one that started the pool codes
// inline: the forked child has no workers.

#include <sched.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" int64_t subband_encode_arith(
    const int32_t* qdata, int h, int w, const int32_t* parent_deq, int pw,
    int position, int hcb, int vcb, int have_quant_offset,
    const int32_t* quant_indices, uint8_t* out, int64_t out_capacity,
    int32_t* first_qi_out);

// One band of a batch; `_ArithBand` in __init__.py mirrors it field for
// field.  data and parent hold C-contiguous int16 or int32 rows (elem,
// parent_elem: 2 or 4 bytes); out has room for capacity bytes.
struct ArithBand {
  const void* data;
  const void* parent;            // null: no parent
  const int32_t* quant_indices;  // (vcb, hcb)
  uint8_t* out;
  int64_t capacity;
  int64_t n_bytes;               // out: the payload's length
  int32_t h, w, parent_h, parent_w;
  int32_t elem, parent_elem;
  int32_t position, hcb, vcb, have_quant_offset;
  int32_t first_qi;              // out: as subband_encode_arith gives it
  int32_t on_worker;             // out: 1 when a pool thread coded it
};
static_assert(sizeof(ArithBand) == 96, "ArithBand layout");

namespace {

const int32_t* as_int32(const void* p, int elem, int64_t n,
                        std::vector<int32_t>& buf) {
  if (elem == 4) return static_cast<const int32_t*>(p);
  const int16_t* s = static_cast<const int16_t*>(p);
  buf.resize(n);
  for (int64_t i = 0; i < n; i++) buf[i] = s[i];
  return buf.data();
}

void code_band(ArithBand& b, int on_worker) {
  thread_local std::vector<int32_t> data_buf, parent_buf;
  const int32_t* q = as_int32(b.data, b.elem, (int64_t)b.h * b.w, data_buf);
  const int32_t* parent =
      b.parent ? as_int32(b.parent, b.parent_elem,
                          (int64_t)b.parent_h * b.parent_w, parent_buf)
               : nullptr;
  int32_t first_qi = -1;
  b.n_bytes = subband_encode_arith(q, b.h, b.w, parent, b.parent_w,
                                   b.position, b.hcb, b.vcb,
                                   b.have_quant_offset, b.quant_indices,
                                   b.out, b.capacity, &first_qi);
  b.first_qi = first_qi;
  b.on_worker = on_worker;
}

// n jobs, job i being run(ctx, i, on_worker): the bands of an arith
// batch, or whatever `pool_for` is handed.
struct Batch {
  void (*run)(void* ctx, int i, int on_worker);
  void* ctx;
  int n;
  std::atomic<int> next{0};      // the next job to hand out
  int done = 0;                  // jobs run; under Pool::mu_
  int users = 0;                 // workers inside the batch; under mu_
  std::condition_variable finished;
};

// Runs jobs of b until none is left to hand out; returns how many.
int drain(Batch& b, int on_worker) {
  int ran = 0;
  for (int i; (i = b.next.fetch_add(1)) < b.n; ran++)
    b.run(b.ctx, i, on_worker);
  return ran;
}

struct ArithJobs {
  ArithBand* bands;
  const int* order;              // band indices, largest first
};

void run_band(void* ctx, int i, int on_worker) {
  ArithJobs* a = static_cast<ArithJobs*>(ctx);
  code_band(a->bands[a->order[i]], on_worker);
}

class Pool {
 public:
  // Never destroyed: detached workers may still wait on its members while
  // the process exits.
  static Pool& get() {
    static Pool* pool = new Pool(cpus());
    return *pool;
  }

  // The CPUs this process may run on, read once.
  static int cpus() {
    static const int n = [] {
      cpu_set_t set;
      if (sched_getaffinity(0, sizeof(set), &set) != 0) return 1;
      return std::max(CPU_COUNT(&set), 1);
    }();
    return n;
  }

  bool owned_by_this_process() const { return pid_ == getpid(); }

  // Codes b on the calling thread and up to `helpers` workers.
  void run(Batch& b, int helpers) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push_back(&b);
    }
    for (int i = 0; i < helpers; i++) wake_.notify_one();
    int ran = drain(b, 0);
    std::unique_lock<std::mutex> lk(mu_);
    retire(&b);
    b.done += ran;
    b.finished.wait(lk, [&] { return b.done == b.n && b.users == 0; });
  }

  int workers() const { return (int)threads_; }

 private:
  explicit Pool(int n) : pid_(getpid()), threads_(n - 1) {
    for (int i = 0; i < threads_; i++)
      std::thread(&Pool::work, this).detach();
  }

  // Takes a batch that has no band left to hand out off the queue.
  void retire(Batch* b) {
    auto it = std::find(queue_.begin(), queue_.end(), b);
    if (it != queue_.end()) queue_.erase(it);
  }

  void work() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return !queue_.empty(); });
      Batch* b = queue_.front();
      b->users++;
      lk.unlock();
      int ran = drain(*b, 1);
      lk.lock();
      retire(b);
      b->done += ran;
      b->users--;
      if (b->done == b->n && b->users == 0) b->finished.notify_all();
    }
  }

  const pid_t pid_;
  const int threads_;
  std::mutex mu_;
  std::condition_variable wake_;
  std::deque<Batch*> queue_;
};

}  // namespace

extern "C" {

int arith_pool_cpus() { return Pool::cpus(); }

// Codes the n bands of one picture; pooled = 0 codes them all on the
// calling thread, in order.  Otherwise, with more than one CPU and more
// than one band, min(CPUs, n) threads share them, the caller among them.
void subband_encode_arith_batch(ArithBand* bands, int n, int pooled) {
  int threads = std::min(Pool::cpus(), n);
  if (!pooled || threads < 2 || !Pool::get().owned_by_this_process()) {
    for (int i = 0; i < n; i++) code_band(bands[i], 0);
    return;
  }
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return (int64_t)bands[a].h * bands[a].w > (int64_t)bands[b].h * bands[b].w;
  });
  ArithJobs jobs{bands, order.data()};
  Batch batch;
  batch.run = run_band;
  batch.ctx = &jobs;
  batch.n = n;
  Pool& pool = Pool::get();
  pool.run(batch, std::min(threads - 1, pool.workers()));
}

// Runs fn(ctx, i) for every i in [0, n), on the calling thread and at most
// `helpers` pool workers, handed out in order; returns when all have run.
// With helpers < 1, or in a forked child, the calling thread runs them all.
void pool_for(int n, int helpers, void (*fn)(void* ctx, int i), void* ctx) {
  if (helpers < 1 || n < 2 || !Pool::get().owned_by_this_process()) {
    for (int i = 0; i < n; i++) fn(ctx, i);
    return;
  }
  struct Job {
    void (*fn)(void*, int);
    void* ctx;
  } job{fn, ctx};
  Batch batch;
  batch.run = [](void* c, int i, int) {
    Job* j = static_cast<Job*>(c);
    j->fn(j->ctx, i);
  };
  batch.ctx = &job;
  batch.n = n;
  Pool& pool = Pool::get();
  pool.run(batch, std::min({helpers, n - 1, pool.workers()}));
}

}  // extern "C"
