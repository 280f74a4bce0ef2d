// Streaming minibatch loader: mmap'd dataset + background prefetch thread.
//
// Native runtime counterpart of the host-side input pipeline for minibatch
// training (gp/sparse.py svgp_fit draws uniform-with-replacement batches;
// the reference's only data path is a whole-file CSV read,
// tutorial/tutorial.go:234-272 — it never needed streaming because its
// datasets are 20-44 rows).  For production-scale SVGP training the dataset
// lives on disk as a packed row-major float64 matrix; this loader maps it
// read-only and keeps a ring of pre-gathered batches ready so the
// accelerator never waits on host row-gather.
//
// Sampling contract: uniform with replacement via xorshift64* seeded by the
// caller — gogp/utils/dataio.py implements the SAME generator in the
// pure-Python fallback, so native and fallback streams are bit-identical
// (pinned by tests/test_dataio.py).
//
// C ABI (ctypes, no pybind11 in this image):
//   loader_open(path, offset, n_rows, n_cols, batch, capacity, seed) -> handle|0
//   loader_next(handle, out[batch*n_cols]) -> n_values | -1
//   loader_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline uint64_t xorshift64star(uint64_t& s) {
  s ^= s >> 12;
  s ^= s << 25;
  s ^= s >> 27;
  return s * 0x2545F4914F6CDD1DULL;
}

struct Loader {
  int fd = -1;
  const unsigned char* map = nullptr;
  size_t map_len = 0;
  const double* data = nullptr;  // row-major (n_rows, n_cols)
  long n_rows = 0, n_cols = 0, batch = 0, capacity = 0;
  uint64_t rng = 0;
  std::vector<double> ring;  // capacity slots of batch*n_cols doubles
  long produced = 0, consumed = 0;  // guarded by mu
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread worker;

  void produce_loop() {
    const long slot_vals = batch * n_cols;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || produced - consumed < capacity; });
        if (stop) return;
      }
      double* slot = ring.data() + (produced % capacity) * slot_vals;
      for (long i = 0; i < batch; ++i) {
        // Rejection-free would bias; modulo bias is < 2^-40 for any n_rows
        // that fits in memory — accepted (and mirrored by the fallback).
        long idx = static_cast<long>(xorshift64star(rng) % static_cast<uint64_t>(n_rows));
        std::memcpy(slot + i * n_cols, data + idx * n_cols,
                    sizeof(double) * static_cast<size_t>(n_cols));
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ++produced;
      }
      cv_data.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_open(const char* path, long offset_bytes, long n_rows, long n_cols,
                  long batch, long capacity, uint64_t seed) {
  if (n_rows <= 0 || n_cols <= 0 || batch <= 0 || capacity <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  const size_t need = static_cast<size_t>(offset_bytes) +
                      sizeof(double) * static_cast<size_t>(n_rows) *
                          static_cast<size_t>(n_cols);
  if (static_cast<size_t>(st.st_size) < need) { ::close(fd); return nullptr; }
  void* map = mmap(nullptr, need, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { ::close(fd); return nullptr; }

  Loader* ld = new (std::nothrow) Loader();
  if (!ld) { munmap(map, need); ::close(fd); return nullptr; }
  ld->fd = fd;
  ld->map = static_cast<const unsigned char*>(map);
  ld->map_len = need;
  ld->data = reinterpret_cast<const double*>(ld->map + offset_bytes);
  ld->n_rows = n_rows;
  ld->n_cols = n_cols;
  ld->batch = batch;
  ld->capacity = capacity;
  ld->rng = seed ? seed : 0x9E3779B97F4A7C15ULL;  // xorshift state must be nonzero
  ld->ring.resize(static_cast<size_t>(capacity) * batch * n_cols);
  ld->worker = std::thread([ld] { ld->produce_loop(); });
  return ld;
}

long loader_next(void* handle, double* out) {
  Loader* ld = static_cast<Loader*>(handle);
  if (!ld || !out) return -1;
  const long slot_vals = ld->batch * ld->n_cols;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_data.wait(lk, [&] { return ld->produced > ld->consumed; });
    const double* slot = ld->ring.data() + (ld->consumed % ld->capacity) * slot_vals;
    std::memcpy(out, slot, sizeof(double) * static_cast<size_t>(slot_vals));
    ++ld->consumed;
  }
  ld->cv_space.notify_one();
  return slot_vals;
}

void loader_close(void* handle) {
  Loader* ld = static_cast<Loader*>(handle);
  if (!ld) return;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop = true;
  }
  ld->cv_space.notify_all();
  if (ld->worker.joinable()) ld->worker.join();
  if (ld->map) munmap(const_cast<unsigned char*>(ld->map), ld->map_len);
  if (ld->fd >= 0) ::close(ld->fd);
  delete ld;
}

}  // extern "C"
