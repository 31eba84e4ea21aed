// gwkit_torch host-IO runtime (a copy of gwkit's native/hostio.cpp).
//
// The search engine's host-side work is: read month-scale strain from disk,
// convert f64 -> f32, and hand segments to the device. The reference does
// this with h5py + a multiprocessing pool + an mp.Manager shared dict
// (MLGWSC-1/inference.py:269-285,548-575). Here it is a small C++ library:
//
//   * f64_to_f32 / extract_windows — tight conversion / window-packing loops
//   * loader_*  — a double-buffered background-thread file reader that
//     preads a contiguous on-disk array (e.g. an uncompressed HDF5 dataset
//     at a known offset) chunk by chunk, converting to f32 in the reader
//     thread so the Python thread only ever memcpy's ready buffers.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Built by gwkit_torch/native/hostio.py at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -o hostio-<hash>.so hostio.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

void f64_to_f32(const double* src, float* dst, long n) {
  for (long i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
}

// src: (d, n) row-major f32; dst: (count, d, window)
void extract_windows(const float* src, long d, long n, const long* starts,
                     long count, long window, float* dst) {
  for (long w = 0; w < count; ++w) {
    const long s = starts[w];
    for (long det = 0; det < d; ++det) {
      const float* row = src + det * n + s;
      float* out = dst + (w * d + det) * window;
      std::memcpy(out, row, sizeof(float) * window);
    }
  }
}

// ---------------------------------------------------------------------------
// Double-buffered chunk loader
// ---------------------------------------------------------------------------

struct Loader {
  FILE* file = nullptr;
  long n_total = 0;     // elements remaining to read
  long chunk = 0;       // elements per chunk
  int dtype = 0;        // 0 = f64 on disk, 1 = f32 on disk
  std::thread worker;
  // two slots; worker fills, consumer drains
  std::vector<float> slots[2];
  long filled[2] = {-1, -1};  // elements in slot, -1 = empty, -2 = EOF marker
  int next_fill = 0;
  int next_drain = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};

  void run() {
    std::vector<double> tmp;
    long remaining = n_total;
    while (remaining > 0 && !stop.load()) {
      long want = remaining < chunk ? remaining : chunk;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return filled[next_fill] == -1 || stop.load(); });
        if (stop.load()) return;
        slot = next_fill;
      }
      long got = 0;
      if (dtype == 0) {
        tmp.resize(want);
        got = static_cast<long>(fread(tmp.data(), sizeof(double), want, file));
        slots[slot].resize(got);
        f64_to_f32(tmp.data(), slots[slot].data(), got);
      } else {
        slots[slot].resize(want);
        got = static_cast<long>(fread(slots[slot].data(), sizeof(float), want, file));
        slots[slot].resize(got);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        filled[slot] = got;
        next_fill ^= 1;
      }
      cv.notify_all();
      remaining -= got;
      if (got < want) break;  // short read / EOF
    }
    done.store(true);
    cv.notify_all();
  }
};

void* loader_create(const char* path, long offset_bytes, long n_elems,
                    int dtype, long chunk_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (fseek(f, offset_bytes, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  Loader* L = new Loader();
  L->file = f;
  L->n_total = n_elems;
  L->chunk = chunk_elems;
  L->dtype = dtype;
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until the next chunk is ready; copies into dst (capacity chunk_elems).
// Returns number of elements, 0 on EOF, -1 on error.
long loader_next(void* handle, float* dst) {
  Loader* L = static_cast<Loader*>(handle);
  if (!L) return -1;
  int slot;
  long got;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv.wait(lk, [&] { return L->filled[L->next_drain] != -1 || L->done.load(); });
    slot = L->next_drain;
    got = L->filled[slot];
    if (got == -1) return 0;  // done and nothing buffered: EOF
  }
  if (got > 0) std::memcpy(dst, L->slots[slot].data(), sizeof(float) * got);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->filled[slot] = -1;
    L->next_drain ^= 1;
  }
  L->cv.notify_all();
  return got;
}

// ---------------------------------------------------------------------------
// Whole-array prefetcher: read segment i+1 entirely in a C++ thread while
// the device scores segment i. The Python thread never touches the file —
// it calls prefetch_wait (GIL released during the ctypes call) and gets a
// ready f32 array. Replaces the round-1 Python-thread prefetch that lost to
// GIL contention on a single-core host.
// ---------------------------------------------------------------------------

struct Prefetch {
  std::thread worker;
  std::vector<float> data;
  long n = -1;  // -1 = error
  bool joined = false;
};

void* prefetch_create(const char* path, long offset_bytes, long n_elems, int dtype) {
  Prefetch* P = new Prefetch();
  std::string p(path);
  P->worker = std::thread([P, p, offset_bytes, n_elems, dtype] {
    FILE* f = fopen(p.c_str(), "rb");
    if (!f || fseek(f, offset_bytes, SEEK_SET) != 0) {
      if (f) fclose(f);
      P->n = -1;
      return;
    }
    P->data.resize(n_elems);
    long got;
    if (dtype == 0) {
      std::vector<double> tmp(1 << 22);
      long pos = 0;
      while (pos < n_elems) {
        long want = n_elems - pos;
        if (want > (long)tmp.size()) want = tmp.size();
        long r = (long)fread(tmp.data(), sizeof(double), want, f);
        if (r <= 0) break;
        f64_to_f32(tmp.data(), P->data.data() + pos, r);
        pos += r;
      }
      got = pos;
    } else {
      got = (long)fread(P->data.data(), sizeof(float), n_elems, f);
    }
    fclose(f);
    P->n = (got == n_elems) ? got : -1;
  });
  return P;
}

long prefetch_wait(void* handle, float* dst) {
  Prefetch* P = static_cast<Prefetch*>(handle);
  if (!P) return -1;
  if (!P->joined && P->worker.joinable()) P->worker.join();
  P->joined = true;
  if (P->n > 0 && dst) std::memcpy(dst, P->data.data(), sizeof(float) * P->n);
  return P->n;
}

void prefetch_destroy(void* handle) {
  Prefetch* P = static_cast<Prefetch*>(handle);
  if (!P) return;
  if (!P->joined && P->worker.joinable()) P->worker.join();
  delete P;
}

void loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  if (!L) return;
  L->stop.store(true);
  L->cv.notify_all();
  if (L->worker.joinable()) L->worker.join();
  if (L->file) fclose(L->file);
  delete L;
}

}  // extern "C"
