// Native host-side patch gatherer (the PyTorch port's copy of
// ssdn_tpu/native/patch_sampler.cpp; the same code, so the same crops).
//
// A per-patch Python slicing loop is slow to feed a training step at batch
// 384; this C++ library does the host hot path -- deterministic random
// crop selection + memcpy gather into the batch buffer -- multithreaded,
// on a pre-built contiguous image arena. (The reference delegated this to
// torch DataLoader worker processes.)
//
// Determinism contract: out = f(seed, step, arena layout). RNG is
// counter-based splitmix64 seeded per (seed, step, j) -- no state, any
// batch recomputable, mirrored by the Python cross-check in
// tests/test_torch_native.py.
//
// Build: ssdn_tpu_torch/native/__init__.py (g++ -O3 -shared), loaded via
// ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Job {
  const uint8_t* arena;
  const int64_t* offsets;  // n_images
  const int32_t* hw;       // n_images * 2 (h, w)
  int32_t n_images;
  int32_t channels;
  uint64_t seed;
  uint64_t step;
  int32_t batch;
  int32_t patch;
  uint8_t* out;
};

void gather_range(const Job& job, int j0, int j1) {
  const int ps = job.patch;
  const int c = job.channels;
  const size_t patch_bytes = (size_t)ps * ps * c;
  for (int j = j0; j < j1; ++j) {
    // three independent draws from one per-sample stream
    uint64_t s = splitmix64(job.seed ^ splitmix64(job.step ^ splitmix64((uint64_t)j)));
    uint64_t r1 = splitmix64(s);
    uint64_t r2 = splitmix64(r1);
    uint64_t r3 = splitmix64(r2);
    int img = (int)(r1 % (uint64_t)job.n_images);
    int h = job.hw[2 * img], w = job.hw[2 * img + 1];
    int r = (int)(r2 % (uint64_t)(h - ps + 1));
    int col = (int)(r3 % (uint64_t)(w - ps + 1));
    const uint8_t* src = job.arena + job.offsets[img];
    uint8_t* dst = job.out + (size_t)j * patch_bytes;
    const size_t row_bytes = (size_t)ps * c;
    const size_t stride = (size_t)w * c;
    const uint8_t* sp = src + ((size_t)r * w + col) * c;
    for (int y = 0; y < ps; ++y) {
      std::memcpy(dst + (size_t)y * row_bytes, sp + (size_t)y * stride,
                  row_bytes);
    }
  }
}

}  // namespace

extern "C" {

void sample_patches(const uint8_t* arena, const int64_t* offsets,
                    const int32_t* hw, int32_t n_images, int32_t channels,
                    uint64_t seed, uint64_t step, int32_t batch,
                    int32_t patch, uint8_t* out, int32_t n_threads) {
  Job job{arena, offsets, hw, n_images, channels, seed, step, batch, patch,
          out};
  if (n_threads <= 1 || batch < 2 * n_threads) {
    gather_range(job, 0, batch);
    return;
  }
  std::vector<std::thread> threads;
  int per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int j0 = t * per;
    int j1 = j0 + per > batch ? batch : j0 + per;
    if (j0 >= j1) break;
    threads.emplace_back([&job, j0, j1] { gather_range(job, j0, j1); });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
