// Native batching runtime: pack variable-length dialogue features into
// padded, static-shape batch tensors.
//
// This is the host-side hot loop of the input pipeline (the reference
// leans on torch DataLoader's C++ workers + default_collate for the same
// job; mmbase.py:344-455 does the padding in python).  Multi-threaded
// row-wise memcpy: each worker packs a slice of the batch.
//
// Built at first use by erc_tpu_torch/ops/kernels/build.py::build_host
// (g++ -O3 -shared -fPIC -pthread); bound by erc_tpu_torch/data/native.py.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Pack B variable-length [len_i, D] float32 feature arrays into a
// zero-initialized [B, L, D] buffer. srcs[i] points at sample i's data.
void pack_rows(const float** srcs, const int32_t* lens, int32_t B,
               int32_t L, int32_t D, float* dst, int32_t n_threads) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; ++i) {
      const int32_t n = std::min(lens[i], L);
      if (n > 0 && srcs[i] != nullptr) {
        std::memcpy(dst + (size_t)i * L * D, srcs[i], (size_t)n * D * sizeof(float));
      }
      // zero the padded tail
      std::memset(dst + ((size_t)i * L + n) * D, 0, (size_t)(L - n) * D * sizeof(float));
    }
  };
  if (n_threads <= 1 || B < 4) {
    work(0, B);
    return;
  }
  n_threads = std::min<int32_t>(n_threads, B);
  std::vector<std::thread> ts;
  const int32_t chunk = (B + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int32_t lo = t * chunk, hi = std::min(B, lo + chunk);
    if (lo < hi) ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Pack int32 label rows with a fill value for padding.
void pack_labels(const int32_t** srcs, const int32_t* lens, int32_t B,
                 int32_t L, int32_t fill, int32_t* dst) {
  for (int32_t i = 0; i < B; ++i) {
    const int32_t n = std::min(lens[i], L);
    if (n > 0 && srcs[i] != nullptr) {
      std::memcpy(dst + (size_t)i * L, srcs[i], (size_t)n * sizeof(int32_t));
    }
    for (int32_t j = n; j < L; ++j) dst[(size_t)i * L + j] = fill;
  }
}

// Build the [B, L] validity mask from lengths.
void fill_mask(const int32_t* lens, int32_t B, int32_t L, float* dst) {
  for (int32_t i = 0; i < B; ++i) {
    const int32_t n = std::min(lens[i], L);
    for (int32_t j = 0; j < n; ++j) dst[(size_t)i * L + j] = 1.0f;
    std::memset(dst + (size_t)i * L + n, 0, (size_t)(L - n) * sizeof(float));
  }
}

}  // extern "C"
