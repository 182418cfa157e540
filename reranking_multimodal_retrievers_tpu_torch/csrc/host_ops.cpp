// Host-side runtime ops of the PyTorch/CUDA port, a C++ library bound by
// ctypes (ops/host_ops.py); the same functions as the JAX package's
// native/host_ops.cpp, kept here so that the port builds its own copy.
//
//   segmented_maxsim   - packed [total_tokens x L_q] scores + doclens ->
//                        per-doc MaxSim totals, multithreaded
//   segmented_lookup   - gather variable-length token segments from packed
//                        storage
//   top_k_indices      - heap-based top-k over a score vector
//   pack_bits / unpack_bits - bit-(un)packing for a binary residual codec
//
// Built as a plain shared library with g++ (no pybind11). All pointers are
// caller-owned contiguous buffers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// Per-doc MaxSim reduction over a packed score matrix.
// scores: [total_tokens, n_query_tokens] row-major float32
// doclens: [n_docs] int32; out: [n_docs] float32
void segmented_maxsim(const float* scores, const int32_t* doclens,
                      int64_t n_docs, int64_t n_query_tokens,
                      float* out) {
  if (n_docs <= 0) return;  // empty candidate set: chunk division below
                            // would otherwise divide by zero (SIGFPE)
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  if (n_docs < n_threads) n_threads = static_cast<int>(n_docs);

  std::vector<int64_t> offsets(n_docs + 1, 0);
  for (int64_t i = 0; i < n_docs; ++i) offsets[i + 1] = offsets[i] + doclens[i];

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<float> maxes(n_query_tokens);
    for (int64_t d = lo; d < hi; ++d) {
      if (doclens[d] == 0) { out[d] = 0.0f; continue; }
      const float* row = scores + offsets[d] * n_query_tokens;
      std::memcpy(maxes.data(), row, n_query_tokens * sizeof(float));
      for (int64_t t = 1; t < doclens[d]; ++t) {
        const float* r = row + t * n_query_tokens;
        for (int64_t q = 0; q < n_query_tokens; ++q)
          maxes[q] = std::max(maxes[q], r[q]);
      }
      float total = 0.0f;
      for (int64_t q = 0; q < n_query_tokens; ++q) total += maxes[q];
      out[d] = total;
    }
  };

  std::vector<std::thread> threads;
  int64_t chunk = (n_docs + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n_docs, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Gather variable-length segments from packed storage.
// src: [total_rows, row_width] float32; offsets/lengths per requested pid;
// dst is packed output (sum(lengths) rows).
void segmented_lookup(const float* src, const int64_t* offsets,
                      const int32_t* lengths, int64_t n_segments,
                      int64_t row_width, float* dst) {
  int64_t out_off = 0;
  for (int64_t s = 0; s < n_segments; ++s) {
    std::memcpy(dst + out_off * row_width, src + offsets[s] * row_width,
                static_cast<size_t>(lengths[s]) * row_width * sizeof(float));
    out_off += lengths[s];
  }
}

// Heap top-k: writes the indices of the k largest scores in descending order.
void top_k_indices(const float* scores, int64_t n, int64_t k, int64_t* out) {
  if (k > n) k = n;
  using Pair = std::pair<float, int64_t>;
  std::priority_queue<Pair, std::vector<Pair>, std::greater<Pair>> heap;
  for (int64_t i = 0; i < n; ++i) {
    if (static_cast<int64_t>(heap.size()) < k) {
      heap.emplace(scores[i], i);
    } else if (scores[i] > heap.top().first) {
      heap.pop();
      heap.emplace(scores[i], i);
    }
  }
  for (int64_t i = k - 1; i >= 0; --i) {
    out[i] = heap.top().second;
    heap.pop();
  }
}

// Pack binary values (0/1 bytes) into bits, MSB-first per byte.
void pack_bits(const uint8_t* bits, int64_t n, uint8_t* out) {
  int64_t n_bytes = (n + 7) / 8;
  std::memset(out, 0, n_bytes);
  for (int64_t i = 0; i < n; ++i)
    if (bits[i]) out[i / 8] |= static_cast<uint8_t>(1u << (7 - (i % 8)));
}

void unpack_bits(const uint8_t* packed, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (packed[i / 8] >> (7 - (i % 8))) & 1u;
}

}  // extern "C"
