// Native CPU backend of the PyTorch port: the job's `--backend native`, the
// fast path of its CSV readers and the C++ brute force the benchmark times
// as its baseline.  A copy of the JAX package's knn_tpu/native/src/
// knn_native.cpp, line for line in every function.
//
// A fresh implementation of the reference program's semantics
// (brute-force KNN classification: distance fill -> top-k select ->
// majority vote -> accuracy; cf. knn_mpi.cpp:33-84,308-393) with a modern
// shape: a C API exported from a shared library, query-shard parallelism
// via std::thread (each thread plays the role an MPI rank plays in the
// reference, cf. MPI_Scatter knn_mpi.cpp:226-227), a heap-based top-k
// select instead of the reference's full std::sort (knn_mpi.cpp:323,366),
// and the framework's deterministic tie-break: the k-nearest set is the
// lexicographically smallest k (distance, index) pairs, matching
// knn_tpu_torch.ops.topk exactly.
//
// Differences from the reference, by design:
//   - extrema init at +/-inf, not {-1, 999999} (fixes knn_mpi.cpp:241-242)
//   - no memory leaks (the reference never frees; knn_mpi.cpp:326,369)
//   - out-of-range labels are rejected, not an OOB write (knn_mpi.cpp:330)
//
// Built by the Makefile next to this file into knn_tpu_torch/_build/ at
// first use; bound from Python with ctypes (knn_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// Metric codes shared with the Python binding.
enum KnnMetric : int32_t {
  KNN_METRIC_SQL2 = 0,   // squared L2 (ranking-equivalent to Euclidean)
  KNN_METRIC_L1 = 1,     // Manhattan
  KNN_METRIC_COSINE = 2, // 1 - cosine similarity
  KNN_METRIC_DOT = 3,    // negative inner product
};

}  // extern "C"

namespace {

struct Candidate {
  double dist;
  int64_t index;
  // Lexicographic (dist, index): the framework-wide tie-break contract.
  bool operator<(const Candidate& o) const {
    return dist < o.dist || (dist == o.dist && index < o.index);
  }
};

double squared_l2(const float* q, const float* t, int64_t dim) {
  double acc = 0.0;
  for (int64_t d = 0; d < dim; ++d) {
    const double diff = static_cast<double>(q[d]) - static_cast<double>(t[d]);
    acc += diff * diff;
  }
  return acc;
}

double manhattan(const float* q, const float* t, int64_t dim) {
  double acc = 0.0;
  for (int64_t d = 0; d < dim; ++d) {
    acc += std::fabs(static_cast<double>(q[d]) - static_cast<double>(t[d]));
  }
  return acc;
}

double dot(const float* q, const float* t, int64_t dim) {
  double acc = 0.0;
  for (int64_t d = 0; d < dim; ++d) {
    acc += static_cast<double>(q[d]) * static_cast<double>(t[d]);
  }
  return acc;
}

double norm(const float* x, int64_t dim) {
  return std::sqrt(dot(x, x, dim));
}

double distance(int32_t metric, const float* q, const float* t, int64_t dim) {
  switch (metric) {
    case KNN_METRIC_SQL2:
      return squared_l2(q, t, dim);
    case KNN_METRIC_L1:
      return manhattan(q, t, dim);
    case KNN_METRIC_COSINE: {
      const double nq = norm(q, dim), nt = norm(t, dim);
      const double denom = std::max(nq * nt, 1e-24);
      return 1.0 - dot(q, t, dim) / denom;
    }
    case KNN_METRIC_DOT:
      return -dot(q, t, dim);
    default:
      return std::numeric_limits<double>::quiet_NaN();
  }
}

int resolve_threads(int32_t num_threads) {
  if (num_threads > 0) return num_threads;
  const unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 1;
}

// Run fn(first_row, last_row) over [0, n) split into contiguous shards —
// the thread-level analogue of the reference's per-rank query shards.
template <typename Fn>
void parallel_rows(int64_t n, int threads, Fn fn) {
  threads = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(threads, n)));
  if (threads == 1) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  const int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// Exact top-k of one query row: max-heap of size k ordered by the
// lexicographic Candidate comparator; replaces the reference's full
// O(N log N) std::sort per query with O(N log k).
void topk_row(const float* query, const float* train, int64_t n_train,
              int64_t dim, int64_t k, int32_t metric,
              std::vector<Candidate>& heap) {
  heap.clear();
  for (int64_t j = 0; j < n_train; ++j) {
    Candidate c{distance(metric, query, train + j * dim, dim), j};
    if (static_cast<int64_t>(heap.size()) < k) {
      heap.push_back(c);
      std::push_heap(heap.begin(), heap.end());
    } else if (c < heap.front()) {
      std::pop_heap(heap.begin(), heap.end());
      heap.back() = c;
      std::push_heap(heap.begin(), heap.end());
    }
  }
  std::sort_heap(heap.begin(), heap.end());  // ascending (dist, index)
}

// First-label-to-reach-the-final-max vote over neighbors in ascending
// (dist, index) order — the reference's running argmax with strict '>'
// (knn_mpi.cpp:324-336).
int32_t vote(const std::vector<Candidate>& neighbors, const int32_t* labels,
             int32_t num_classes, std::vector<int32_t>& counts) {
  counts.assign(num_classes, 0);
  int32_t best_label = -1;
  int32_t best_count = 0;
  for (const Candidate& c : neighbors) {
    const int32_t lab = labels[c.index];
    if (lab < 0 || lab >= num_classes) return -1;  // reject, don't corrupt
    if (++counts[lab] > best_count) {
      best_count = counts[lab];
      best_label = lab;
    }
  }
  return best_label;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// KNN search: out_dist/out_idx are [n_queries, k] row-major. Returns 0 on
// success, nonzero on bad arguments.
int32_t knn_native_search(const float* train, int64_t n_train, int64_t dim,
                          const float* queries, int64_t n_queries, int64_t k,
                          int32_t metric, int32_t num_threads,
                          double* out_dist, int64_t* out_idx) {
  if (!train || !queries || !out_dist || !out_idx) return 1;
  if (k < 1 || k > n_train || dim < 1 || n_queries < 0) return 2;
  const int threads = resolve_threads(num_threads);
  parallel_rows(n_queries, threads, [&](int64_t lo, int64_t hi) {
    std::vector<Candidate> heap;
    heap.reserve(k);
    for (int64_t i = lo; i < hi; ++i) {
      topk_row(queries + i * dim, train, n_train, dim, k, metric, heap);
      for (int64_t j = 0; j < k; ++j) {
        out_dist[i * k + j] = heap[j].dist;
        out_idx[i * k + j] = heap[j].index;
      }
    }
  });
  return 0;
}

// KNN classification: predicted labels in out_labels [n_queries]. Returns 0
// on success; 3 if any training label is outside [0, num_classes).
int32_t knn_native_predict(const float* train, const int32_t* labels,
                           int64_t n_train, int64_t dim, const float* queries,
                           int64_t n_queries, int64_t k, int32_t num_classes,
                           int32_t metric, int32_t num_threads,
                           int32_t* out_labels) {
  if (!train || !labels || !queries || !out_labels) return 1;
  if (k < 1 || k > n_train || dim < 1 || num_classes < 1) return 2;
  for (int64_t j = 0; j < n_train; ++j) {
    if (labels[j] < 0 || labels[j] >= num_classes) return 3;
  }
  std::atomic<int32_t> status{0};
  const int threads = resolve_threads(num_threads);
  parallel_rows(n_queries, threads, [&](int64_t lo, int64_t hi) {
    std::vector<Candidate> heap;
    heap.reserve(k);
    std::vector<int32_t> counts;
    for (int64_t i = lo; i < hi; ++i) {
      topk_row(queries + i * dim, train, n_train, dim, k, metric, heap);
      const int32_t lab = vote(heap, labels, num_classes, counts);
      if (lab < 0) status.store(3);
      out_labels[i] = lab;
    }
  });
  return status.load();
}

// Per-dimension running extrema over one array; call repeatedly to fold in
// train/test/val for the reference's transductive normalization
// (knn_mpi.cpp:245-274). Initialize io_min to +inf and io_max to -inf.
int32_t knn_native_minmax(const float* data, int64_t n, int64_t dim,
                          float* io_min, float* io_max) {
  if (!data || !io_min || !io_max || dim < 1) return 1;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = data + i * dim;
    for (int64_t d = 0; d < dim; ++d) {
      io_min[d] = std::min(io_min[d], row[d]);
      io_max[d] = std::max(io_max[d], row[d]);
    }
  }
  return 0;
}

// In-place min-max rescale; constant dims (max == min) pass through
// untouched (the knn_mpi.cpp:284 guard).
int32_t knn_native_minmax_apply(float* data, int64_t n, int64_t dim,
                                const float* mins, const float* maxs) {
  if (!data || !mins || !maxs || dim < 1) return 1;
  for (int64_t d = 0; d < dim; ++d) {
    const float range = maxs[d] - mins[d];
    if (range == 0.0f) continue;
    for (int64_t i = 0; i < n; ++i) {
      data[i * dim + d] = (data[i * dim + d] - mins[d]) / range;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Fast CSV parse: comma-separated floats, one row per line, uniform width.
// On success fills *out_rows/*out_cols and returns a malloc'd row-major
// float buffer the caller releases with knn_native_free. Returns nullptr on
// I/O error, ragged rows, or parse failure (*out_rows carries an error
// code: -1 io, -2 ragged, -3 parse, -4 empty).
float* knn_native_read_csv(const char* path, int64_t* out_rows,
                           int64_t* out_cols) {
  *out_rows = -1;
  *out_cols = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  // ftell returns -1 on non-seekable files; size_t(-1) would then be
  // passed to fread against a 0-byte buffer
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return nullptr;
  }
  const long size = std::ftell(f);
  if (size < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    std::fclose(f);
    return nullptr;
  }
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  const size_t got = std::fread(buf.data(), 1, size, f);
  std::fclose(f);
  if (static_cast<long>(got) != size) return nullptr;
  buf[got] = '\0';

  std::vector<float> values;
  values.reserve(1 << 16);
  int64_t cols = -1, rows = 0;
  const char* p = buf.data();
  const char* end = buf.data() + got;
  while (p < end) {
    // one line
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    // skip blank lines
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == line_end) {
      p = line_end + 1;
      continue;
    }
    int64_t row_cols = 0;
    while (p < line_end) {
      char* next = nullptr;
      const float v = std::strtof(p, &next);
      if (next == p) {
        *out_rows = -3;
        return nullptr;
      }
      values.push_back(v);
      ++row_cols;
      p = next;
      while (p < line_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p < line_end) {
        if (*p != ',') {
          *out_rows = -3;
          return nullptr;
        }
        ++p;  // past comma
        if (p >= line_end) {  // trailing comma = empty field, like the
          *out_rows = -3;     // python fallback rejects
          return nullptr;
        }
      }
    }
    if (cols < 0) {
      cols = row_cols;
    } else if (row_cols != cols) {
      *out_rows = -2;
      return nullptr;
    }
    ++rows;
    p = line_end + 1;
  }
  if (rows == 0 || cols <= 0) {
    *out_rows = -4;
    return nullptr;
  }
  float* out = static_cast<float*>(std::malloc(values.size() * sizeof(float)));
  if (!out) return nullptr;
  std::memcpy(out, values.data(), values.size() * sizeof(float));
  *out_rows = rows;
  *out_cols = cols;
  return out;
}

void knn_native_free(void* ptr) { std::free(ptr); }

// Classification accuracy — acc_calc (knn_mpi.cpp:69-84).
double knn_native_accuracy(const int32_t* pred, const int32_t* real,
                           int64_t n) {
  if (!pred || !real || n <= 0) return 0.0;
  int64_t hits = 0;
  for (int64_t i = 0; i < n; ++i) hits += (pred[i] == real[i]);
  return static_cast<double>(hits) / static_cast<double>(n);
}

int32_t knn_native_version() { return 1; }

}  // extern "C"
