// himo_native — host-side runtime primitives for the himo_tpu framework.
//
// The GPU owns the per-point compute path; this library owns the host hot
// loops around it (the roles the reference delegates to scipy cKDTree /
// mmcv CUDA / Python file IO):
//   * a bucketed 3-D KD-tree with multi-threaded nearest-neighbor queries
//     (eval-time Chamfer, SSL dynamic-point labeling),
//   * symmetric Chamfer distance in one call,
//   * raw attribute-file readers for Scania superframes,
//   * a multi-threaded pad-and-stack batch packer feeding the device.
//
// C ABI only; Python binds via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kLeafSize = 16;

// Bucketed KD-tree: points are reordered into contiguous storage; leaves
// hold [lo, hi) ranges scanned linearly (cache/SIMD friendly).
struct KDTree {
  std::vector<float> pts;    // 3 * n, reordered
  std::vector<int32_t> ids;  // n, original row of each reordered point
  struct Node {
    float split;
    int16_t axis;  // -1 for leaf
    int32_t left, right;  // children (internal) or
    int32_t lo, hi;       // range (leaf)
  };
  std::vector<Node> nodes;
  int32_t root = -1;
};

int32_t build(KDTree& t, int lo, int hi) {
  KDTree::Node node{};
  const int32_t id = static_cast<int32_t>(t.nodes.size());
  t.nodes.push_back(node);
  if (hi - lo <= kLeafSize) {
    t.nodes[id] = {0.f, -1, -1, -1, lo, hi};
    return id;
  }
  // Split on the axis with the largest extent.
  float mins[3] = {1e30f, 1e30f, 1e30f}, maxs[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = lo; i < hi; ++i) {
    for (int a = 0; a < 3; ++a) {
      const float v = t.pts[3 * i + a];
      mins[a] = std::min(mins[a], v);
      maxs[a] = std::max(maxs[a], v);
    }
  }
  int axis = 0;
  for (int a = 1; a < 3; ++a) {
    if (maxs[a] - mins[a] > maxs[axis] - mins[axis]) axis = a;
  }
  const int mid = (lo + hi) / 2;
  // Sort index ranges by rearranging interleaved storage via an index pass.
  std::vector<int32_t> order(hi - lo);
  for (int i = 0; i < hi - lo; ++i) order[i] = lo + i;
  std::nth_element(order.begin(), order.begin() + (mid - lo), order.end(),
                   [&](int32_t a, int32_t b) {
                     return t.pts[3 * a + axis] < t.pts[3 * b + axis];
                   });
  // Apply the permutation to pts/ids within [lo, hi).
  std::vector<float> tmp_pts(3 * (hi - lo));
  std::vector<int32_t> tmp_ids(hi - lo);
  for (int i = 0; i < hi - lo; ++i) {
    std::memcpy(&tmp_pts[3 * i], &t.pts[3 * order[i]], 12);
    tmp_ids[i] = t.ids[order[i]];
  }
  std::memcpy(&t.pts[3 * lo], tmp_pts.data(), tmp_pts.size() * 4);
  std::memcpy(&t.ids[lo], tmp_ids.data(), tmp_ids.size() * 4);

  const float split = t.pts[3 * mid + axis];
  const int32_t left = build(t, lo, mid);
  const int32_t right = build(t, mid, hi);
  t.nodes[id] = {split, static_cast<int16_t>(axis), left, right, -1, -1};
  return id;
}

inline float sq(float v) { return v * v; }

void query_one(const KDTree& t, const float* q, float* best_d2,
               int32_t* best_idx) {
  float best = std::numeric_limits<float>::max();
  int32_t best_i = -1;
  // (node, axis-distance^2) stack.
  struct Entry {
    int32_t node;
    float bound;
  };
  Entry stack[128];
  int top = 0;
  stack[top++] = {t.root, 0.f};
  while (top > 0) {
    const Entry e = stack[--top];
    if (e.bound >= best) continue;
    const KDTree::Node& n = t.nodes[e.node];
    if (n.axis < 0) {
      for (int i = n.lo; i < n.hi; ++i) {
        const float d2 = sq(q[0] - t.pts[3 * i]) + sq(q[1] - t.pts[3 * i + 1]) +
                         sq(q[2] - t.pts[3 * i + 2]);
        if (d2 < best) {
          best = d2;
          best_i = t.ids[i];
        }
      }
      continue;
    }
    const float delta = q[n.axis] - n.split;
    const int32_t near = delta <= 0 ? n.left : n.right;
    const int32_t far = delta <= 0 ? n.right : n.left;
    if (top < 126) {
      stack[top++] = {far, sq(delta)};
      stack[top++] = {near, e.bound};
    }
  }
  *best_d2 = best;
  *best_idx = best_i;
}

void parallel_for(int n, int nthreads, const std::function<void(int, int)>& fn,
                  int min_per_call = 2048) {
  if (nthreads <= 1 || n < min_per_call) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int lo = t * chunk;
    const int hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

KDTree* kd_build(const float* pts, int32_t n) {
  auto* t = new KDTree();
  t->pts.resize(3 * static_cast<size_t>(n));
  std::memcpy(t->pts.data(), pts, 12 * static_cast<size_t>(n));
  t->ids.resize(n);
  for (int32_t i = 0; i < n; ++i) t->ids[i] = i;
  t->nodes.reserve(2 * n / kLeafSize + 8);
  t->root = build(*t, 0, n);
  return t;
}

}  // namespace

extern "C" {

void* himo_kd_build(const float* pts, int32_t n) { return kd_build(pts, n); }

void himo_kd_free(void* handle) { delete static_cast<KDTree*>(handle); }

void himo_kd_query(const void* handle, const float* queries, int32_t nq,
                   float* out_d2, int32_t* out_idx, int32_t nthreads) {
  const auto* tree = static_cast<const KDTree*>(handle);
  parallel_for(nq, nthreads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      query_one(*tree, queries + 3 * i, out_d2 + i, out_idx + i);
    }
  });
}

// k-nearest: per-query sorted insertion into a k-slot buffer (k is small —
// the coherence votes / smoothed-chamfer losses use k <= 8), same pruned
// traversal as query_one with the bound = current k-th best.
void himo_kd_query_k(const void* handle, const float* queries, int32_t nq,
                     int32_t k, float* out_d2, int32_t* out_idx,
                     int32_t nthreads) {
  const auto* tree = static_cast<const KDTree*>(handle);
  parallel_for(nq, nthreads, [&](int lo, int hi) {
    std::vector<float> bd(k);
    std::vector<int32_t> bi(k);
    for (int i = lo; i < hi; ++i) {
      const float* q = queries + 3 * i;
      int filled = 0;
      float bound = std::numeric_limits<float>::max();
      struct Entry {
        int32_t node;
        float bound;
      };
      Entry stack[128];
      int top = 0;
      stack[top++] = {tree->root, 0.f};
      while (top > 0) {
        const Entry e = stack[--top];
        if (e.bound >= bound) continue;
        const KDTree::Node& n = tree->nodes[e.node];
        if (n.axis < 0) {
          for (int p = n.lo; p < n.hi; ++p) {
            const float d2 = sq(q[0] - tree->pts[3 * p]) +
                             sq(q[1] - tree->pts[3 * p + 1]) +
                             sq(q[2] - tree->pts[3 * p + 2]);
            if (d2 >= bound) continue;
            int at = filled < k ? filled : k - 1;
            while (at > 0 && bd[at - 1] > d2) {
              if (at < k) {
                bd[at] = bd[at - 1];
                bi[at] = bi[at - 1];
              }
              --at;
            }
            bd[at] = d2;
            bi[at] = tree->ids[p];
            if (filled < k) ++filled;
            if (filled == k) bound = bd[k - 1];
          }
          continue;
        }
        const float delta = q[n.axis] - n.split;
        const int32_t near = delta <= 0 ? n.left : n.right;
        const int32_t far = delta <= 0 ? n.right : n.left;
        if (top < 126) {
          stack[top++] = {far, sq(delta)};
          stack[top++] = {near, e.bound};
        }
      }
      for (int j = 0; j < k; ++j) {
        out_d2[static_cast<int64_t>(i) * k + j] =
            j < filled ? bd[j] : std::numeric_limits<float>::max();
        out_idx[static_cast<int64_t>(i) * k + j] = j < filled ? bi[j] : -1;
      }
    }
  });
}

// Symmetric mean-NN chamfer: out[0] = mean d(a->b), out[1] = mean d(b->a)
// (distances, not squared — matching the eval definition).
void himo_chamfer(const float* a, int32_t na, const float* b, int32_t nb,
                  double* out, int32_t nthreads) {
  if (na == 0 || nb == 0) {
    out[0] = out[1] = std::nan("");
    return;
  }
  KDTree* tb = kd_build(b, nb);
  KDTree* ta = kd_build(a, na);
  std::vector<float> d2(std::max(na, nb));
  std::vector<int32_t> idx(std::max(na, nb));
  himo_kd_query(tb, a, na, d2.data(), idx.data(), nthreads);
  double sum_ab = 0;
  for (int i = 0; i < na; ++i) sum_ab += std::sqrt(static_cast<double>(d2[i]));
  himo_kd_query(ta, b, nb, d2.data(), idx.data(), nthreads);
  double sum_ba = 0;
  for (int i = 0; i < nb; ++i) sum_ba += std::sqrt(static_cast<double>(d2[i]));
  out[0] = sum_ab / na;
  out[1] = sum_ba / nb;
  delete ta;
  delete tb;
}

// Raw attribute reader: returns elements read, -1 on error. dtype codes:
// 0 = float32, 1 = int32, 2 = int8 (widened to int32 in out).
int64_t himo_read_attr(const char* path, int32_t dtype_code, void* out,
                       int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int64_t count = 0;
  if (dtype_code == 0 || dtype_code == 1) {
    count = bytes / 4;
    if (count > capacity) count = capacity;
    count = static_cast<int64_t>(std::fread(out, 4, count, f));
  } else if (dtype_code == 2) {
    count = bytes;
    if (count > capacity) count = capacity;
    std::vector<int8_t> tmp(count);
    count = static_cast<int64_t>(std::fread(tmp.data(), 1, count, f));
    int32_t* dst = static_cast<int32_t*>(out);
    for (int64_t i = 0; i < count; ++i) dst[i] = tmp[i];
  } else {
    count = -1;
  }
  std::fclose(f);
  return count;
}

// Pad-and-stack batch packer: frames[i] is an (ns[i], cols) float32 row-major
// array; writes a (nframes, target, cols) batch (zero padding) and a
// (nframes, target) uint8 valid mask. Multi-threaded over frames.
void himo_pack_frames(const float** frames, const int32_t* ns, int32_t nframes,
                      int32_t cols, int32_t target, float* out_batch,
                      uint8_t* out_valid, int32_t nthreads) {
  parallel_for(
      nframes, std::max(1, std::min(nthreads, nframes)),
      [&](int lo, int hi) {
                 for (int i = lo; i < hi; ++i) {
                   const int32_t n = std::min(ns[i], target);
                   float* dst =
                       out_batch + static_cast<int64_t>(i) * target * cols;
                   std::memcpy(dst, frames[i],
                               static_cast<size_t>(n) * cols * 4);
                   std::memset(dst + static_cast<int64_t>(n) * cols, 0,
                               static_cast<size_t>(target - n) * cols * 4);
        uint8_t* v = out_valid + static_cast<int64_t>(i) * target;
        std::memset(v, 1, n);
        std::memset(v + n, 0, target - n);
        }
      },
      /*min_per_call=*/2);
}

}  // extern "C"

// ---------------------------------------------------------------- preload
// Warm the page cache for upcoming scene files (the fleet / trainer host
// loops read whole .h5 scenes; overlapping the NEXT scene's disk I/O with
// the current batch's compute hides cold-cache latency). Reads are issued
// through io_uring (raw syscalls — the image ships no liburing) into one
// discarded scratch buffer: the useful side effect is the kernel filling
// the page cache. Falls back to posix_fadvise(WILLNEED) when io_uring is
// unavailable (seccomp'd containers).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <linux/io_uring.h>

namespace {

constexpr uint32_t kChunk = 1 << 20;  // 1 MiB read units

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                  min_complete, flags, nullptr, 0));
}

struct Ring {
  int fd = -1;
  uint8_t* sq = nullptr;
  size_t sq_len = 0;
  uint8_t* cq = nullptr;
  size_t cq_len = 0;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_len = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned sq_mask = 0;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned cq_mask = 0;
  io_uring_cqe* cqes = nullptr;

  bool open(unsigned entries) {
    io_uring_params p{};
    fd = sys_io_uring_setup(entries, &p);
    if (fd < 0) return false;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    sq = static_cast<uint8_t*>(mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                                    MAP_SHARED | MAP_POPULATE, fd,
                                    IORING_OFF_SQ_RING));
    cq = static_cast<uint8_t*>(mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                                    MAP_SHARED | MAP_POPULATE, fd,
                                    IORING_OFF_CQ_RING));
    sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    sqes = static_cast<io_uring_sqe*>(
        mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
    if (sq == MAP_FAILED || cq == MAP_FAILED || sqes == MAP_FAILED) {
      close_all();
      return false;
    }
    sq_head = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = *reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = *reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(cq + p.cq_off.cqes);
    return true;
  }

  void close_all() {
    if (sq && sq != MAP_FAILED) munmap(sq, sq_len);
    if (cq && cq != MAP_FAILED) munmap(cq, cq_len);
    if (sqes && sqes != reinterpret_cast<io_uring_sqe*>(MAP_FAILED))
      munmap(sqes, sqes_len);
    if (fd >= 0) close(fd);
    fd = -1;
  }
};

}  // namespace

extern "C" int64_t himo_preload_files(const char** paths, int32_t n_paths,
                                      int32_t queue_depth) {
  if (queue_depth < 1) queue_depth = 32;
  if (queue_depth > 256) queue_depth = 256;
  Ring ring;
  const bool have_uring = ring.open(static_cast<unsigned>(queue_depth));
  int64_t total = 0;
  std::vector<uint8_t> scratch(kChunk);
  for (int32_t i = 0; i < n_paths; ++i) {
    const int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) continue;
    struct stat st{};
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
      close(fd);
      continue;
    }
    if (!have_uring) {
      posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
      total += st.st_size;
      close(fd);
      continue;
    }
    int64_t off = 0;
    unsigned inflight = 0;
    while (off < st.st_size || inflight > 0) {
      // Fill the submission queue.
      unsigned submitted = 0;
      while (off < st.st_size &&
             inflight < static_cast<unsigned>(queue_depth)) {
        const unsigned tail = __atomic_load_n(ring.sq_tail, __ATOMIC_ACQUIRE);
        const unsigned ix = tail & ring.sq_mask;
        io_uring_sqe& s = ring.sqes[ix];
        std::memset(&s, 0, sizeof(s));
        s.opcode = IORING_OP_READ;
        s.fd = fd;
        s.addr = reinterpret_cast<uint64_t>(scratch.data());
        s.len = static_cast<uint32_t>(
            std::min<int64_t>(kChunk, st.st_size - off));
        s.off = static_cast<uint64_t>(off);
        ring.sq_array[ix] = ix;
        __atomic_store_n(ring.sq_tail, tail + 1, __ATOMIC_RELEASE);
        off += s.len;
        ++inflight;
        ++submitted;
      }
      const int got = sys_io_uring_enter(ring.fd, submitted, 1,
                                         IORING_ENTER_GETEVENTS);
      if (got < 0) {  // unexpected mid-stream failure: fall back
        posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
        break;
      }
      // Drain completions.
      unsigned head = __atomic_load_n(ring.cq_head, __ATOMIC_ACQUIRE);
      const unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
      while (head != tail) {
        const io_uring_cqe& c = ring.cqes[head & ring.cq_mask];
        if (c.res > 0) total += c.res;
        ++head;
        --inflight;
      }
      __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
    }
    close(fd);
  }
  ring.close_all();
  return total;
}

