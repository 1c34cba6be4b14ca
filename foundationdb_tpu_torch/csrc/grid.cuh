// Helpers that block.cu, compact.cu and rankfed.cu share: int32
// arithmetic as XLA's, tpu.py's gather and scatter index rules, warp and
// block prefix sums, a grid-stride loop over a cooperative grid, prefix
// sums across the grid (TupleScan), the launch of one cooperative grid on
// the caller's stream, and the range maxima that answer tpu.py's
// sparse-table query without its table.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdb {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInf = INT32_MAX;      // pad key word, pad length
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);  // int32 wrap, as XLA's
}

// A gather index as tpu.py's gathers take it: a negative index wraps
// once, then the index clamps into [0, n).
__device__ __forceinline__ long long gat(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// A scatter index as tpu.py's scatters take it: a negative index wraps
// once; -1 where the update drops.
__device__ __forceinline__ long long sct(long long i, long long n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// A load of what another block of the grid may have written before the
// last grid barrier (past L1).
__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldcg(p); }

__device__ __forceinline__ int32_t warp_incl(int32_t v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = add32(v, t);
  }
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v = add32(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Exclusive prefixes of K values a thread over the block (every thread
// calls it): ex[c] gets value c's prefix, tot[c] its block sum. ws holds
// K * kWarps words of shared memory.
template <int K>
__device__ void block_excl_k(const int32_t* v, int32_t* ex, int32_t* tot,
                             int32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc[K];
  for (int c = 0; c < K; ++c) {
    inc[c] = warp_incl(v[c]);
    if (lane == 31) ws[c * kWarps + warp] = inc[c];
  }
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < K; ++c) {
      int32_t w = lane < kWarps ? ws[c * kWarps + lane] : 0;
      w = warp_incl(w);
      if (lane < kWarps) ws[c * kWarps + lane] = w;
    }
  }
  __syncthreads();
  for (int c = 0; c < K; ++c) {
    const int32_t before = warp ? ws[c * kWarps + warp - 1] : 0;
    tot[c] = ws[c * kWarps + kWarps - 1];
    ex[c] = add32(before, inc[c] - v[c]);
  }
  __syncthreads();  // ws is free for the next call
}

// Exclusive prefix of one value a thread over the block; ws holds kWarps
// words of shared memory; *total gets the sum.
__device__ __forceinline__ int32_t block_excl(int32_t v, int32_t* ws,
                                              int32_t* total) {
  int32_t ex;
  block_excl_k<1>(&v, &ex, total, ws);
  return ex;
}

struct Grid {
  long long first, stride;
  __device__ Grid()
      : first((long long)blockIdx.x * blockDim.x + threadIdx.x),
        stride((long long)gridDim.x * blockDim.x) {}
  template <class F> __device__ void each(long long n, F f) const {
    for (long long i = first; i < n; i += stride) f(i);
  }
  __device__ void sync() const { cg::this_grid().sync(); }
  __device__ bool leader() const { return first == 0; }
};

// Exclusive prefix sums over n elements of K int32 values each, across
// the grid, in three stages the caller separates by grid barriers:
// tiles_stage (each tile's sums), sums_stage (the tile sums' prefixes in
// place, and the totals after them), apply_stage (each element's
// prefixes, to put). val(i, v) fills element i's K values; it must give
// the same values in both stages that call it. Value c's tile sums and
// total take tiles(n) + 1 words of tsum from c * (tiles(n) + 1).
template <int K>
struct TupleScan {
  long long n;
  __host__ __device__ static long long tiles(long long n) {
    return (n + kThreads - 1) / kThreads;
  }
  __host__ __device__ static long long words(long long n) {
    return K * (tiles(n) + 1);
  }
  __device__ int32_t total(const int32_t* tsum, int c) const {
    return ld(tsum + c * (tiles(n) + 1) + tiles(n));
  }
  template <class V>
  __device__ void tiles_stage(int32_t* tsum, int32_t* ws, V val) const {
    const long long nt = tiles(n);
    for (long long b = blockIdx.x; b < nt; b += gridDim.x) {
      const long long i = b * kThreads + threadIdx.x;
      int32_t v[K], ex[K], tot[K];
      for (int c = 0; c < K; ++c) v[c] = 0;
      if (i < n) val(i, v);
      block_excl_k<K>(v, ex, tot, ws);
      if (threadIdx.x == 0)
        for (int c = 0; c < K; ++c) tsum[c * (nt + 1) + b] = tot[c];
    }
  }
  __device__ void sums_stage(int32_t* tsum, int32_t* ws) const {
    const long long nt = tiles(n);
    for (int c = blockIdx.x; c < K; c += gridDim.x) {
      int32_t* t = tsum + c * (nt + 1);
      int32_t carry = 0;
      for (long long b = 0; b < nt; b += kThreads) {
        const long long i = b + threadIdx.x;
        const int32_t v = i < nt ? ld(t + i) : 0;
        int32_t tot;
        const int32_t ex = block_excl(v, ws, &tot);
        if (i < nt) t[i] = add32(carry, ex);
        carry = add32(carry, tot);
      }
      if (threadIdx.x == 0) t[nt] = carry;
    }
  }
  template <class V, class P>
  __device__ void apply_stage(const int32_t* tsum, int32_t* ws, V val,
                              P put) const {
    const long long nt = tiles(n);
    for (long long b = blockIdx.x; b < nt; b += gridDim.x) {
      const long long i = b * kThreads + threadIdx.x;
      int32_t v[K], ex[K], tot[K];
      for (int c = 0; c < K; ++c) v[c] = 0;
      if (i < n) val(i, v);
      block_excl_k<K>(v, ex, tot, ws);
      if (i < n) {
        for (int c = 0; c < K; ++c)
          ex[c] = add32(ld(tsum + c * (nt + 1) + b), ex[c]);
        put(i, v, ex);
      }
    }
  }
};

// Range-maximum levels over a version row of C slots, in place of tpu.py's
// (log C + 1) x C max table (`_build_table`): level 0 is the row, level
// l + 1 folds kFan slots of level l, up to a level of at most kFan slots
// (C / 31 words in all). `window_max` answers `_table_range_query` over
// [lo, hi) from them: its two power-of-two windows, a window past C
// taking the identity 0, an empty range giving 0, lo and hi - window
// clipped into [0, C).
constexpr int kFan = 32;  // slots a range-maximum level folds

struct Levels {
  int n;                      // levels past 0
  long long C;
  long long size[8], off[8];  // level l's slots, and its offset in the
                              // level words for l >= 1
  __host__ __device__ void init(long long C_) {
    C = C_;
    n = 0;
    long long s = C, o = 0;
    size[0] = C;
    while (s > kFan && n < 7) {
      s = (s + kFan - 1) / kFan;
      ++n;
      size[n] = s;
      off[n] = o;
      o += s;
    }
  }
  __host__ __device__ long long words() const {
    long long w = 0;
    for (int l = 1; l <= n; ++l) w += size[l];
    return w;
  }
  // Levels 1..n of the row hv into lvls (words() ints), one grid stage
  // and barrier a level (one barrier where there is no level).
  __device__ void build(const Grid& g, const int32_t* hv,
                        int32_t* lvls) const {
    for (int l = 1; l <= n; ++l) {
      const int32_t* src = l > 1 ? lvls + off[l - 1] : hv;
      const long long n_src = size[l - 1];
      g.each(size[l], [&](long long i) {
        int32_t m = INT32_MIN;
        const long long e = (i + 1) * kFan < n_src ? (i + 1) * kFan : n_src;
        for (long long k = i * kFan; k < e; ++k) m = max(m, ld(src + k));
        lvls[off[l] + i] = m;
      });
      g.sync();
    }
    if (!n) g.sync();
  }
  // max of the row over [x, y) (0 <= x < y <= C), INT32_MIN for an
  // empty one.
  __device__ int32_t range_max(const int32_t* hv, const int32_t* lvls,
                               long long x, long long y) const {
    int32_t m = INT32_MIN;
    for (int l = 0;; ++l) {
      const int32_t* cur = l ? lvls + off[l] : hv;
      const long long xa = (x + kFan - 1) / kFan * kFan, yb = y / kFan * kFan;
      if (l == n || xa >= yb) {
        for (long long i = x; i < y; ++i) m = max(m, ld(cur + i));
        return m;
      }
      for (long long i = x; i < xa; ++i) m = max(m, ld(cur + i));
      for (long long i = yb; i < y; ++i) m = max(m, ld(cur + i));
      x = xa / kFan;
      y = yb / kFan;
    }
  }
  // Row m of tpu.py's max table at i: the maximum over [i, i + w) with the
  // identity 0 standing in for the slots past C.
  __device__ int32_t table_entry(const int32_t* hv, const int32_t* lvls,
                                 long long i, long long w) const {
    const long long end = i + w;
    const int32_t m = range_max(hv, lvls, i, end < C ? end : C);
    return end > C ? max(m, 0) : m;
  }
  // `_table_range_query(table, lo, hi, max, 0)` of the max table of the
  // row: 0 where hi <= lo, else the larger of the two windows of width
  // 2^m, m = floor(log2(hi - lo)) capped at max_row (the table's last
  // row), from clip(lo) and clip(hi - 2^m).
  __device__ int32_t window_max(const int32_t* hv, const int32_t* lvls,
                                int32_t lo, int32_t hi, int max_row) const {
    if (hi <= lo) return 0;
    const int32_t len = (int32_t)((uint32_t)hi - (uint32_t)lo);
    int m = 31 - __clz(len > 1 ? len : 1);
    if (m > max_row) m = max_row;
    const long long w = 1LL << m;
    const long long i1 = lo < 0 ? 0 : (lo > C - 1 ? C - 1 : lo);
    long long i2 = (long long)hi - w;
    i2 = i2 < 0 ? 0 : (i2 > C - 1 ? C - 1 : i2);
    return max(table_entry(hv, lvls, i1, w), table_entry(hv, lvls, i2, w));
  }
};

// One cooperative grid of `kernel` on `stream`: enough blocks for `work`
// threads, at most every block resident at once.
template <class A>
int launch(void (*kernel)(A), long long work, size_t smem, A* args,
           void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  const int blocks = (int)(want < 1 ? 1 : (want < most ? want : most));
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(kThreads), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace fdb
