// Helpers that block.cu, compact.cu and rankfed.cu share: int32
// arithmetic as XLA's, tpu.py's gather and scatter index rules, warp and
// block prefix sums and a block maximum, a grid-stride loop over a
// cooperative grid and its stage stamps, prefix sums across the grid
// (TupleScan: three stages over tiles; ChunkScan: one barrier over
// per-block chunks, of the whole grid or of a range of its blocks), the
// launch of one cooperative grid on the caller's stream, and the range
// maxima that answer tpu.py's sparse-table query without its table
// (Levels: a thread a query over every slot; LiveLevels: a warp a query
// over the live slots).

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

// The maximum of one value a thread over the block (every thread calls
// it and gets it); ws holds kWarps words of shared memory.
__device__ __forceinline__ int32_t block_max(int32_t v, int32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  int32_t m = ws[0];
  for (int w = 1; w < kWarps; ++w) m = max(m, ws[w]);
  __syncthreads();  // ws is free for the next call
  return m;
}

// The device's nanosecond clock (%globaltimer).
__device__ __forceinline__ int64_t globaltimer_ns() {
#ifdef __CUDA_ARCH__
  int64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return 0;
#endif
}

// A kernel's stage stamps: where `at` is not null, block 0's thread 0
// writes the clock to at[k] at the kernel's start and after each grid
// barrier, and the kernel ends with one more barrier and stamp, so that
// stage k took at[k + 1] - at[k] ns. A null `at` costs a branch a barrier.
struct Stamps {
  int64_t* at;
  int k;
  __device__ explicit Stamps(int64_t* p) : at(p), k(0) { mark(); }
  __device__ void mark() {
    if (at && blockIdx.x == 0 && threadIdx.x == 0) at[k] = globaltimer_ns();
    ++k;
  }
};

struct Grid {
  long long first, stride;
  __device__ Grid()
      : first((long long)blockIdx.x * blockDim.x + threadIdx.x),
        stride((long long)gridDim.x * blockDim.x) {}
  template <class F> __device__ void each(long long n, F f) const {
    for (long long i = first; i < n; i += stride) f(i);
  }
  __device__ void sync() const { cg::this_grid().sync(); }
  // A barrier, then the stamp after it.
  __device__ void sync(Stamps& st) const {
    sync();
    st.mark();
  }
  // The last stamp of a stamping kernel: one barrier more, then the stamp.
  __device__ void finish(Stamps& st) const {
    if (st.at) sync(st);
  }
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

// Exclusive prefix sums over n elements of K int32 values each, across
// the grid, with one grid barrier and no serial stage. Block b takes the
// contiguous chunk [lo, hi) of chunk() = ceil(n / blocks()) elements.
// reduce_stage (or the caller's own loop and publish) leaves the chunk's
// K sums in tot[b K + c]; after the barrier, offsets gives every thread
// of block b the sums over the blocks before it and over all blocks (one
// pass of the block over at most blocks() K words, from L2), and
// apply_stage rescans the chunk kThreads elements a time from them,
// putting each element's prefixes. val(i, in, v) is called by every
// thread of the block once a tile, with `in` false past the chunk (where
// v is ignored and val must read nothing out of bounds), so it may
// synchronize the block; it must give the same values in both stages.
// tot takes K blocks() words; ws 2 K kWarps words of shared memory. The
// scan may take a range of the grid's blocks, [first, first + count)
// (count 0: every block); block b of the grid is then block b - first of
// the scan, and a block outside the range has an empty chunk (offsets
// still gives it the sums over all blocks).
template <int K>
struct ChunkScan {
  long long n;
  long long first = 0, count = 0;
  __device__ long long blocks() const { return count ? count : gridDim.x; }
  __device__ long long rank() const {
    return (long long)blockIdx.x - first;
  }
  __device__ bool mine() const { return rank() >= 0 && rank() < blocks(); }
  __device__ long long chunk() const {
    return (n + blocks() - 1) / blocks();
  }
  __device__ long long lo() const {
    if (!mine()) return n;
    const long long x = rank() * chunk();
    return x < n ? x : n;
  }
  __device__ long long hi() const {
    const long long x = lo() + chunk();
    return x < n ? x : n;
  }
  // The block's K sums of each thread's acc, to tot (every thread calls
  // it).
  __device__ void publish(const int32_t* acc, int32_t* tot,
                          int32_t* ws) const {
    int32_t ex[K], sum[K];
    block_excl_k<K>(acc, ex, sum, ws);
    if (threadIdx.x == 0 && mine())
      for (int c = 0; c < K; ++c) tot[rank() * K + c] = sum[c];
  }
  template <class V>
  __device__ void reduce_stage(int32_t* tot, int32_t* ws, V val) const {
    const long long b = lo(), e = hi();
    int32_t acc[K];
    for (int c = 0; c < K; ++c) acc[c] = 0;
    for (long long t = b; t < e; t += kThreads) {
      const long long i = t + threadIdx.x;
      int32_t v[K];
      for (int c = 0; c < K; ++c) v[c] = 0;
      val(i, i < e, v);
      if (i < e)
        for (int c = 0; c < K; ++c) acc[c] = add32(acc[c], v[c]);
    }
    publish(acc, tot, ws);
  }
  // off[c]: the sums of value c over the blocks before this one; all[c]:
  // over every block.
  __device__ void offsets(const int32_t* tot, int32_t* ws, int32_t* off,
                          int32_t* all) const {
    int32_t v[2 * K], ex[2 * K], sum[2 * K];
    for (int c = 0; c < 2 * K; ++c) v[c] = 0;
    for (long long b = threadIdx.x; b < blocks(); b += kThreads)
      for (int c = 0; c < K; ++c) {
        const int32_t x = ld(tot + b * K + c);
        if (b < rank()) v[c] = add32(v[c], x);
        v[K + c] = add32(v[K + c], x);
      }
    block_excl_k<2 * K>(v, ex, sum, ws);
    for (int c = 0; c < K; ++c) {
      off[c] = sum[c];
      all[c] = sum[K + c];
    }
  }
  // Rescans the chunk from off (the block's offsets; advanced past the
  // chunk) and calls put(i, v, ex) for each element in it.
  template <class V, class P>
  __device__ void apply_stage(int32_t* off, int32_t* ws, V val, P put) const {
    const long long b = lo(), e = hi();
    for (long long t = b; t < e; t += kThreads) {
      const long long i = t + threadIdx.x;
      int32_t v[K], ex[K], sum[K];
      for (int c = 0; c < K; ++c) v[c] = 0;
      val(i, i < e, v);
      if (i >= e)
        for (int c = 0; c < K; ++c) v[c] = 0;
      block_excl_k<K>(v, ex, sum, ws);
      if (i < e) {
        for (int c = 0; c < K; ++c) ex[c] = add32(off[c], ex[c]);
        put(i, v, ex);
      }
      for (int c = 0; c < K; ++c) off[c] = add32(off[c], sum[c]);
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

// Range maxima of a version row of C slots whose slots past n hold 0 (a
// dense state's pads), for compact.cu's ranks: two levels over the live
// extent only, maxima of 32 slots (level 1) and of 1,024 (level 2), built
// a 1,024-slot group a thread block (group j < ceil(n / 1,024): its 32
// level-1 slots by a warp's maximum each, its level-2 slot from them, in
// one pass and no grid barrier), and `window` answers tpu.py's
// `_table_range_query` with the whole warp: at each level the two edges
// of at most 31 slots are one load a lane, the top level a lane-strided
// loop, one warp maximum at the end. The built extent E = min(1,024
// ceil(n / 1,024), C) covers every live slot; the slots from E on are
// 0 (pads) or past C (the table's identity 0), so a window [i, i + w)
// takes the levels' maximum over [i, min(i + w, E)), and 0 where i + w >
// E. Levels (above) keeps the serial per-thread form for rankfed.cu.
struct LiveLevels {
  long long C;
  __host__ __device__ static long long groups(long long C) {
    return (C + kFan * kFan - 1) / (kFan * kFan);
  }
  __host__ __device__ static long long words(long long C) {
    return groups(C) * (kFan + 1);
  }
  // level 1 of the row at lvls (kFan slots a group), level 2 after it
  template <class T> __device__ T* l1(T* lvls) const { return lvls; }
  template <class T> __device__ T* l2(T* lvls) const {
    return lvls + groups(C) * kFan;
  }
  // Groups [0, ceil(n / 1,024)) over the grid's blocks, from block
  // `first` on (every thread of the block calls it); l1s: 32 words of
  // shared memory.
  __device__ void build(const int32_t* hv, long long n, int32_t* lvls,
                        int32_t* l1s, long long first) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long groups = (n + kFan * kFan - 1) / (kFan * kFan);
    int32_t* L1 = l1(lvls);
    int32_t* L2 = l2(lvls);
    for (long long j = (blockIdx.x + gridDim.x - first % gridDim.x) %
                       gridDim.x;
         j < groups; j += gridDim.x) {
      const long long base = j * kFan * kFan;
      int32_t v[kFan / kWarps];
#pragma unroll
      for (int s = 0; s < kFan / kWarps; ++s) {
        const long long i = base + (warp * (kFan / kWarps) + s) * kFan + lane;
        v[s] = i < C ? __ldg(hv + i) : INT32_MIN;
      }
#pragma unroll
      for (int s = 0; s < kFan / kWarps; ++s) {
        const int slot = warp * (kFan / kWarps) + s;
        const int32_t m = warp_max(v[s]);
        if (lane == 0) {
          L1[j * kFan + slot] = m;
          l1s[slot] = m;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const int32_t m = warp_max(l1s[lane]);
        if (lane == 0) L2[j] = m;
      }
      __syncthreads();
    }
  }
  // This lane's part of the maximum over [x, y) (0 <= x, y <= E), from
  // the row and the levels (INT32_MIN where it holds no slot); every
  // lane of the warp calls it with the same x and y. Every slot it reads
  // is known before its first load: level 0's and level 1's two edges
  // (one slot a lane each), then the range left at the last level
  // reached, lane-strided.
  __device__ __forceinline__ int32_t lane_range(const int32_t* hv,
                                                const int32_t* lvls,
                                                long long x,
                                                long long y) const {
    const int lane = threadIdx.x & 31;
    constexpr long long kLow = kFan - 1;
    if (x >= y) return INT32_MIN;
    long long e0 = -1, f0 = -1, e1 = -1, f1 = -1;  // single slots
    const int32_t* top = hv;  // the last level reached, over [x, y)
    long long xa = (x + kLow) & ~kLow, yb = y & ~kLow;
    if (xa < yb) {
      if (x + lane < xa) e0 = x + lane;
      if (yb + lane < y) f0 = yb + lane;
      x = xa / kFan;
      y = yb / kFan;
      top = l1(lvls);
      xa = (x + kLow) & ~kLow;
      yb = y & ~kLow;
      if (xa < yb) {
        if (x + lane < xa) e1 = x + lane;
        if (yb + lane < y) f1 = yb + lane;
        x = xa / kFan;
        y = yb / kFan;
        top = l2(lvls);
      }
    }
    const int32_t* L1 = l1(lvls);
    int32_t m = max(max(e0 >= 0 ? ld(hv + e0) : INT32_MIN,
                        f0 >= 0 ? ld(hv + f0) : INT32_MIN),
                    max(e1 >= 0 ? ld(L1 + e1) : INT32_MIN,
                        f1 >= 0 ? ld(L1 + f1) : INT32_MIN));
    for (long long i = x + lane; i < y; i += 32) m = max(m, ld(top + i));
    return m;
  }
  // tpu.py's window entry over [i, i + w) with its identity 0 past C, for
  // this lane (E the built extent).
  __device__ __forceinline__ int32_t lane_entry(const int32_t* hv,
                                                const int32_t* lvls,
                                                long long E, long long i,
                                                long long w) const {
    const long long end = i + w;
    const int32_t m = lane_range(hv, lvls, i < E ? i : E, end < E ? end : E);
    return end > E ? max(m, 0) : m;
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
