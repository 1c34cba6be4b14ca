// The compaction pass, for Hopper (sm_90a): densify + dedup, the dense
// resolve's ranks + phase 1, its phase 3, and the redistribution into
// blocks.
//
// Replaces, in the JAX package's foundationdb_tpu/resolver/tpu.py (all
// XLA-jitted; none reaches a pallas_call):
//   densify      _compact_resolve_impl's densify and dedup (:947-974);
//   ranks        _resolve_kernel_impl's ranks and phase 1 (:457-472);
//   phase3       _resolve_kernel_impl's phase 3 and its st_aux (:481-650);
//   redistribute _compact_resolve_impl's redistribution, directory and
//                overflow byte (:978-1009).
// The decode (block.cu) runs before ranks and phase 2 (phase2.cu) between
// ranks and phase3. The plain torch versions are
// foundationdb_tpu_torch/resolver/compact.py `*_ref`. Every output equals
// tpu.py's bit for bit on every input the host builds. Two properties of
// those inputs are used: a block holds at most B entries, and the write
// endpoints' ranks (ub) never fall in sorted order, which holds unless the
// dense state is full (n = C, which a block state never densifies to: each
// block keeps a pad slot) and one endpoint equals its last key while a
// later one is greater; tpu.py's merge positions then collide and its own
// result depends on the scatter's order. There the kernel's result differs
// from the plain version's (which follows tpu.py on the CPU: the
// full_collide case of tests/test_torch_compact.py); compact.py's
// dense_phase3 and gpu.py's _resolve_kernel_impl state the precondition.
//
// Phase 3 also leans on what the decode and densify build: every sorted
// slot holds one endpoint (the write endpoints' positions are distinct),
// a pad endpoint (key +inf, ub = C) belongs to a pad write, never
// committed, and the dense state's columns past n are pads. So no valid
// run reaches past merged slot L = n + 2 Wr: where n < C the real
// endpoints rank at most n, history entry n (a pad, no live bit) starts a
// run at slot n + #(real endpoints) <= L that ends every run before it,
// and past it lie only history pads and pad endpoints, in runs with no
// valid slot; where n = C, L is the whole merged space.
//
// Why: on the card the torch version of the compaction is about 840
// eager launches, which the host pays for one by one and the device runs
// as many small passes over the C-column state; here it is four launches
// around the decode and phase 2.
//
// Bound on the card: bytes. The state (W + 2 rows of C int32) in and out
// of densify, phase3 and redistribute, the endpoints and the reads' ranks
// for ranks: 0.0155, 0.0013, 0.0157 and 0.0151 ms at config 5's C = 2^21
// (chip_smoke.py compact_bound); most of densify's, phase3's and
// redistribute's is their output, whose columns past m2, new_n and the
// blocks' fill are pads. ranks' own design reads each live key row about
// once, n (W + 1) 4 bytes (2.9 us at config 5). Times on the card are in
// PERF.md (an H100 80GB HBM3 at 700 W). Before their redesigns, densify
// and phase3 (0.107 and 0.305 ms there) worked over the capacity C and ran
// each prefix sum in three stages with a serial middle one; ranks (0.050)
// walked tpu.py's 21 dependent steps a thread over C and built its maxima
// a grid barrier a level (4); redistribute (0.064) wrote a word a thread
// with three 64-bit divisions each and folded the tree a barrier a pass
// (3). Their stage stamps put the time in those walks, scans and copies.
// The design:
//
// - Every kernel is one cooperative grid and works over the live columns
//   (n, m, new_n, read on the device), not C. densify's and phase3's
//   prefix sums are grid.cuh's ChunkScan: each block reduces one
//   contiguous chunk, and after one barrier every block sums the totals
//   of the blocks before it and rescans its chunk (no serial stage; all
//   blocks are resident, so none waits on one that has not started).
//   ranks and redistribute need no prefix sum.
// - The live extent: ranks and phase3 take the dense state's columns past
//   n to be pads (kInf key rows, version 0), which densify and phase3
//   write there. Under that precondition ranks' answers equal tpu.py's
//   over all C columns, the walk's saturation at C - 1 included.
// - Stage stamps: every entry point takes an int64 buffer or null; where
//   it is given, block 0's thread 0 writes %globaltimer at the start and
//   after each grid barrier (grid.cuh Stamps), one more barrier ending the
//   kernel, so that stage k took stamp k + 1 - stamp k ns. The main path
//   passes null. compact.py names the stages (*_STAGES); chip_smoke.py's
//   [compact-stages-*] lines read them.
// - densify, 3 grid barriers (previously 5): a chunk scan of the counts
//   writes each source block's inclusive prefix; then the first min(m, C)
//   dense positions (not the C slots) split evenly over the blocks, a
//   thread a position: its source block found by a search of a shared
//   memory window of 256 blocks' prefixes (the window is reloaded only
//   where the chunk leaves it), its key against position p + 1's (the
//   next slot, the next block with entries, or a pad), keep bits by
//   ballot into the block's words and their count; a chunk scan of those
//   places each kept column, which its thread copies. A block past B
//   entries keeps tpu.py's result: only its first B scatter, and the
//   positions after them are pads that dedup among themselves. The
//   columns past min(m, C) and then past m2 are 16-byte pad stores.
//   Chunks of positions and not of source blocks, because the live
//   entries sit in the first blocks after a redistribution (at config 5
//   the first third hold them all): a warp a source block, or a thread a
//   position over chunks of blocks, left most blocks idle (PERF.md).
// - ranks, 1 grid barrier (previously 4). A thread block takes a run of
//   256 sorted endpoints. Its bracket: the live columns below the run's
//   first and last key, each counted by a 128-way search of [0, n) (3
//   rounds of loads at n = 2^21, where tpu.py's walk is 21 dependent
//   steps). The walks that a sorted history gives those two counts agree
//   up to some step d; two warps check those d probes against the two
//   keys, a lane a step, in one round of loads (a history out of order
//   fails the check, and then two threads walk the two keys). Every key
//   between the two probes as both do on their common steps, so each
//   thread runs tpu.py's walk exactly from step d on: its probes stay in
//   the 2 (C >> (d + 1)) columns after the common position, which the
//   block loads coalesced into a shared tile (by cp.async) where they
//   fit, else its bracket; the rest of the probes read device memory
//   (the wide tier: a run spread over more columns than the tile holds).
//   An endpoint out of sorted order walks every step. Each run's tier is
//   written to the scratch (compact.py ranks_tiers). The range maxima
//   for phase 1 are grid.cuh's LiveLevels: maxima of 32 and 1,024 slots
//   over the live extent only, a 1,024-slot group a block in the same
//   stage (no barrier a level); after the one barrier, a read whose two
//   windows span at most 8 slots is answered by its lane from the row,
//   a wider one by the whole warp (each level's two edges one load a
//   lane, the top level lane-strided), with tpu.py's table edges (a
//   window past C takes the identity 0, an empty range gives 0, a
//   negative lo clips to 0). Ranking against the block state before
//   densify (the probe) would need the columns dedup drops subtracted
//   again, so the walk runs on the dense state.
// - phase3, 9 grid barriers (previously 17), every pass over the first L
//   merged slots, n history columns or the runs and entries they hold:
//   each write endpoint names itself at its sorted position (no clear: a
//   stale word names no endpoint at that position), and a chunk scan
//   over P2 compacts them in sorted order with their ranks ub. Endpoint c
//   lands at merged slot c + ub[c] (strictly rising), so one search of the
//   whole block finds its chunk's first endpoint, and the block merges its
//   chunk a 256-slot tile at a time in shared memory (history in the
//   slots between endpoints, in order; an endpoint's bits from two rounds
//   of loads), adding the five-way run scan's chunk sums (history,
//   committed begin, committed end, valid, run start) in the same pass.
//   The scan's apply writes, per run of equal keys, the value at the
//   run's end (covered, stale clamp, rebase) and, by atomicMin, the run's
//   first valid slot; the run compaction and the coalesce are two chunk
//   scans whose applies write the destinations; the last stage gathers
//   the live columns' keys from [history | endpoints], a row group of
//   loads before its stores, and writes the pads past new_n as 16-byte
//   stores.
// - redistribute, 1 grid barrier (previously 3) while the subtree groups
//   number at most 4,096 (NB_out up to 2^22). Output block k's slots j < F = B / 2 are dense
//   columns [k F, k F + F), its slots from F on pads: a thread moves one
//   4-slot group of a block across all W + 2 rows, 16-byte loads and
//   stores (pads where j >= F or the source is at or past min(new_n, C);
//   only the group across the live edge selects lane by lane), indices
//   by shifts of log2 B (B a power of two, at least 8: 32-bit, no
//   division). The group holding slot 0 writes the block's count and
//   fences. Thread blocks own aligned groups of G output blocks (as many
//   groups as the largest power of two of the grid's blocks): a leaf is
//   a shuffle maximum over its block's threads (and 0, the pads'), the
//   group's subtree folds in shared memory in the same stage, and after
//   the one barrier one block folds the groups' roots (one barrier more
//   per 4,096-way fold where there are more).
//
// Interface: plain C entry points (loaded with ctypes), each launching one
// cooperative grid on the caller's stream, allocating nothing (each takes
// a scratch of fdb_compact_*_scratch_ints int32 where it needs one) and
// returning the cudaError_t of the launch.

#include "grid.cuh"

namespace {

using namespace fdb;

constexpr int kStatusConflict = 1, kStatusTooOld = 2;  // types.py

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);  // int32 wrap, as XLA's
}

// Key rows 0..W of column x of a (rows, ld) matrix and column y of
// another: whether the first is lexicographically smaller (signed words,
// then the length row), or equal.
__device__ __forceinline__ bool key_lt(const int32_t* h, long long hld,
                                       long long x, const int32_t* q,
                                       long long qld, long long y, int W) {
  for (int r = 0; r <= W; ++r) {
    const int32_t a = h[r * hld + x], b = q[r * qld + y];
    if (a != b) return a < b;
  }
  return false;
}

__device__ __forceinline__ bool key_eq(const int32_t* h, long long hld,
                                       long long x, const int32_t* q,
                                       long long qld, long long y, int W) {
  for (int r = 0; r <= W; ++r)
    if (h[r * hld + x] != q[r * qld + y]) return false;
  return true;
}

// Columns [from, to) of each of the W + 2 rows of out (W + 2, C) as pads:
// kInf in the key and length rows, 0 in the version row, by 16-byte
// stores over each row's aligned middle.
__device__ void pad_cols(const Grid& g, int32_t* out, long long C, int W,
                         long long from, long long to) {
  if (from < 0) from = 0;
  if (to > C) to = C;
  if (from >= to) return;
  const bool vec = ((uintptr_t)out & 15) == 0;
  for (int r = 0; r <= W + 1; ++r) {
    const int32_t v = r <= W ? kInf : 0;
    const long long A = r * C + from, E = r * C + to;
    const long long a4 = vec ? (A + 3) & ~3LL : E, e4 = vec ? E & ~3LL : E;
    if (a4 < e4) {
      const int4 v4 = make_int4(v, v, v, v);
      int4* o4 = reinterpret_cast<int4*>(out + a4);
      g.each((e4 - a4) / 4, [&](long long q) { o4[q] = v4; });
      g.each(a4 - A, [&](long long i) { out[A + i] = v; });
      g.each(E - e4, [&](long long i) { out[e4 + i] = v; });
    } else {
      g.each(E - A, [&](long long i) { out[A + i] = v; });
    }
  }
}

// ---------------------------------------------------------------- densify

struct DensifyArgs {
  const int32_t* hmat;    // (W + 2, NB B) block state
  const int32_t* counts;  // (NB,)
  int32_t* dense;         // (W + 2, C) out: live prefixes, deduplicated
  int32_t* m2;            // () out: its live columns
  int32_t* scratch;       // DensifyScratch
  int64_t* stamps;        // null, or the stage stamps (grid.cuh Stamps)
  int W, NB, B;
};

// Key rows a thread holds at once: its loads of a group issue together
// (a store between two loads would order them).
constexpr int kRowGroup = 8;

// densify's scratch: each source block's inclusive prefix of the counts,
// the keep bits (a word a 32 positions of each block's chunk), then the
// two scans' block sums (gridDim.x words each; the grid has at most
// blocks() blocks, and a chunk of positions at most ceil(C / gridDim.x)).
struct DensifyScratch {
  int32_t *incl, *tot_cnt, *tot_pos;
  uint32_t* bits;
  long long chunk_words;
  __host__ __device__ static long long blocks(long long NB, long long B) {
    return (NB * B + kThreads - 1) / kThreads;
  }
  __host__ __device__ static long long words(long long NB, long long B) {
    return NB + NB * B / 32 + 20 * blocks(NB, B);
  }
  __device__ DensifyScratch(int32_t* s, long long NB, long long C) {
    incl = s;
    tot_cnt = incl + NB;
    tot_pos = tot_cnt + gridDim.x;
    bits = reinterpret_cast<uint32_t*>(tot_pos + gridDim.x);
    // a word a 32 positions of every tile that a chunk of positions (at
    // most ceil(C / gridDim.x)) starts
    chunk_words = ((C + gridDim.x - 1) / gridDim.x + kThreads - 1) /
                  kThreads * kWarps;
  }
};

// The number of indices c in [0, n) where below(c) holds, for a predicate
// that holds on a prefix: a search of the whole block (every thread calls
// it), 256 candidates a round.
template <class F>
__device__ long long block_count(long long n, F below) {
  long long a0 = 0, a1 = n;  // the answer lies in [a0, a1]
  while (a0 < a1) {
    const long long step = (a1 - a0 + kThreads - 1) / kThreads;
    const long long c = a0 + (threadIdx.x + 1) * step - 1;
    const int k = __syncthreads_count(c < a1 && below(c));
    const long long b1 = a0 + (k + 1) * step - 1;
    a0 += k * step;
    a1 = b1 < a1 ? b1 : a1;
  }
  return a0;
}

// The source blocks [k0, k0 + kThreads) in shared memory (win: their
// inclusive prefixes; base: the one before k0), which hold every dense
// position in [base, win[kThreads - 1]); a position past them (where
// blocks hold fewer entries than that) is searched for in incl.
struct DenseWindow {
  const DensifyArgs* a;
  const int32_t* incl;
  int32_t* win;
  int32_t* base_s;
  long long k0;
  __device__ bool holds(long long p) const {
    return p >= *base_s && p < win[kThreads - 1];
  }
  // Every thread calls it: the window from the block holding p on.
  __device__ void load(long long p) {
    if (!holds(p)) {
      const long long k = block_count(
          a->NB, [&](long long x) { return ld(incl + x) <= p; });
      k0 = k;
      win[threadIdx.x] = k0 + threadIdx.x < a->NB
                             ? ld(incl + k0 + threadIdx.x)
                             : INT32_MAX;
      if (threadIdx.x == 0) *base_s = k0 > 0 ? ld(incl + k0 - 1) : 0;
      __syncthreads();
    }
  }
  // The source block k of dense position p (p < m), p's offset j in it
  // and the block's count c.
  __device__ void locate(long long p, long long& k, long long& j,
                         long long& c) const {
    int32_t before, end;
    if (holds(p)) {
      long long lo = 0, hi = kThreads - 1;  // the first win entry past p
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (win[mid] <= p) lo = mid + 1;
        else hi = mid;
      }
      k = k0 + lo;
      before = lo ? win[lo - 1] : *base_s;
      end = win[lo];
    } else {
      long long lo = 0, hi = a->NB - 1;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (ld(incl + mid) <= p) lo = mid + 1;
        else hi = mid;
      }
      k = lo;
      before = lo ? ld(incl + lo - 1) : 0;
      end = ld(incl + lo);
    }
    j = p - before;
    c = (long long)end - before;
  }
  // The source slot of dense position p, or -1 for a pad: a position at
  // m and past, or past B in a block past B entries (which scatters only
  // its first B).
  __device__ long long slot(long long p, int32_t m) const {
    if (p >= m) return -1;
    long long k, j, c;
    locate(p, k, j, c);
    return j < a->B ? k * a->B + j : -1;
  }
  // Whether dense position p (p < min(m, C)) is kept: the last of its
  // equal-key run (its key differs from position p + 1's), or the last
  // column.
  __device__ bool keep(long long p, int32_t m) const {
    const long long B = a->B, C = (long long)a->NB * B;
    const int W = a->W;
    if (p == C - 1) return true;
    long long k, j, c;
    locate(p, k, j, c);
    const long long src = j < B ? k * B + j : -1;
    const long long succ =
        p + 1 >= m ? -1
                   : (j + 1 < c ? (j + 1 < B ? src + 1 : -1) : slot(p + 1, m));
    bool same = true;
    for (int r0 = 0; r0 <= W; r0 += kRowGroup) {
      int32_t x[kRowGroup], y[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const long long r = r0 + i;
        x[i] = r <= W && src >= 0 ? a->hmat[r * C + src] : kInf;
        y[i] = r <= W && succ >= 0 ? a->hmat[r * C + succ] : kInf;
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) same = same && x[i] == y[i];
    }
    return !same;
  }
};

__global__ void __launch_bounds__(kThreads) densify_kernel(DensifyArgs a) {
  extern __shared__ int32_t smem[];
  int32_t* ws = smem;               // 2 kWarps words
  int32_t* win = ws + 2 * kWarps;   // the window of prefixes
  int32_t* base = win + kThreads;
  const Grid g;
  Stamps st(a.stamps);
  const long long C = (long long)a.NB * a.B;
  const int W = a.W, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const DensifyScratch s(a.scratch, a.NB, C);
  const ChunkScan<1> cnt{a.NB};
  // Stage 1: the counts' chunk sums.
  auto count = [&](long long k, bool in, int32_t* v) {
    if (in) v[0] = a.counts[k];
  };
  cnt.reduce_stage(s.tot_cnt, ws, count);
  g.sync(st);
  // Stage 2: the counts' inclusive prefix, each source block's end in the
  // dense order; m their total.
  int32_t m;
  {
    int32_t off;
    cnt.offsets(s.tot_cnt, ws, &off, &m);
    cnt.apply_stage(&off, ws, count,
                    [&](long long k, const int32_t* v, const int32_t* ex) {
                      s.incl[k] = add32(ex[0], v[0]);
                    });
  }
  g.sync(st);
  // Stage 3: the first min(m, C) dense positions, an even chunk a block,
  // a thread a position a tile: its source (searched in a window of 256
  // source blocks' prefixes) and keep bit, by ballot into the chunk's bit
  // words; the kept count's chunk sums. The pads past min(m, C), which no
  // kept column reaches.
  const ChunkScan<1> pos{m < C ? (m > 0 ? m : 0) : C};
  const long long lo = pos.lo(), hi = pos.hi();
  uint32_t* bits = s.bits + blockIdx.x * s.chunk_words;
  DenseWindow w{&a, s.incl, win, base, 0};
  if (threadIdx.x == 0) {
    win[kThreads - 1] = 0;  // holds nothing yet
    *base = 1;
  }
  __syncthreads();
  {
    int32_t acc = 0;
    for (long long t0 = lo; t0 < hi; t0 += kThreads) {
      w.load(t0);
      const long long p = t0 + threadIdx.x;
      const unsigned bal = __ballot_sync(kFull, p < hi && w.keep(p, m));
      if (lane == 0) {
        bits[(t0 - lo) / 32 + warp] = bal;
        acc += __popc(bal);
      }
    }
    pad_cols(g, a.dense, C, W, pos.n, C);
    pos.publish(&acc, s.tot_pos, ws);
  }
  g.sync(st);
  // Stage 4: each kept position's column written to its rank (the kept
  // positions' prefix); pads past m2.
  int32_t offk, m2;
  pos.offsets(s.tot_pos, ws, &offk, &m2);
  // The tile's kept positions before a thread's, from its bit words (no
  // block scan); the next tile's words are read while this one copies.
  const int32_t* kw = reinterpret_cast<const int32_t*>(bits);
  uint32_t words[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps; ++i) words[i] = lo < hi ? ld(kw + i) : 0;
  for (long long t0 = lo; t0 < hi; t0 += kThreads) {
    w.load(t0);
    uint32_t here[kWarps];
    int32_t before = 0, in_tile = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      here[i] = words[i];
      const int32_t c = __popc(here[i]);
      before += i < warp ? c : 0;
      in_tile += c;
    }
    const long long next = (t0 - lo) / 32 + kWarps;
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      words[i] = t0 + kThreads < hi ? ld(kw + next + i) : 0;
    const uint32_t mine = here[warp];
    const long long p = t0 + threadIdx.x;
    const long long to = add32(
        offk, before + __popc(mine & ((1u << lane) - 1u)));
    offk = add32(offk, in_tile);
    if (!((mine >> lane) & 1)) continue;
    const long long src = w.slot(p, m);
    for (int r0 = 0; r0 <= W + 1; r0 += kRowGroup) {
      int32_t v[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const long long r = r0 + i;
        v[i] = r > W + 1 ? 0
               : src >= 0 ? a.hmat[r * C + src]
                          : (r <= W ? kInf : 0);
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i)
        if (r0 + i <= W + 1) a.dense[(r0 + i) * C + to] = v[i];
    }
  }
  pad_cols(g, a.dense, C, W, m2, pos.n);
  if (g.leader()) *a.m2 = m2;
  g.finish(st);
}

// ------------------------------------------------------------------ ranks

struct RanksArgs {
  const int32_t* hmat;     // (W + 2, C) dense state
  const int32_t* n;        // () its live columns
  const int32_t* smat;     // (W + 1, P2) sorted endpoints
  const int32_t* q_begin;  // (R,)
  const int32_t* q_end;
  const int32_t* rsnap;
  const int32_t* rtxn;
  const uint8_t* too_old;  // (T,)
  int32_t* ub;             // (P2,) out: #history <= key (C for a pad)
  uint8_t* eq;             // (P2,) out: the history entry at lb equals it
  int32_t* base_conf;      // (T,) out
  int32_t* scratch;        // RanksScratch
  int64_t* stamps;         // null, or the stage stamps (grid.cuh Stamps)
  int W, P2, R, T;
  int tile_cols;           // history columns the shared tile holds
  long long C;
};

// A run: a thread block's share of the sorted endpoints, whole multiples
// of kRun, a thread every kRun-th.
constexpr int kRun = kThreads;
// Shared memory of ranks' tile of history key rows, in words.
constexpr int kTileWords = 10240;
// Windows of at most this many slots are answered by their lane alone.
constexpr int kShortWindow = 8;
// Key rows of an endpoint held in registers (the rest read from smat).
constexpr int kKeyRegs = 8;
// A run's tier, in its scratch word (RanksScratch::tiers; compact.py
// RANKS_TIERS): the rest of its walks in the shared tile, each thread
// walking device memory, or some endpoint out of sorted order (which
// walked every step); plus kRewalked where the bracket's predicted walks
// failed their check (a history out of order).
constexpr int32_t kTierTile = 1, kTierWide = 2, kTierOutOfOrder = 3,
                  kRewalked = 4;

// ranks' scratch: lb (P2), the live levels, a tier word a run.
struct RanksScratch {
  int32_t *lb, *lvls, *tiers;
  __host__ __device__ static long long runs(long long P2) {
    return (P2 + kRun - 1) / kRun;
  }
  __host__ __device__ static long long words(long long C, long long P2) {
    return P2 + LiveLevels::words(C) + runs(P2);
  }
  __device__ RanksScratch(int32_t* s, long long C, long long P2) {
    lb = s;
    lvls = lb + P2;
    tiers = lvls + LiveLevels::words(C);
  }
};

// One endpoint's key, rows 0..W of a column of smat: the first kKeyRegs
// rows in registers.
struct Key {
  int32_t w[kKeyRegs];
  const int32_t* q;  // the column in smat
  long long qld;
  int W;
  bool pad;          // a pad endpoint (its length row kInf)
  __device__ __forceinline__ Key(const int32_t* smat, long long P2,
                                 long long col, int W_)
      : q(smat + col), qld(P2), W(W_) {
#pragma unroll
    for (int r = 0; r < kKeyRegs; ++r) {
      w[r] = r <= W ? __ldg(q + r * qld) : 0;
      if (r == W) pad = w[r] == kInf;
    }
    if (W >= kKeyRegs) pad = row(W) == kInf;
  }
  __device__ __forceinline__ int32_t row(int r) const {
    return __ldg(q + r * qld);
  }
  // Column c of the (rows, ld) matrix h against the key: < 0 where it is
  // lexicographically smaller (signed words, then the length row), 0
  // where equal, > 0 where greater. A shared-memory column: a row at a
  // time.
  __device__ __forceinline__ int cmp_shared(const int32_t* h, long long ld_,
                                            long long c) const {
#pragma unroll
    for (int r = 0; r < kKeyRegs; ++r) {
      if (r > W) return 0;
      const int32_t x = h[r * ld_ + c];
      if (x != w[r]) return x < w[r] ? -1 : 1;
    }
    for (int r = kKeyRegs; r <= W; ++r) {
      const int32_t x = h[r * ld_ + c], y = row(r);
      if (x != y) return x < y ? -1 : 1;
    }
    return 0;
  }
  // The same for a read-only column in device memory: the first
  // kKeyRegs rows' loads issue together.
  __device__ __forceinline__ int cmp_dev(const int32_t* h, long long ld_,
                                         long long c) const {
    int32_t x[kKeyRegs];
#pragma unroll
    for (int r = 0; r < kKeyRegs; ++r)
      x[r] = r <= W ? __ldg(h + r * ld_ + c) : 0;
#pragma unroll
    for (int r = 0; r < kKeyRegs; ++r)
      if (r <= W && x[r] != w[r]) return x[r] < w[r] ? -1 : 1;
    for (int r = kKeyRegs; r <= W; ++r) {
      const int32_t a = __ldg(h + r * ld_ + c), y = row(r);
      if (a != y) return a < y ? -1 : 1;
    }
    return 0;
  }
};

// One word from device memory into shared memory by cp.async, no
// register staged (tile_wait completes them; it measured 1.5% faster than
// loads and stores for ranks at config 5, PERF.md). Off the card (a host
// compile of this file) a plain copy.
__device__ __forceinline__ void tile_copy(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void tile_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

// tpu.py's halving walk over C columns (`_lower_rank`): step j (j = 0,
// 1, ...) is s = C >> (j + 1) and probes column pos + s - 1, adding s to
// pos where that column's key is below the endpoint's. steps(C) of them;
// the walk saturates at C - 1.
__device__ __forceinline__ int walk_steps(long long C) {
  return 63 - __clzll((unsigned long long)C);
}

// The state (pos, step index) where the walks predicted from two counts
// k0 <= k1 of history columns below a key part: a step's outcome from a
// count k is pos + s <= k (what a sorted history gives). Every thread of
// the block gets the same.
__device__ __forceinline__ void walk_split(long long k0, long long k1,
                                           long long C, long long* pos,
                                           int* d) {
  long long p = 0;
  int j = 0;
  for (; j < walk_steps(C); ++j) {
    const long long s = C >> (j + 1);
    const bool o0 = p + s <= k0, o1 = p + s <= k1;
    if (o0 != o1) break;
    if (o0) p += s;
  }
  *pos = p;
  *d = j;
}

// Whether step j of key's walk answers as the walk predicted from count
// k does, for j < d (true from d on): the column the predicted walk
// probes there against the key.
__device__ __forceinline__ bool walk_step_holds(const Key& key,
                                                const int32_t* hmat,
                                                long long C, long long k,
                                                int d, int j) {
  if (j >= d) return true;
  long long p = 0;
  for (int i = 0; i < j; ++i)
    if (p + (C >> (i + 1)) <= k) p += C >> (i + 1);
  const long long s = C >> (j + 1);
  return (key.cmp_dev(hmat, C, p + s - 1) < 0) == (p + s <= k);
}

// The most steps of a walk (C <= INT32_MAX): side columns a step.
constexpr int kSteps = 32;

// Where a run's walks read their probes (every thread of the block the
// same): the tile of history columns [tlo, thi), W + 1 rows of tw words;
// beside it the columns side_c[j] and side_c[kSteps + j] (-1: none) that
// step j may probe outside the tile, a column of `sides` each.
struct RunTile {
  const int32_t* tile;
  const int32_t* sides;
  const int32_t* side_c;
  long long tlo, thi;
  // Column c, probed at step j, against the key: from the tile or a side
  // column, else from device memory.
  __device__ __forceinline__ int cmp(const Key& key, const int32_t* hmat,
                                     long long C, long long c, int j) const {
    if (thi > tlo) {  // (side_c is this run's only where there is a tile)
      if (c >= tlo && c < thi)
        return key.cmp_shared(tile, thi - tlo, c - tlo);
      if (j < kSteps && c == side_c[j])
        return key.cmp_shared(sides, 2 * kSteps, j);
      if (j < kSteps && c == side_c[kSteps + j])
        return key.cmp_shared(sides, 2 * kSteps, kSteps + j);
    }
    return key.cmp_dev(hmat, C, c);
  }
};

// The walk of key from step j at pos on; returns the final pos.
__device__ __forceinline__ long long walk_from(const Key& key,
                                               const int32_t* hmat,
                                               long long C, const RunTile& t,
                                               long long pos, int j) {
  for (long long s = C >> (j + 1); s >= 1; s >>= 1, ++j)
    if (t.cmp(key, hmat, C, pos + s - 1, j) < 0) pos += s;
  return pos;
}

__global__ void __launch_bounds__(kThreads, 4) ranks_kernel(RanksArgs a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  Stamps st(a.stamps);
  const long long C = a.C, P2 = a.P2;
  const int W = a.W, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = threadIdx.x >= kThreads / 2;
  const int32_t* hv = a.hmat + (W + 1) * C;
  const RanksScratch s(a.scratch, C, P2);
  const LiveLevels lv{C};
  const int32_t n32 = *a.n;
  const long long n = n32 < 0 ? 0 : (n32 > C ? C : n32);
  // Shared memory: the tile; the run's first and last key (a column each
  // of a (W + 1, 2) matrix), the side columns and their indexes (RunTile),
  // at the end of the tile's words; a search round's counts, a group's
  // level-1 maxima, the run's bracket and its walks' outcomes. Keys too
  // wide for that: no tile, and the two keys read from smat.
  const bool roomy = a.tile_cols > 0;
  int32_t* tile = smem;
  int32_t* ends = roomy ? smem + kTileWords - 2 * (W + 1) : smem;
  int32_t* sides = roomy ? ends - 2 * kSteps * (W + 1) : smem;
  int32_t* side_c = roomy ? sides - 2 * kSteps : smem;
  int32_t* cnt = smem + kTileWords;
  int32_t* l1s = cnt + kWarps;
  long long* run_s = reinterpret_cast<long long*>(l1s + kFan);  // 4
  // Stage 1: base_conf = too_old; each run's ranks; the live levels.
  g.each(a.T, [&](long long t) { a.base_conf[t] = a.too_old[t] ? 1 : 0; });
  const int per_thread =
      (int)(((P2 + gridDim.x - 1) / gridDim.x + kRun - 1) / kRun);
  const long long chunk = (long long)per_thread * kRun,
                  runs = (P2 + chunk - 1) / chunk;
  g.each(RanksScratch::runs(P2), [&](long long r) {
    if (r >= runs) s.tiers[r] = 0;  // no run
  });
  for (long long run = blockIdx.x; run < runs; run += gridDim.x) {
    const long long q0 = run * chunk,
                    q1 = (q0 + chunk < P2 ? q0 + chunk : P2) - 1;
    // The run's first endpoint's key (threads 0..127) and its last one's
    // (128..255); this thread's first endpoint's.
    const Key kb(a.smat, P2, half ? q1 : q0, W);
    const long long qt = q0 + threadIdx.x < q1 ? q0 + threadIdx.x : q1;
    const Key kq(a.smat, P2, qt, W);
    if (roomy && (threadIdx.x & (kThreads / 2 - 1)) == 0)
      for (int r = 0; r <= W; ++r) ends[2 * r + half] = kb.row(r);
    // The bracket [klo, khi]: the live history columns below the two
    // keys, each counted by a 128-way search of [0, n) by half the block
    // (exact for a sorted history; the walks below do not rely on it).
    {
      long long lo = 0, hi = n;  // the count lies in [lo, hi]
      while (!__syncthreads_and(lo >= hi)) {
        const long long step = (hi - lo + kThreads / 2 - 1) >> 7;
        const long long c =
            lo + ((threadIdx.x & (kThreads / 2 - 1)) + 1) * step - 1;
        const bool below = lo < hi && c < hi && kb.cmp_dev(a.hmat, C, c) < 0;
        const unsigned b = __ballot_sync(kFull, below);
        if (lane == 0) cnt[warp] = __popc(b);
        __syncthreads();
        long long k = 0;
        for (int w = 0; w < kWarps / 2; ++w) k += cnt[half * kWarps / 2 + w];
        if (lo < hi) {
          const long long b1 = lo + (k + 1) * step - 1;
          lo += k * step;
          hi = b1 < hi ? b1 : hi;
        }
      }
      if ((threadIdx.x & (kThreads / 2 - 1)) == 0) run_s[half] = lo;
      __syncthreads();
    }
    const long long klo = run_s[0], khi = run_s[1];
    // The walks of the first and last endpoint agree up to step d (pos_d
    // there) where the bracket's predicted walks do (walk_split). Every
    // endpoint between them in sorted order probes as both do on their
    // common steps (a column below the first key is below it, one not
    // below the last is not below it), so its walk continues from (pos_d,
    // d). Warps 0 and kWarps / 2 check those d probes against the two
    // keys, a lane a step, while the tile loads. Where a probe disagrees
    // (a history out of order), threads 0 and 128 walk the two keys and d
    // is where their real walks part.
    long long pos_d;
    int d;
    walk_split(klo, khi, C, &pos_d, &d);
    // The tile: the bracket's columns [klo, min(khi + 1, C)) where they
    // fit, with the columns outside it that the bracket's predicted walks
    // probe from step d on. In a sorted history every walk of the run
    // probes only these: a walk from a count k probes pos_j(k) + s_j - 1
    // at step j, and where that falls below the bracket, pos_j(k) is
    // pos_j(klo) (above it, pos_j(khi)).
    RunTile t{tile, sides, side_c, 0, 0};
    {
      const long long b_end = khi + 1 < C ? khi + 1 : C;
      if (klo <= khi && b_end - klo <= a.tile_cols) {
        t.tlo = klo;
        t.thi = b_end;
      }
    }
    const long long tw = t.thi - t.tlo;
    if (tw > 0 && (warp == 0 || warp == 1) && lane < kSteps) {
      const long long k = warp ? khi : klo;
      long long p = pos_d;
      for (int j = d; j < lane; ++j)
        if (p + (C >> (j + 1)) <= k) p += C >> (j + 1);
      const long long sj = C >> (lane + 1);
      const long long c = p + sj - 1;
      side_c[warp * kSteps + lane] =
          lane >= d && sj >= 1 && (c < t.tlo || c >= t.thi) ? (int32_t)c : -1;
    }
    __syncthreads();
    for (int r = 0; r <= W; ++r)
      for (long long c = threadIdx.x; c < tw; c += kThreads)
        tile_copy(tile + r * tw + c, a.hmat + r * C + t.tlo + c);
    if (tw > 0)
      for (int x = threadIdx.x; x < 2 * kSteps * (W + 1); x += kThreads) {
        const int slot = x % (2 * kSteps), r = x / (2 * kSteps);
        if (side_c[slot] >= 0)
          tile_copy(sides + r * 2 * kSteps + slot,
                    a.hmat + r * C + side_c[slot]);
      }
    const bool ok = (warp != 0 && warp != kWarps / 2) ||
                    walk_step_holds(kb, a.hmat, C, klo, d, lane);
    tile_wait();
    const bool rewalked = !__syncthreads_and(ok);
    if (rewalked) {
      if ((threadIdx.x & (kThreads / 2 - 1)) == 0) {
        long long p = 0, bits = 0;
        for (int j = 0; j < walk_steps(C); ++j) {
          const long long sj = C >> (j + 1);
          if (kb.cmp_dev(a.hmat, C, p + sj - 1) < 0) {
            p += sj;
            bits |= 1LL << j;
          }
        }
        run_s[2 + half] = bits;
      }
      __syncthreads();
      const long long differ = run_s[2] ^ run_s[3];
      d = differ ? __ffsll(differ) - 1 : walk_steps(C);
      pos_d = 0;
      for (int j = 0; j < d; ++j)
        if ((run_s[2] >> j) & 1) pos_d += C >> (j + 1);
    }
    bool out_of_order = false;
    auto rank = [&](const Key& key, long long q) {
      // An endpoint out of sorted order (before the first or after the
      // last) walks every step.
      const bool out =
          roomy ? key.cmp_shared(ends, 2, 0) > 0 || key.cmp_shared(ends, 2, 1) < 0
                : key.cmp_dev(a.smat, P2, q0) > 0 ||
                      key.cmp_dev(a.smat, P2, q1) < 0;
      out_of_order |= out;
      const long long pos =
          walk_from(key, a.hmat, C, t, out ? 0 : pos_d, out ? 0 : d);
      const bool eq = t.cmp(key, a.hmat, C, pos, kSteps) == 0;
      s.lb[q] = (int32_t)pos;
      a.eq[q] = eq;
      a.ub[q] = key.pad ? (int32_t)C : (int32_t)pos + eq;
    };
    if (q0 + threadIdx.x <= q1) rank(kq, q0 + threadIdx.x);
    for (int e = 1; e < per_thread; ++e) {
      const long long q = q0 + (long long)e * kRun + threadIdx.x;
      if (q <= q1) rank(Key(a.smat, P2, q, W), q);
    }
    // (also the barrier before the next run's tile and keys)
    const bool any_out = __syncthreads_or(out_of_order);
    if (threadIdx.x == 0)
      s.tiers[run] = (any_out ? kTierOutOfOrder
                              : (tw > 0 ? kTierTile : kTierWide)) |
                     (rewalked ? kRewalked : 0);
  }
  lv.build(hv, n, s.lvls, l1s, runs);  // blocks without a run first
  // The reads of this block's first tile, loaded ahead of the barrier.
  int32_t pre[4] = {0, 0, 0, 0};  // q_begin, q_end, rsnap, rtxn
  {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < a.R) {
      pre[0] = a.q_begin[i];
      pre[1] = a.q_end[i];
      pre[2] = a.rsnap[i];
      pre[3] = a.rtxn[i];
    }
  }
  g.sync(st);
  // Stage 2: each read's history maximum over [rank_b - 1, rank_e) by
  // tpu.py's two overlapping power-of-two windows: windows of at most
  // kShortWindow slots by the read's thread from the row; wider ones
  // queued in shared memory and answered a warp each from the live
  // levels (LiveLevels), the block's warps sharing the queue.
  const long long E = ((n + kFan * kFan - 1) / (kFan * kFan)) * kFan * kFan;
  const long long built = E < C ? E : C;
  int32_t* q_i1 = smem;  // the queue: a wide read's windows, its thread
  int32_t* q_i2 = q_i1 + kThreads;
  int32_t* q_m = q_i2 + kThreads;
  int32_t* q_own = q_m + kThreads;
  int32_t* q_hist = q_own + kThreads;
  int32_t* q_n = q_hist + kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < a.R;
       base += (long long)gridDim.x * kThreads) {
    const long long i = base + threadIdx.x;
    const bool has = i < a.R;
    if (base != (long long)blockIdx.x * kThreads && has) {
      pre[0] = a.q_begin[i];
      pre[1] = a.q_end[i];
      pre[2] = a.rsnap[i];
      pre[3] = a.rtxn[i];
    }
    if (threadIdx.x == 0) *q_n = 0;
    int32_t lo = 0, hi = 0;
    if (has) {
      hi = ld(s.lb + gat(pre[1], P2));
      lo = add32(ld(a.ub + gat(pre[0], P2)), -1);
    }
    const bool live = has && hi > lo;
    int m = 0;
    long long i1 = 0, i2 = 0;
    if (live) {
      const int32_t len = (int32_t)((uint32_t)hi - (uint32_t)lo);
      m = 31 - __clz(len > 1 ? len : 1);
      i1 = lo < 0 ? 0 : (lo > C - 1 ? C - 1 : lo);
      i2 = (long long)hi - (1LL << m);
      i2 = i2 < 0 ? 0 : (i2 > C - 1 ? C - 1 : i2);
    }
    const long long w = 1LL << m;
    const bool wide = live && w > kShortWindow;
    __syncthreads();  // q_n cleared
    int32_t hist = 0;  // an empty range's identity
    if (live && !wide) {
      int32_t m1 = INT32_MIN, m2 = INT32_MIN;
      for (long long k = 0; k < w; ++k) {
        if (i1 + k < C) m1 = max(m1, __ldg(hv + i1 + k));
        if (i2 + k < C) m2 = max(m2, __ldg(hv + i2 + k));
      }
      if (i1 + w > C) m1 = max(m1, 0);
      if (i2 + w > C) m2 = max(m2, 0);
      hist = max(m1, m2);
    } else if (wide) {
      const int slot = atomicAdd(q_n, 1);
      q_i1[slot] = (int32_t)i1;
      q_i2[slot] = (int32_t)i2;
      q_m[slot] = m;
      q_own[slot] = threadIdx.x;
    }
    __syncthreads();
    for (int e = warp; e < *q_n; e += kWarps) {
      const long long ww = 1LL << q_m[e];
      const int32_t h =
          warp_max(max(lv.lane_entry(hv, s.lvls, built, q_i1[e], ww),
                       lv.lane_entry(hv, s.lvls, built, q_i2[e], ww)));
      if (lane == 0) q_hist[q_own[e]] = h;
    }
    __syncthreads();
    if (wide) hist = q_hist[threadIdx.x];
    if (has && hist > pre[2]) a.base_conf[gat(pre[3], a.T)] = 1;
    __syncthreads();  // the queue is free again
  }
  g.finish(st);
}

// ----------------------------------------------------------------- phase 3

struct Phase3Args {
  const int32_t* hmat;        // (W + 2, C) dense state
  const int32_t* n;           // () its live columns
  const int32_t* smat;        // (W + 1, P2)
  const int32_t* s_begin;     // (Wr,)
  const int32_t* s_end;
  const int32_t* wtxn;
  const uint8_t* w_valid;
  const int32_t* conflict;    // (T,) phase 2's vector
  const uint8_t* too_old;     // (T,)
  const int32_t* ub;          // (P2,) ranks' outputs
  const uint8_t* eq;
  const int32_t* version;     // () the batch's version offset
  const int32_t* oldest_eff;  // () the new base
  const int32_t* p2_iters;    // ()
  int32_t* hmat_out;          // (W + 2, C) out
  int32_t* new_n;             // () out
  int8_t* st_aux;             // (T + 6,) out
  int32_t* scratch;
  int64_t* stamps;            // null, or the stage stamps (grid.cuh Stamps)
  int W, P2, Wr, T;
  long long C;
};

// The scratch of phase 3, in this order; the merged-space arrays are used
// up to L = n + M slots, the block sums for gridDim.x blocks (at most
// blocks()).
struct P3Scratch {
  int32_t *inv, *packed, *ubc, *merged, *fv, *valr, *csrc, *cval, *src2,
      *hvn, *tot;
  __host__ __device__ static long long blocks(long long C, long long M) {
    return (C + M + kThreads - 1) / kThreads;
  }
  __host__ __device__ static long long words(long long C, long long P2,
                                             long long M) {
    const long long N3 = C + M;
    return P2 + 2 * M + 5 * N3 + 2 * C + 5 * blocks(C, M);
  }
  __device__ P3Scratch(int32_t* s, long long C, long long P2, long long M) {
    const long long N3 = C + M;
    inv = s;
    packed = inv + P2;
    ubc = packed + M;
    merged = ubc + M;
    fv = merged + N3;
    valr = fv + N3;
    csrc = valr + N3;
    cval = csrc + N3;
    src2 = cval + N3;
    hvn = src2 + C;
    tot = hvn + C;
  }
};

// Compacted write endpoint c's merged bits (ub_c its rank): committed
// begin, committed end, same key as its merged predecessor, source column
// C + position. Its loads issue in two rounds: packed[c], packed[c - 1]
// and ubc[c - 1], then eq and both endpoints' key rows.
__device__ int32_t endpoint_bits(const Phase3Args& a, const P3Scratch& s,
                                 long long c, int32_t ub_c) {
  const long long P2 = a.P2;
  const int W = a.W;
  const int32_t pe = ld(s.packed + c);
  const int32_t pp = c > 0 ? ld(s.packed + c - 1) : 0;
  const bool prev_here = c > 0 && ld(s.ubc + c - 1) == ub_c;
  const int32_t sidx = pe >> 2;
  const long long q = gat(sidx, P2), qp = gat(pp >> 2, P2);
  const int32_t committed = pe & 1, is_begin = (pe >> 1) & 1;
  bool same_prev = a.eq[q] != 0 && ub_c > 0;
  if (prev_here) {  // the previous endpoint is its predecessor
    bool same = true;
    for (int r0 = 0; r0 <= W; r0 += kRowGroup) {
      int32_t x[kRowGroup], y[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const long long r = r0 + i;
        x[i] = r <= W ? a.smat[r * P2 + q] : 0;
        y[i] = r <= W ? a.smat[r * P2 + qp] : 0;
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) same = same && x[i] == y[i];
    }
    same_prev = same;
  }
  return add32(add32((committed & is_begin) << 1,
                     (committed & (1 - is_begin)) << 2),
               add32((int32_t)same_prev << 3,
                     (int32_t)((uint32_t)add32((int32_t)a.C, sidx) << 4)));
}

// A merged slot's five counts: history, committed begin, committed end,
// valid, run start.
__device__ __forceinline__ void run_bits(int32_t x, int32_t* v) {
  v[0] = x & 1;
  v[1] = (x >> 1) & 1;
  v[2] = (x >> 2) & 1;
  v[3] = v[0] | v[1] | v[2];
  v[4] = !((x >> 3) & 1);
}

__global__ void __launch_bounds__(kThreads) phase3_kernel(Phase3Args a) {
  extern __shared__ int32_t smem[];
  int32_t* ws = smem;                // 10 kWarps words
  int32_t* mark = ws + 10 * kWarps;  // a tile's endpoints by slot
  int32_t* vbuf = mark + kThreads;   // and their merged bits
  const Grid g;
  Stamps st(a.stamps);
  const long long C = a.C, P2 = a.P2, Wr = a.Wr, M = 2 * Wr, N3 = C + M;
  const int W = a.W;
  const long long T = a.T;
  const P3Scratch s(a.scratch, C, P2, M);
  const int32_t* hv = a.hmat + (W + 1) * C;
  const int32_t n = *a.n, version = *a.version, oldest = *a.oldest_eff;
  // No valid run reaches past the first L merged slots (the note above).
  const long long L = (n < 0 ? 0 : (n > C ? C : n)) + M;
  auto epos = [&](long long e) {
    return e < Wr ? a.s_begin[e] : a.s_end[e - Wr];
  };

  // Stage 1: each write endpoint's sorted position names it; the runs'
  // first valid slots cleared; the statuses.
  g.each(M, [&](long long e) {
    const long long p = sct(epos(e), P2);
    if (p >= 0) s.inv[p] = (int32_t)e;
  });
  g.each(L, [&](long long i) { s.fv[i] = (int32_t)N3; });
  g.each(T, [&](long long t) {
    a.st_aux[t] = (int8_t)(a.too_old[t] ? kStatusTooOld
                                        : (a.conflict[t] > 0 ? kStatusConflict
                                                             : 0));
  });
  g.sync(st);
  // Stages 2-3: the write endpoints compacted in sorted order by a scan
  // over P2 (position p holds one where inv[p] names an endpoint at p: the
  // scratch is never cleared, and a stale word names none or that one),
  // bit-packed: position << 2 | is_begin << 1 | committed; their ranks.
  const ChunkScan<1> rank{P2};
  auto is_w = [&](long long p, bool in, int32_t* v) {
    if (!in) return;
    const int32_t e = ld(s.inv + p);
    v[0] = e >= 0 && e < M && sct(epos(e), P2) == p;
  };
  rank.reduce_stage(s.tot, ws, is_w);
  g.sync(st);
  {
    int32_t off, all;
    rank.offsets(s.tot, ws, &off, &all);
    rank.apply_stage(
        &off, ws, is_w, [&](long long p, const int32_t* v, const int32_t* ex) {
          const long long c = sct(ex[0], M);
          if (!v[0] || c < 0) return;
          const int32_t e = ld(s.inv + p);
          const bool beg = e < Wr;
          const long long w = beg ? e : e - Wr;
          const int32_t pos = beg ? a.s_begin[w] : a.s_end[w];
          const bool cw = a.w_valid[w] && a.conflict[gat(a.wtxn[w], T)] == 0;
          s.packed[c] = add32((int32_t)((uint32_t)pos << 2),
                              (beg ? 2 : 0) + (cw ? 1 : 0));
          s.ubc[c] = a.ub[gat(pos, P2)];
        });
  }
  g.sync(st);
  // Stage 4: the merged space over the block's chunk of [0, L), history
  // first among equal ranks: endpoint c at slot c + ubc[c], history in the
  // slots between, in order; merged in shared memory a tile at a time
  // from one search for the chunk's first endpoint. The five-way run
  // scan's chunk sums in the same pass.
  const ChunkScan<5> runs{L};
  {
    const long long lo = runs.lo(), hi = runs.hi();
    long long q = block_count(  // the endpoints before the tile
        M, [&](long long c) { return c + ld(s.ubc + c) < lo; });
    int32_t acc[5] = {0, 0, 0, 0, 0};
    for (long long t0 = lo; t0 < hi; t0 += kThreads) {
      mark[threadIdx.x] = -1;
      __syncthreads();
      const long long c = q + threadIdx.x;
      const int32_t ub_c = c < M ? ld(s.ubc + c) : 0;
      const long long slot = c < M ? c + ub_c : t0 + kThreads;
      const bool mine = slot < t0 + kThreads;
      if (mine) {
        mark[slot - t0] = threadIdx.x;
        vbuf[slot - t0] = endpoint_bits(a, s, c, ub_c);
      }
      const int here = __syncthreads_count(mine);
      const long long i = t0 + threadIdx.x;
      const int k = mark[threadIdx.x];
      int32_t sum;
      const int32_t before = block_excl(k >= 0, ws, &sum);
      if (i < hi) {
        const long long j = i - q - before;  // history entry, if not k's
        const int32_t x = k >= 0 ? vbuf[threadIdx.x]
                                 : add32(j < n, (int32_t)((uint32_t)j << 4));
        s.merged[i] = x;
        int32_t v[5];
        run_bits(x, v);
        for (int b = 0; b < 5; ++b) acc[b] = add32(acc[b], v[b]);
      }
      q += here;
    }
    runs.publish(acc, s.tot, ws);
  }
  g.sync(st);
  // Stage 5: per merged slot its five counts. A run of equal keys gets its
  // value at its last slot (covered by a committed write: the batch
  // version, else the history value there; stale clamp and rebase) and
  // its first valid slot by atomicMin.
  int32_t n_runs;
  {
    int32_t off[5], all[5];
    runs.offsets(s.tot, ws, off, all);
    n_runs = all[4];
    bool joined;  // the next slot continues this one's run
    runs.apply_stage(
        off, ws,
        [&](long long i, bool in, int32_t* v) {
          if (!in) return;
          run_bits(ld(s.merged + i), v);
          joined = i + 1 < L && ((ld(s.merged + i + 1) >> 3) & 1);
        },
        [&](long long i, const int32_t* v, const int32_t* ex) {
          const int32_t rid = add32(ex[4], v[4]) - 1;
          if (rid < 0) return;  // before the first run start: never kept
          if (v[3]) atomicMin(s.fv + rid, (int32_t)i);
          if (joined) return;
          const int32_t h = add32(ex[0], v[0]), wb = add32(ex[1], v[1]),
                        we = add32(ex[2], v[2]);
          const long long k = (long long)h - 1;
          const int32_t val =
              wb > we ? version : hv[k < 0 ? 0 : (k > C - 1 ? C - 1 : k)];
          s.valr[rid] = val <= oldest ? 0 : sub32(val, oldest);
        });
  }
  g.sync(st);
  // Stages 6-7: compaction 1, the runs with a valid slot to the front.
  const ChunkScan<1> valid{n_runs};
  auto has_valid = [&](long long r, bool in, int32_t* v) {
    if (in) v[0] = ld(s.fv + r) < N3;
  };
  valid.reduce_stage(s.tot, ws, has_valid);
  g.sync(st);
  int32_t m1;
  {
    int32_t off;
    valid.offsets(s.tot, ws, &off, &m1);
    valid.apply_stage(
        &off, ws, has_valid,
        [&](long long r, const int32_t* v, const int32_t* ex) {
          if (!v[0]) return;
          // tpu.py scatters with max into zeros: a negative value lands as 0
          s.csrc[ex[0]] = max(ld(s.merged + ld(s.fv + r)) >> 4, 0);
          s.cval[ex[0]] = max(ld(s.valr + r), 0);
        });
  }
  g.sync(st);
  // Stages 8-9: coalesce equal neighbouring values; compaction 2 into the
  // C columns (past them the entries drop).
  const ChunkScan<1> keep2{m1};
  auto kept = [&](long long d, bool in, int32_t* v) {
    if (in) v[0] = d == 0 || ld(s.cval + d) != ld(s.cval + d - 1);
  };
  keep2.reduce_stage(s.tot, ws, kept);
  g.sync(st);
  int32_t nn;
  {
    int32_t off;
    keep2.offsets(s.tot, ws, &off, &nn);
    keep2.apply_stage(&off, ws, kept,
                      [&](long long d, const int32_t* v, const int32_t* ex) {
                        if (!v[0] || ex[0] >= C) return;
                        s.src2[ex[0]] = ld(s.csrc + d);
                        s.hvn[ex[0]] = ld(s.cval + d);
                      });
  }
  g.sync(st);
  // Stage 10: the live columns' keys from [history | endpoints], pads past
  // new_n, the verdict bytes' tail.
  const long long live = nn < 0 ? 0 : (nn < C ? nn : C);
  g.each(live, [&](long long e) {
    long long src = ld(s.src2 + e);
    src = src < 0 ? 0 : (src > C + P2 - 1 ? C + P2 - 1 : src);
    const int32_t* col = src < C ? a.hmat + src : a.smat + (src - C);
    const long long ld_col = src < C ? C : P2;
    const int32_t vn = ld(s.hvn + e);
    for (int r0 = 0; r0 <= W; r0 += kRowGroup) {
      int32_t v[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i)
        v[i] = r0 + i <= W ? col[(r0 + i) * ld_col] : 0;
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i)
        if (r0 + i <= W) a.hmat_out[(r0 + i) * C + e] = v[i];
    }
    a.hmat_out[(W + 1) * C + e] = vn;
  });
  pad_cols(g, a.hmat_out, C, W, live, C);
  if (g.leader()) {
    *a.new_n = nn;
    for (int b = 0; b < 4; ++b)
      a.st_aux[T + b] = (int8_t)(uint8_t)((nn >> (8 * b)) & 0xFF);
    a.st_aux[T + 4] = (int8_t)(nn > C);
    a.st_aux[T + 5] = (int8_t)min(*a.p2_iters, 127);
  }
  g.finish(st);
}

// ------------------------------------------------------------ redistribute

struct RedistArgs {
  const int32_t* hmat_d;  // (W + 2, C) phase 3's dense state
  const int32_t* new_n;   // ()
  int8_t* st_aux;         // (T + 6,) its overflow byte raised in place
  int32_t* out;           // (W + 2, NB_out B) out
  int32_t* counts;        // (NB_out,) out
  int32_t* btree;         // (2 NB_out,) out
  int32_t* fences;        // (W + 1, NB_out) out
  int64_t* stamps;        // null, or the stage stamps (grid.cuh Stamps)
  int W, NB_out, lgB, T;
  int vec;                // hmat_d and out 16-byte aligned, C % 4 == 0
  long long C;
};

// Tree nodes one thread block folds in shared memory at once.
constexpr int kRootFold = 4096;
// Output blocks whose subtree one thread block folds at most.
constexpr int kMaxGroup = 1024;
// Rows of 16 bytes a thread loads before it stores them.
constexpr int kRowGroup4 = 6;

// The s nodes btree[base + b s, base + (b + 1) s) of one level, held in
// smem[0, s) (after a block barrier), folded up to one node, every level's
// nodes written; smem is free again after it (every thread calls it).
__device__ void fold_subtree(int32_t* smem, int32_t* btree, long long base,
                             long long b, long long s) {
  constexpr int kPer = (kRootFold / 2 + kThreads - 1) / kThreads;
  while (s > 1) {
    s >>= 1;
    base >>= 1;
    int32_t v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = threadIdx.x + u * kThreads;
      v[u] = i < s ? max(smem[2 * i], smem[2 * i + 1]) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = threadIdx.x + u * kThreads;
      if (i < s) {
        smem[i] = v[u];
        btree[base + b * s + i] = v[u];
      }
    }
    __syncthreads();
  }
}

// Output slots 4 grp .. 4 grp + 3, one 4-slot group of output block k =
// grp / (B / 4): each of the W + 2 rows from dense columns src0.. (slots
// j < F) or pads, by 16-byte loads and stores; block k's count and fences
// from its slot-0 group. Returns the group's version maximum, pads' 0
// included.
__device__ int32_t redist_group(const RedistArgs& a, int grp, int live_end,
                                int32_t nn) {
  const int W = a.W, lgF = a.lgB - 1, F = 1 << lgF, lgQ = a.lgB - 2;
  const long long C = a.C, C_out = (long long)a.NB_out << a.lgB;
  const int k = grp >> lgQ, j0 = (grp & ((1 << lgQ) - 1)) << 2;
  const long long src0 = ((long long)k << lgF) + j0;
  const bool any = j0 < F && src0 < live_end;     // some slot live
  const bool all = j0 < F && src0 + 4 <= live_end;  // every slot live
  const long long o = (long long)grp << 2;
  int32_t vmax = 0;
  for (int r0 = 0; r0 <= W + 1; r0 += kRowGroup4) {
    int4 v[kRowGroup4];
#pragma unroll
    for (int i = 0; i < kRowGroup4; ++i) {
      const int r = r0 + i;
      const int32_t pad = r <= W ? kInf : 0;
      int4 x = make_int4(pad, pad, pad, pad);
      if (r <= W + 1 && any) {
        const int32_t* p = a.hmat_d + r * C + src0;
        if (a.vec && all) {
          x = __ldg(reinterpret_cast<const int4*>(p));
        } else {  // the group across the live edge, or an unaligned state
          if (src0 < live_end) x.x = __ldg(p);
          if (src0 + 1 < live_end) x.y = __ldg(p + 1);
          if (src0 + 2 < live_end) x.z = __ldg(p + 2);
          if (src0 + 3 < live_end) x.w = __ldg(p + 3);
        }
      }
      v[i] = x;
    }
#pragma unroll
    for (int i = 0; i < kRowGroup4; ++i) {
      const int r = r0 + i;
      if (r > W + 1) break;
      int32_t* q = a.out + r * C_out + o;
      if (a.vec) {
        __stcs(reinterpret_cast<int4*>(q), v[i]);  // streamed: not read here
      } else {
        q[0] = v[i].x;
        q[1] = v[i].y;
        q[2] = v[i].z;
        q[3] = v[i].w;
      }
      if (r == W + 1)
        vmax = max(max(v[i].x, v[i].y), max(max(v[i].z, v[i].w), vmax));
      if (j0 == 0 && r <= W)  // the block's first key, if it holds one
        a.fences[(long long)r * a.NB_out + k] =
            src0 < live_end ? v[i].x
                            : (src0 < nn ? __ldg(a.hmat_d + r * C + (C - 1))
                                         : kInf);
    }
  }
  if (j0 == 0) {
    const long long left = (long long)nn - src0;
    a.counts[k] = (int32_t)(left < 0 ? 0 : (left > F ? F : left));
  }
  return vmax;
}

__global__ void __launch_bounds__(kThreads, 4) redist_kernel(RedistArgs a) {
  extern __shared__ int32_t smem[];  // kRootFold words
  const Grid g;
  Stamps st(a.stamps);
  const long long C = a.C;
  const int NB = a.NB_out, lgQ = a.lgB - 2, lane = threadIdx.x & 31;
  const int32_t nn = *a.new_n;
  const int live_end = nn < 0 ? 0 : (nn < C ? nn : (int)C);
  // Stage 1: subtree groups of G output blocks, as many groups as the
  // largest power of two of the grid's blocks (G <= kMaxGroup): a block
  // copies its group's 4-slot groups a tile of kThreads at a time, takes
  // each output block's leaf as the maximum over its groups' threads (a
  // shuffle, then a shared atomicMax where B / 4 > 32; pads hold 0, and
  // every block has pad slots, so a leaf starts at 0), and folds the
  // group's leaves in shared memory up to the group's root.
  const int P = 1 << (31 - __clz((int)gridDim.x));
  const int G = NB / P < 1 ? 1 : (NB / P > kMaxGroup ? kMaxGroup : NB / P);
  const int groups = NB / G;
  const int per = (1 << lgQ) < 32 ? (1 << lgQ) : 32;
  for (int tg = blockIdx.x; tg < groups; tg += gridDim.x) {
    for (int i = threadIdx.x; i < G; i += kThreads) smem[i] = 0;
    __syncthreads();
    const int g0 = (tg * G) << lgQ, g1 = ((tg + 1) * G) << lgQ;
    for (int t0 = g0; t0 < g1; t0 += kThreads) {
      const int grp = t0 + threadIdx.x;
      int32_t vmax = grp < g1 ? redist_group(a, grp, live_end, nn) : 0;
      for (int d = 1; d < per; d <<= 1)
        vmax = max(vmax, __shfl_xor_sync(kFull, vmax, d));
      if (grp < g1 && (lane & (per - 1)) == 0 && vmax > 0)
        atomicMax(smem + ((grp >> lgQ) - tg * G), vmax);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G; i += kThreads)
      a.btree[(long long)NB + (long long)tg * G + i] = smem[i];
    fold_subtree(smem, a.btree, NB, tg, G);
  }
  if (g.leader()) {
    a.btree[0] = 0;
    const int8_t over = nn > ((long long)NB << (a.lgB - 1));
    if (over > a.st_aux[a.T + 4]) a.st_aux[a.T + 4] = over;
  }
  g.sync(st);
  // Stage 2: the groups' roots btree[groups, 2 groups) up to the root, by
  // one block where they fit its shared memory, else kRootFold nodes a
  // block and one grid barrier a pass.
  for (long long cur = groups; cur > 1;) {
    const long long gsz = cur < kRootFold ? cur : kRootFold;
    for (long long b = blockIdx.x; b < cur / gsz; b += gridDim.x) {
      for (long long i = threadIdx.x; i < gsz; i += kThreads)
        smem[i] = ld(a.btree + cur + b * gsz + i);
      __syncthreads();
      fold_subtree(smem, a.btree, cur, b, gsz);
    }
    cur /= gsz;
    if (cur > 1) g.sync();
  }
  g.finish(st);
}

}  // namespace

extern "C" long long fdb_compact_densify_scratch_ints(int NB, int B) {
  return DensifyScratch::words(NB, B);
}

// Densify + dedup: the block state (hmat (W + 2, NB B), counts (NB,)) as
// one sorted dense matrix of its live entries, the last of each equal-key
// run kept, pads past m2.
extern "C" int fdb_compact_densify(const void* hmat, const void* counts,
                                   void* dense, void* m2, void* scratch,
                                   void* stamps, int W, int NB, int B,
                                   void* stream) {
  if (W < 1 || NB < 1 || B < 1) return (int)cudaErrorInvalidValue;
  DensifyArgs a;
  a.hmat = (const int32_t*)hmat;
  a.counts = (const int32_t*)counts;
  a.dense = (int32_t*)dense;
  a.m2 = (int32_t*)m2;
  a.scratch = (int32_t*)scratch;
  a.stamps = (int64_t*)stamps;
  a.W = W;
  a.NB = NB;
  a.B = B;
  return launch(densify_kernel, (long long)NB * B,
                (2 * kWarps + kThreads + 1) * sizeof(int32_t), &a, stream);
}

extern "C" long long fdb_compact_ranks_scratch_ints(long long C, int P2) {
  return RanksScratch::words(C, P2);
}

// The dense resolve's ranks and phase 1. ptrs, in order: hmat, n, smat,
// q_begin, q_end, rsnap, rtxn, too_old, ub, eq, base_conf, scratch,
// stamps.
extern "C" int fdb_compact_ranks(void* const* ptrs, int W, long long C,
                                 int P2, int R, int T, void* stream) {
  if (W < 1 || C < 2 || C > INT32_MAX || P2 < 1 || R < 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  RanksArgs a;
  a.hmat = (const int32_t*)ptrs[0];
  a.n = (const int32_t*)ptrs[1];
  a.smat = (const int32_t*)ptrs[2];
  a.q_begin = (const int32_t*)ptrs[3];
  a.q_end = (const int32_t*)ptrs[4];
  a.rsnap = (const int32_t*)ptrs[5];
  a.rtxn = (const int32_t*)ptrs[6];
  a.too_old = (const uint8_t*)ptrs[7];
  a.ub = (int32_t*)ptrs[8];
  a.eq = (uint8_t*)ptrs[9];
  a.base_conf = (int32_t*)ptrs[10];
  a.scratch = (int32_t*)ptrs[11];
  a.stamps = (int64_t*)ptrs[12];
  a.W = W;
  a.C = C;
  a.P2 = P2;
  a.R = R;
  a.T = T;
  // less the run's two keys, its side columns and their indexes (none
  // for keys too wide for them)
  a.tile_cols = (kTileWords - 2 * kSteps) / (W + 1) - 2 - 2 * kSteps;
  if (a.tile_cols < 0) a.tile_cols = 0;
  // a thread an endpoint, a read, or (the levels) a 1,024-slot group a
  // block
  long long work = P2 > R ? P2 : R;
  const long long groups = (C + kFan * kFan - 1) / (kFan * kFan) * kThreads;
  if (groups > work) work = groups;
  return launch(ranks_kernel, work,
                (kTileWords + kWarps + kFan + 8) * sizeof(int32_t), &a,
                stream);
}

extern "C" long long fdb_compact_phase3_scratch_ints(long long C, int P2,
                                                     int Wr) {
  return P3Scratch::words(C, P2, 2LL * Wr);
}

// The dense resolve's phase 3: the merge by rank of the committed write
// endpoints into the dense state, stale clamp, coalesce and rebase.
// ptrs, in order: hmat, n, smat, s_begin, s_end, wtxn, w_valid, conflict,
// too_old, ub, eq, version, oldest_eff, p2_iters, hmat_out, new_n,
// st_aux, scratch.
extern "C" int fdb_compact_phase3(void* const* ptrs, int W, long long C,
                                  int P2, int Wr, int T, void* stream) {
  if (W < 1 || C < 1 || P2 < 1 || Wr < 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  Phase3Args a;
  a.hmat = (const int32_t*)ptrs[0];
  a.n = (const int32_t*)ptrs[1];
  a.smat = (const int32_t*)ptrs[2];
  a.s_begin = (const int32_t*)ptrs[3];
  a.s_end = (const int32_t*)ptrs[4];
  a.wtxn = (const int32_t*)ptrs[5];
  a.w_valid = (const uint8_t*)ptrs[6];
  a.conflict = (const int32_t*)ptrs[7];
  a.too_old = (const uint8_t*)ptrs[8];
  a.ub = (const int32_t*)ptrs[9];
  a.eq = (const uint8_t*)ptrs[10];
  a.version = (const int32_t*)ptrs[11];
  a.oldest_eff = (const int32_t*)ptrs[12];
  a.p2_iters = (const int32_t*)ptrs[13];
  a.hmat_out = (int32_t*)ptrs[14];
  a.new_n = (int32_t*)ptrs[15];
  a.st_aux = (int8_t*)ptrs[16];
  a.scratch = (int32_t*)ptrs[17];
  a.stamps = (int64_t*)ptrs[18];
  a.W = W;
  a.C = C;
  a.P2 = P2;
  a.Wr = Wr;
  a.T = T;
  return launch(phase3_kernel, C + 2LL * Wr,
                (10 * kWarps + 2 * kThreads) * sizeof(int32_t), &a, stream);
}

// Redistribute phase 3's dense state into NB_out blocks at fill B / 2 and
// rebuild the directory. ptrs, in order: hmat_d, new_n, st_aux, out,
// counts, btree, fences, stamps. NB_out and B are powers of two, B at
// least 8 (so that a block's B / 2 dense slots are whole 4-slot groups).
extern "C" int fdb_compact_redistribute(void* const* ptrs, int W, long long C,
                                        int NB_out, int B, int T,
                                        void* stream) {
  if (W < 1 || C < 1 || C > INT32_MAX || NB_out < 1 ||
      (NB_out & (NB_out - 1)) || B < 8 || (B & (B - 1)) ||
      (long long)NB_out * B > INT32_MAX || T < 1)
    return (int)cudaErrorInvalidValue;
  RedistArgs a;
  a.hmat_d = (const int32_t*)ptrs[0];
  a.new_n = (const int32_t*)ptrs[1];
  a.st_aux = (int8_t*)ptrs[2];
  a.out = (int32_t*)ptrs[3];
  a.counts = (int32_t*)ptrs[4];
  a.btree = (int32_t*)ptrs[5];
  a.fences = (int32_t*)ptrs[6];
  a.stamps = (int64_t*)ptrs[7];
  a.W = W;
  a.C = C;
  a.NB_out = NB_out;
  a.lgB = 31 - __builtin_clz((unsigned)B);
  a.T = T;
  a.vec = (uintptr_t)a.hmat_d % 16 == 0 && (uintptr_t)a.out % 16 == 0 &&
          C % 4 == 0;
  return launch(redist_kernel, (long long)NB_out * B / 4,
                kRootFold * sizeof(int32_t), &a, stream);
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
