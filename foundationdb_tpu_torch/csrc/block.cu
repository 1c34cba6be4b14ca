// The block-sparse fast resolve's decode, phase 1 and phase 3, for Hopper
// (sm_90a).
//
// Replaces, in the JAX package's foundationdb_tpu/resolver/tpu.py (all
// XLA-jitted; none reaches a pallas_call):
//   decode  _decode_fused (:215-325), which the dense and compaction
//           kernels call too;
//   phase 1 the read-vs-history stage of _resolve_block_kernel_impl
//           (:729-759);
//   phase 3 its touched-block superset merge and segment-tree update
//           (:768-919), with the verdict bytes st_aux (:909-920).
// The rank probe (probe.cu) and phase 2 (phase2.cu) run between them. The
// plain torch versions are foundationdb_tpu_torch/resolver/block.py
// `decode_fused_ref`, `phase1_ref` and `phase3_ref`. Every output equals
// tpu.py's bit for bit on every input the host builds: sorted positions
// unique across the four endpoint columns, the touched ids sorted and
// distinct, every write endpoint's block among them, and each touched
// block left with at most B - 1
// entries (the host's pessimistic bound; where a block overflows, the
// overflow byte says so as in tpu.py, and the entries past the block are
// dropped where tpu.py spills them into the next gathered block).
//
// Why: on the card the torch version of these three stages is about a
// thousand eager launches per chunk (gathers, scatters, scans, a
// 17-level canonical-node loop and a 16-level tree loop), which the host
// pays for one by one; on the TPU the whole function is one compiled
// program. Here each stage is one launch.
//
// Bound on the card: bytes, 1-5 microseconds at the main path's shapes
// (decode the buffer and its outputs; phase 1 each read's operands and
// the blocks and tree nodes it reads; phase 3 the endpoints and the K
// touched blocks in and out: chip_smoke.py block_bound). What bounds
// them is latency: each is a cooperative grid whose stages are separated
// by grid barriers, each stage a chain of dependent loads; and the
// decode's scattered 4-byte stores into the sorted endpoint matrix
// (458,752 at config 5's 8,192-txn chunk). On an H100 80GB HBM3 at 700 W
// (PERF.md §6) a barrier takes about 2 us at the main path's grids and
// those stores about 9 us; decode takes 0.0196 ms there and phase 3
// 0.0432 (0.0242 and 0.0731 before the redesign). The stage stamps of
// the previous design (chip_smoke.py PREV_STAGES, PERF.md) put decode's
// time in each row's 13-step search over the txn starts, and phase 3's
// in 10 barriers, two serial scan stages, a merge of one row a round
// trip after two searches a touched block, and a leaf's 17 dependent
// atomics.
// The design:
//
// - decode, 1 grid barrier (3 before): the rows' scan (explicit-end
//   bits, endpoints outside the rows' slots) and the txns' scan (read and
//   write counts) are grid.cuh ChunkScans on separate ranges of the
//   grid's blocks, so that each block runs one short chain. Before the
//   barrier every row's columns are stored but an explicit end with a
//   side table, which needs its rank; after it, those ends, and each
//   txn block puts a tile's first rows in shared memory and writes its
//   rows' txn ids and snapshots (a row finds its txn by a search of the
//   tile there). Only the slots [2 (R + Wr), P2) are filled with +inf:
//   packing.py gives the 2 (R + Wr) endpoints of the padded rows the
//   distinct positions [0, 2 (R + Wr)). Where a row's position lies
//   outside those (never from packing.py), every slot is filled behind
//   one more barrier and every row written again, so the output stays
//   tpu.py's.
// - phase 1: one thread per read; its interior maximum climbs the
//   block-max tree inside the thread (the canonical nodes of tpu.py's
//   _canonical_nodes_flat, node 0 read for an unused slot as tpu.py
//   does). The per-txn maximum is a plain store of 1 over the txn's
//   too_old bit (max is order-free).
// - phase 3, 4 grid barriers (10 before): (1) each write endpoint names
//   itself, with its committed bit, at its sorted position; each touched
//   block its index in g_ids (gmap). (2) A ChunkScan's sums over the
//   sorted positions: write endpoints and committed depth deltas (a
//   stale name in the never-cleared scratch names no endpoint at that
//   position); each touched block's record (id, count, leaf, the value
//   before it). (3) The compaction: a block gathers its chunk's write
//   endpoints in shared memory, then works them a thread each, their
//   loads side by side: rank c and the depth before it from the scan,
//   key column, in-block rank, insert bit (a novel key: equal neither to
//   history nor to its predecessor), touched index (from gmap, a binary
//   search where gmap does not name it), and as the first endpoint of
//   every touched index from its predecessor's + 1 up to its own (so no
//   search over the compacted endpoints later). (4) The merge, a warp a
//   touched block, the slots in the lanes: its rows, first 32
//   endpoints and depth staged in shared memory by cp.async in one round
//   of loads (where the warps' areas pass 100 KB a thread block, as for
//   B 256, by plain loads into the block's own area in the scratch),
//   then the inserts placed, the history shifted, the depth's prefix
//   taken and the block, counts and leaf rewritten in place. (5) The
//   tree: on the fast path a block's maximum never falls (entries are
//   only inserted or overwritten with the batch version, at least every
//   stored value, and nothing is collected), so each ancestor takes the
//   maximum of its value and the new leaves under it, raised by
//   atomicMax once by each run of a warp's leaves under it (no atomic
//   waits on another); the merge checks that, and where a touched leaf
//   fell every level is recomputed from its children, a barrier a level
//   (chip_smoke.py's phase3_levels times both).
// - Stage stamps: each entry point takes an int64 buffer or null; where
//   it is given, block 0's thread 0 writes %globaltimer at the start and
//   after each grid barrier (grid.cuh Stamps), one more barrier ending
//   the kernel. block.py names the stages (DECODE_STAGES,
//   PHASE3_STAGES); chip_smoke.py's [block-stages-*] lines read them.
//
// Interface: plain C entry points (loaded with ctypes), each launching one
// cooperative grid on the caller's stream, allocating nothing (each takes
// a scratch of fdb_block_*_scratch_ints int32) and returning the
// cudaError_t of the launch.

#include "grid.cuh"

namespace {

using namespace fdb;

constexpr int kModeIncrement = 1, kModeExplicit = 2;  // packing.MODE_*
constexpr int kStatusConflict = 1, kStatusTooOld = 2;  // types.py

// ----------------------------------------------------------------- decode

// FusedLayout's sizes and offsets, in the entry point's order.
enum {
  kW, kP2, kR, kWr, kT, kEr, kEw, kOffRb, kOffWb, kOffRe, kOffWe, kOffQb,
  kOffQe, kOffSb, kOffSe, kOffTmeta, kOffTsnap, kOffScalars, kLayout
};

struct DecodeArgs {
  const int32_t* fused;
  long long lay[kLayout];
  int32_t* smat;       // (W + 1, P2) sorted endpoint matrix
  int32_t* rtxn;       // (R,)
  int32_t* rsnap;      // (R,)
  int32_t* wtxn;       // (Wr,)
  uint8_t* w_valid;    // (Wr,) bool
  uint8_t* too_old;    // (T,) bool
  int32_t* scratch;    // the two chunk scans' block sums (decode_blocks)
  int64_t* stamps;     // null, or the stage stamps (grid.cuh Stamps)
};

// The end-mode bits of one row's length field.
__device__ __forceinline__ int row_mode(int32_t lenf) { return lenf >> 14; }

// What decode_row writes: the begin column and every end column that
// needs no explicit-end rank (kCols), the end columns that do, an
// explicit end with a side table (kRankedEnds).
enum { kCols = 1, kRankedEnds = 2 };

// Row i of one segment (reads or writes): its begin column to smat at
// sorted position qb, its end column to qe (tpu.py decode_cols), the
// parts named.
__device__ void decode_row(const DecodeArgs& a, long long off_keys,
                           long long off_ext, long long rows, long long n_ext,
                           long long i, int32_t eidx, long long qb,
                           long long qe, int parts) {
  const int W = (int)a.lay[kW];
  const long long P2 = a.lay[kP2];
  const int32_t* bk = a.fused + off_keys + i;  // word j at bk[j * rows]
  const int32_t lenf = bk[(long long)W * rows];
  const int32_t ln = lenf & 0x3FFF;
  const int mode = row_mode(lenf);
  const bool pad = ln == 0x3FFF;
  const bool ranked = n_ext && mode == kModeExplicit;
  if ((parts & kCols) && qb >= 0) {
    for (int j = 0; j < W; ++j) a.smat[j * P2 + qb] = bk[(long long)j * rows];
    a.smat[W * P2 + qb] = pad ? kInf : ln;
  }
  if (qe < 0 || !(parts & (ranked ? kRankedEnds : kCols))) return;
  int32_t elen;
  if (ranked) {
    const long long e = eidx < 0 ? 0 : (eidx >= n_ext ? n_ext - 1 : eidx);
    const int32_t* ex = a.fused + off_ext + e;
    for (int j = 0; j < W; ++j)
      a.smat[j * P2 + qe] = pad ? kInf : ex[(long long)j * n_ext];
    elen = ex[(long long)W * n_ext] & 0x3FFF;
  } else if (mode == kModeIncrement) {
    // +1 with carry from the last word: a word takes the carry where
    // every word after it is all ones (INT32_MAX, biased), and wraps.
    bool carry = true;
    for (int j = W - 1; j >= 0; --j) {
      const int32_t w = bk[(long long)j * rows];
      a.smat[j * P2 + qe] = pad ? kInf : add32(w, carry ? 1 : 0);
      carry = carry && w == kInf;
    }
    elen = ln;
  } else {
    for (int j = 0; j < W; ++j)
      a.smat[j * P2 + qe] = pad ? kInf : bk[(long long)j * rows];
    elen = ln + 1;
  }
  a.smat[W * P2 + qe] = pad ? kInf : elen;
}

// #elements of the nondecreasing s[0, n) at most x.
__device__ __forceinline__ int upper_count(const int32_t* s, int n,
                                           long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The decode's two scans on blocks of their own: the rows' blocks
// (a tile of 256 rows each) and the txns' (256 txns or 512 of their rows
// each), so that each block runs one short chain of loads. The grid's
// work is both, in threads.
__host__ __device__ inline void decode_wants(const long long* lay,
                                             long long* rows,
                                             long long* txns) {
  const long long n = lay[kR] + lay[kWr];
  *rows = (n + kThreads - 1) / kThreads;
  *txns = (lay[kT] + kThreads - 1) / kThreads;
  const long long by_rows = (n + 2 * kThreads - 1) / (2 * kThreads);
  if (by_rows > *txns) *txns = by_rows;
  if (*rows < 1) *rows = 1;
  if (*txns < 1) *txns = 1;
}

__host__ __device__ inline long long decode_work(const long long* lay) {
  long long rows, txns;
  decode_wants(lay, &rows, &txns);
  return (rows + txns) * kThreads;
}

__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ int32_t smem[];
  int32_t* ws = smem;                    // 10 kWarps words
  int32_t* rstart = ws + 10 * kWarps;    // a tile's txns' first read row
  int32_t* wstart = rstart + kThreads;   // and first write row
  const Grid g;
  Stamps st(a.stamps);
  const int W = (int)a.lay[kW];
  const long long W1 = W + 1, P2 = a.lay[kP2], R = a.lay[kR],
                  Wr = a.lay[kWr], T = a.lay[kT], Er = a.lay[kEr],
                  Ew = a.lay[kEw];
  // The slots the rows own: packing.py gives the 2 (R + Wr) endpoints of
  // the padded rows the distinct positions [0, P), so no row writes
  // [P, P2).
  const long long P = 2 * (R + Wr) < P2 ? 2 * (R + Wr) : P2;
  const int32_t* f = a.fused;
  const int32_t* tmeta = f + a.lay[kOffTmeta];
  const int32_t* tsnap = f + a.lay[kOffTsnap];
  const long long off_rb = a.lay[kOffRb], off_wb = a.lay[kOffWb];
  const int32_t* scal = f + a.lay[kOffScalars];
  const int32_t nr = scal[2], nw = scal[3];
  // The per-row scan (its explicit-end bit, a read's and a write's, and
  // its endpoints outside [0, P)) on the first blocks, the per-txn read
  // and write counts on the rest, in proportion to what each wants; a
  // grid of one block runs both.
  long long want_r, want_t;
  decode_wants(a.lay, &want_r, &want_t);
  const long long G = gridDim.x;
  long long Gt = G * want_t / (want_r + want_t);
  Gt = Gt < 1 ? 1 : (Gt > G - 1 ? G - 1 : Gt);
  const long long Gr = G > 1 ? G - Gt : 1;
  const ChunkScan<3> rows{R + Wr, 0, Gr};
  const ChunkScan<2> txns{T, G > 1 ? Gr : 0, G > 1 ? Gt : 1};
  int32_t* tot_r = a.scratch;
  int32_t* tot_t = tot_r + 3 * Gr;
  auto row_val = [&](long long k, bool in, int32_t* v) {
    if (!in) return;
    const bool rd = k < R;
    const long long i = rd ? k : k - R, n = rd ? R : Wr;
    const int32_t lenf = f[(rd ? off_rb : off_wb) + W1 * n - n + i];
    const bool ex = row_mode(lenf) == kModeExplicit;
    v[rd ? 0 : 1] = ex;
    const long long qb = sct(f[a.lay[rd ? kOffQb : kOffSb] + i], P2);
    const long long qe = sct(f[a.lay[rd ? kOffQe : kOffSe] + i], P2);
    v[2] = (qb < 0 || qb >= P) + (qe < 0 || qe >= P);
  };
  auto txn_val = [&](long long t, bool in, int32_t* v) {
    if (!in) return;
    const int32_t m = tmeta[t];
    v[0] = m & 0x7FFF;
    v[1] = (m >> 15) & 0x7FFF;
  };

  // Row k's columns (k < R a read, else write k - R), the parts named.
  auto row_cols = [&](long long k, int32_t eidx, int parts) {
    const bool rd = k < R;
    const long long i = rd ? k : k - R;
    const int32_t qb = f[a.lay[rd ? kOffQb : kOffSb] + i];
    const int32_t qe = f[a.lay[rd ? kOffQe : kOffSe] + i];
    decode_row(a, rd ? off_rb : off_wb, a.lay[rd ? kOffRe : kOffWe],
               rd ? R : Wr, rd ? Er : Ew, i, eidx, sct(qb, P2), sct(qe, P2),
               parts);
  };

  // Stage 1: too_old, the slots past P, both scans' block sums, and every
  // row's columns but an explicit end with a side table (which needs its
  // rank: the scattered stores, most of the decode's time, overlap the
  // sums and the barrier).
  g.each(T, [&](long long t) { a.too_old[t] = (tmeta[t] >> 30) & 1; });
  g.each(W1 * (P2 - P), [&](long long x) {
    a.smat[(x / (P2 - P)) * P2 + P + x % (P2 - P)] = kInf;
  });
  txns.reduce_stage(tot_t, ws, txn_val);
  {
    int32_t acc[3] = {0, 0, 0};
    for (long long k = rows.lo() + threadIdx.x; k < rows.hi();
         k += kThreads) {
      int32_t v[3] = {0, 0, 0};
      row_val(k, true, v);
      for (int c = 0; c < 3; ++c) acc[c] = add32(acc[c], v[c]);
      row_cols(k, 0, kCols);
      if (k >= R) a.w_valid[k - R] = k - R < nw;
    }
    rows.publish(acc, tot_r, ws);
  }
  g.sync(st);

  // Stage 2: the first txn tile's operands, read beside both scans' block
  // sums; both scans' offsets (the sums over the blocks before this one
  // and over all) in one pass.
  const long long t1 = txns.lo() + threadIdx.x;
  int32_t tv1[2] = {0, 0};
  txn_val(t1, t1 < txns.hi(), tv1);
  int32_t off[3], all[3], offt[2], allt[2];
  {
    int32_t v[10], ex[10], sum[10];
    for (int c = 0; c < 10; ++c) v[c] = 0;
    const long long nb = Gr > txns.blocks() ? Gr : txns.blocks();
    for (long long b = threadIdx.x; b < nb; b += kThreads) {
      for (int c = 0; c < 3 && b < Gr; ++c) {
        const int32_t x = ld(tot_r + 3 * b + c);
        if (b < rows.rank()) v[c] = add32(v[c], x);
        v[3 + c] = add32(v[3 + c], x);
      }
      for (int c = 0; c < 2 && b < txns.blocks(); ++c) {
        const int32_t x = ld(tot_t + 2 * b + c);
        if (b < txns.rank()) v[6 + c] = add32(v[6 + c], x);
        v[8 + c] = add32(v[8 + c], x);
      }
    }
    block_excl_k<10>(v, ex, sum, ws);
    for (int c = 0; c < 3; ++c) {
      off[c] = sum[c];
      all[c] = sum[3 + c];
    }
    for (int c = 0; c < 2; ++c) {
      offt[c] = sum[6 + c];
      allt[c] = sum[8 + c];
    }
  }
  // The explicit ends with a side table, from their ranks. Where an
  // endpoint lies outside [0, P) (never from packing.py), some slot in
  // [0, P) may take no row: every slot is filled, behind one more
  // barrier, and every row written again.
  int parts = Er || Ew ? kRankedEnds : 0;
  if (all[2]) {
    g.each(W1 * P, [&](long long x) {
      a.smat[(x / P) * P2 + x % P] = kInf;
    });
    g.sync();
    parts = kCols | kRankedEnds;
  }
  for (long long t0 = rows.lo(); parts && t0 < rows.hi(); t0 += kThreads) {
    const long long k = t0 + threadIdx.x;
    int32_t v[3] = {0, 0, 0}, ex[3], sum[3];
    row_val(k, k < rows.hi(), v);
    block_excl_k<3>(v, ex, sum, ws);
    if (k < rows.hi())
      row_cols(k, add32(off[k < R ? 0 : 1], ex[k < R ? 0 : 1]), parts);
    for (int c = 0; c < 3; ++c) off[c] = add32(off[c], sum[c]);
  }
  // Every row's txn: a tile of the block's txns puts its first rows in
  // shared memory, and the block's threads take the tile's rows in turn,
  // each finding its txn there (the last txn of the tile starting at or
  // before it), two rows a thread at once. Rows past the last txn's take
  // T - 1 (tpu.py's clip), spread over the txns' blocks.
  if (!txns.mine()) {
    g.finish(st);
    return;
  }
  for (long long t0 = txns.lo(); t0 < txns.hi(); t0 += kThreads) {
    const long long t = t0 + threadIdx.x;
    int32_t v[2] = {tv1[0], tv1[1]}, ex[2], sum[2];
    if (t0 != txns.lo()) {
      v[0] = v[1] = 0;
      txn_val(t, t < txns.hi(), v);
    }
    block_excl_k<2>(v, ex, sum, ws);
    rstart[threadIdx.x] = add32(offt[0], ex[0]);
    wstart[threadIdx.x] = add32(offt[1], ex[1]);
    __syncthreads();
    const int nt = (int)(txns.hi() - t0 < kThreads ? txns.hi() - t0
                                                   : kThreads);
    const long long re = add32(offt[0], sum[0]), we = add32(offt[1], sum[1]);
    const long long rl = re < R ? re : R;
    for (long long r = rstart[0] + threadIdx.x; r < rl; r += 2 * kThreads) {
      const long long r2 = r + kThreads;
      const long long ta = t0 + upper_count(rstart, nt, r) - 1;
      const long long tb = r2 < rl ? t0 + upper_count(rstart, nt, r2) - 1 : 0;
      const int32_t sa = r < nr ? tsnap[ta] : kInf;
      const int32_t sb = r2 < rl && r2 < nr ? tsnap[tb] : kInf;
      a.rtxn[r] = (int32_t)ta;
      a.rsnap[r] = sa;
      if (r2 < rl) {
        a.rtxn[r2] = (int32_t)tb;
        a.rsnap[r2] = sb;
      }
    }
    for (long long r = wstart[0] + threadIdx.x; r < we && r < Wr;
         r += kThreads)
      a.wtxn[r] = (int32_t)(t0 + upper_count(wstart, nt, r) - 1);
    offt[0] = re;
    offt[1] = we;
    __syncthreads();  // rstart and wstart are free for the next tile
  }
  const long long step = txns.blocks() * kThreads;
  for (long long r = allt[0] + txns.rank() * kThreads + threadIdx.x; r < R;
       r += step) {
    a.rtxn[r] = (int32_t)(T - 1);
    a.rsnap[r] = r < nr ? tsnap[T - 1] : kInf;
  }
  for (long long r = allt[1] + txns.rank() * kThreads + threadIdx.x; r < Wr;
       r += step)
    a.wtxn[r] = (int32_t)(T - 1);
  g.finish(st);
}

// ---------------------------------------------------------------- phase 1

struct Phase1Args {
  const int32_t* hv;       // (C,) the state's version row
  const int32_t* btree;    // (2 NB,) block-max segment tree
  const int32_t* bid;      // (P2,) probe ranks
  const int32_t* lb;
  const int32_t* eq;
  const int32_t* q_begin;  // (R,)
  const int32_t* q_end;    // (R,)
  const int32_t* rsnap;    // (R,)
  const int32_t* rtxn;     // (R,)
  const uint8_t* too_old;  // (T,)
  int32_t* base_conf;      // (T,) out
  int NB, B, R, T, P2;
};

__global__ void __launch_bounds__(kThreads) phase1_kernel(Phase1Args a) {
  const Grid g;
  g.each(a.T, [&](long long t) { a.base_conf[t] = a.too_old[t] ? 1 : 0; });
  g.sync();
  const long long C = (long long)a.NB * a.B;
  g.each(a.R, [&](long long i) {
    const long long pb = gat(a.q_begin[i], a.P2), pe = gat(a.q_end[i], a.P2);
    const int32_t rb_bid = a.bid[pb], re_bid = a.bid[pe];
    const int32_t rb_ub = a.lb[pb] + a.eq[pb], re_lb = a.lb[pe];
    const bool same = rb_bid == re_bid;
    int32_t m = 0;  // version 0 is the max identity
    // Begin block's tail [rb_ub - 1, hiA) and end block's head [0, hiC).
    const int32_t hiA = same ? re_lb : a.B, hiC = same ? 0 : re_lb;
    for (int c = max(rb_ub - 1, 0); c < min(hiA, a.B); ++c) {
      long long k = (long long)rb_bid * a.B + c;
      m = max(m, a.hv[k < 0 ? 0 : (k >= C ? C - 1 : k)]);
    }
    for (int c = 0; c < min(hiC, a.B); ++c) {
      long long k = (long long)re_bid * a.B + c;
      m = max(m, a.hv[k < 0 ? 0 : (k >= C ? C - 1 : k)]);
    }
    // Interior blocks: the canonical nodes of [min(rb_bid + 1, re_bid),
    // re_bid), an unused slot reading node 0 (tpu.py _canonical_nodes_flat).
    int32_t l = min(rb_bid + 1, re_bid) + a.NB, r = re_bid + a.NB;
    const long long nodes = 2LL * a.NB;
    for (int s = a.NB; s > 0; s >>= 1) {  // NB.bit_length() steps
      const bool act = l < r;
      const bool tl = act && (l & 1), tr = act && (r & 1);
      m = max(m, ld(a.btree + gat(tl ? l : 0, nodes)));
      l += tl;
      r -= tr;
      m = max(m, ld(a.btree + gat(tr ? r : 0, nodes)));
      l >>= 1;
      r >>= 1;
    }
    if (m > a.rsnap[i]) a.base_conf[gat(a.rtxn[i], a.T)] = 1;
  });
}

// ---------------------------------------------------------------- phase 3

struct Phase3Args {
  int32_t* hmat;             // (W + 2, C) state, rewritten in place
  int32_t* counts;           // (NB,) in place
  int32_t* btree;            // (2 NB,) in place
  const int32_t* n;          // () live entries
  const int32_t* smat;       // (W + 1, P2)
  const int32_t* s_begin;    // (Wr,)
  const int32_t* s_end;      // (Wr,)
  const int32_t* wtxn;       // (Wr,)
  const uint8_t* w_valid;    // (Wr,)
  const int32_t* nw;         // ()
  const int32_t* conflict;   // (T,) phase 2's vector
  const uint8_t* too_old;    // (T,)
  const int32_t* p2_iters;   // ()
  const int32_t* bid;        // (P2,) probe ranks
  const int32_t* lb;
  const int32_t* eq;
  const int32_t* g_ids;      // (K,) touched blocks, sorted, NB-padded
  const int32_t* n_g;        // () real touched blocks
  const int32_t* version;    // () the batch's version offset
  int32_t* n_out;            // () out
  int8_t* st_aux;            // (T + 6,) out
  int32_t* scratch;
  int64_t* stamps;           // null, or the stage stamps (grid.cuh Stamps)
  int W, P2, Wr, T, K, NB, B;
  bool shared_rows;          // the merge areas in shared memory
};

// Scratch words beside the arrays: the inserts, a fallen leaf, the
// depth deltas' total.
enum { kAccIns, kAccFell, kAccDepth, kAccs };

// A touched block's staged operands (a merge slot): its W + 2 rows
// before the merge, then its first 32 endpoints' cinfo, packed and key
// words (W + 1 rows of 32), then the depth before it.
__host__ __device__ inline long long slot_words(long long W, long long B) {
  return (W + 2) * B + 32 * (W + 3) + 1;
}

// The merge's working words: its inserted endpoints' W + 2 rows by merged
// slot (key words and the predecessor's value), and per slot the
// inserts ranked at it, the depth deltas and the source.
__host__ __device__ inline long long work_words(long long W, long long B) {
  return (W + 5) * B;
}

// A warp's merge area in shared memory: a slot and working words.
__host__ __device__ inline long long warp_words(long long W, long long B) {
  return slot_words(W, B) + work_words(W, B);
}

// The merge areas of a block's warps live in shared memory where they
// fit in 100 KB (two blocks a multiprocessor; past the 48 KB a launch
// gets without opting in, the entry point opts in), as for B 32 up to
// W 16 and W 3 up to B 128; else each touched block has a slot and
// working words of its own in the scratch, filled by plain loads.
constexpr long long kMergeSmem = 100 * 1024;

__host__ __device__ inline bool merge_shared(long long W, long long B) {
  return (kWarps * warp_words(W, B) + 4 * kWarps) * 4 <= kMergeSmem;
}

// The threads the grid is sized by (its blocks at most are this over
// kThreads).
__host__ __device__ inline long long phase3_work(long long P2, long long Wr,
                                                 long long T, long long K) {
  long long w = P2 > 2 * Wr ? P2 : 2 * Wr;
  if (32 * K > w) w = 32 * K;
  return T > w ? T : w;
}

struct P3Scratch {
  int32_t *inv, *pinfo, *gmap, *rec, *first, *ins_cnt, *leaf, *packed,
      *cinfo, *dscan, *ckey, *acc, *tot, *rows;
  __host__ __device__ static long long words(long long W, long long P2,
                                             long long Wr, long long T,
                                             long long K, long long NB,
                                             long long B) {
    const long long M = 2 * Wr;
    const long long blocks =
        (phase3_work(P2, Wr, T, K) + kThreads - 1) / kThreads;
    return 2 * P2 + NB + 4 * K + (K + 1) + 2 * K + (W + 4) * M + kAccs +
           3 * blocks + (merge_shared(W, B) ? 0 : K * warp_words(W, B));
  }
  __device__ P3Scratch(int32_t* s, long long W, long long P2, long long M,
                       long long K, long long NB) {
    rec = s;                  // per touched block (int4, first for its
                              // alignment): id, count, leaf, the last
                              // value of the block before it
    inv = rec + 4 * K;        // sorted position -> the write endpoint there
    pinfo = inv + P2;         // e << 1 | committed, -1 for no write endpoint
    gmap = pinfo + P2;        // block id -> its index in g_ids
    first = gmap + NB;        // its first compacted endpoint (K + 1)
    ins_cnt = first + K + 1;  // its inserts
    leaf = ins_cnt + K;       // its new leaf
    packed = leaf + K;        // compacted endpoint c: position << 2 |
                              // is_begin << 1 | committed
    cinfo = packed + M;       // ub << 1 | insert
    dscan = cinfo + M;        // the depth deltas before it
    ckey = dscan + M;         // its key column (W + 1 rows of M)
    acc = ckey + (W + 1) * M;
    tot = acc + kAccs;        // the chunk scan's block sums, then each
                              // block's last write position
    rows = tot + 3 * (long long)gridDim.x;
  }
};

// The coverage delta of compacted endpoint c: +1 at a committed begin,
// -1 at a committed end, 0 past the real endpoints.
__device__ __forceinline__ int32_t ep_delta(int32_t pe, long long c,
                                            long long n_real) {
  if (c >= n_real || !(pe & 1)) return 0;
  return ((pe >> 1) & 1) ? 1 : -1;
}

// searchsorted(g_ids, b): the first k with g_ids[k] >= b. From gmap where
// it names a k that holds b and follows a smaller id (g_ids is sorted,
// so that k is the answer), else by a binary search.
__device__ long long touched_index(const Phase3Args& a, const P3Scratch& s,
                                  int32_t b) {
  if (b >= 0 && b < a.NB) {
    const int32_t k = ld(s.gmap + b);
    if (k >= 0 && k < a.K && a.g_ids[k] == b &&
        (k == 0 || a.g_ids[k - 1] < b))
      return k;
  }
  long long lo = 0, hi = a.K;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a.g_ids[mid] < b) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// What a warp reads first for touched block k: its record, its
// endpoints' range [cs, ce) and its inserts.
struct MergeHead {
  int4 r;  // id, count, leaf, the last value of the block before it
  long long cs, ce;
  int32_t ins;
};

__device__ __forceinline__ MergeHead merge_head(const Phase3Args& a,
                                                const P3Scratch& s,
                                                long long k,
                                                long long n_real) {
  MergeHead h;
  h.r = __ldcg((const int4*)(s.rec + 4 * k));
  h.cs = ld(s.first + k);
  h.ce = ld(s.first + k + 1);
  h.ins = ld(s.ins_cnt + k);
  // Endpoints whose block is past every touched id merge into the last
  // gathered block, as tpu.py's clip of gidx does.
  if (k == a.K - 1 && h.ce < n_real) h.ce = n_real;
  return h;
}

// Write endpoints phase 3 gathers a block before working them.
constexpr int kGather = 2 * kThreads;

// One word from device memory into shared memory by cp.async (async),
// not staged in a register, or by a load and a store (into the
// scratch). Off the card (a host compile of this file) a copy.
__device__ __forceinline__ void word_copy(int32_t* dst, const int32_t* src,
                                          bool async) {
#ifdef __CUDA_ARCH__
  if (async) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
    return;
  }
#endif
  *dst = ld(src);
}

// Waits for this thread's cp.async copies.
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

// Stage touched block k's operands (head h) into a merge slot: its rows,
// its first 32 endpoints' bits and keys, the depth before it, by
// cp.async into shared memory (one round of loads, waited for here) or
// plain copies into the scratch.
__device__ void stage_slot(const Phase3Args& a, const P3Scratch& s,
                           int32_t* slot, const MergeHead& h, long long M,
                           long long n_real, bool async) {
  const int lane = threadIdx.x & 31;
  const int B = a.B, W = a.W;
  const long long C = (long long)a.NB * B;
  for (int i = lane; i < B; i += 32) {
    const int32_t* hp = a.hmat + (long long)h.r.x * B + i;
    for (int r = 0; r <= W + 1; ++r, hp += C)
      word_copy(slot + r * B + i, hp, async);
  }
  int32_t* ep = slot + (W + 2) * B;
  const long long c = h.cs + lane;
  if (c < h.ce) {
    word_copy(ep + lane, s.cinfo + c, async);
    word_copy(ep + 32 + lane, s.packed + c, async);
    for (int j = 0; j <= W; ++j)
      word_copy(ep + 64 + 32 * j + lane, s.ckey + (long long)j * M + c,
                async);
  }
  if (lane == 0) {
    const long long cd = h.cs < n_real ? h.cs : n_real;
    word_copy(ep + 64 + 32 * (W + 1),
              cd < M ? s.dscan + cd : s.acc + kAccDepth, async);
  }
  if (async) copies_wait();
}

// Touched block k (k < n_g) on one warp, lanes over its slots, from its
// head h, its staged slot (stage_slot) and its working words.
__device__ void merge_block(const Phase3Args& a, const P3Scratch& s,
                            const int32_t* slot, int32_t* work, long long k,
                            const MergeHead& h, long long M,
                            long long n_real, int32_t version) {
  const int lane = threadIdx.x & 31;
  const int B = a.B, W = a.W;
  const long long C = (long long)a.NB * B;
  const int32_t* s_row = slot;             // (W + 2) rows of B
  const int32_t* ep = slot + (W + 2) * B;  // the first 32 endpoints
  int32_t* s_ins = work;                   // (W + 2) rows of B
  int32_t* s_cnt = s_ins + (W + 2) * B;    // inserts by in-block rank
  int32_t* s_d2 = s_cnt + B;               // depth deltas, then the depth
  int32_t* s_src = s_d2 + B;               // -1 pad, < B history slot, B
                                           // an inserted endpoint
  const long long cs = h.cs, ce = h.ce;
  for (int i = lane; i < B; i += 32) {
    s_cnt[i] = 0;
    s_d2[i] = 0;
    s_src[i] = -1;
  }
  int32_t dsum = ep[64 + 32 * (W + 1)];
  __syncwarp();
  // Endpoints: an insert takes its merged slot (ub + the inserts up to it
  // - 1) with its key and the value before the merge at its predecessor
  // (flat index k B + ub - 1, clipped, as tpu.py gathers it); every
  // committed endpoint adds its depth delta there. The first 32 come
  // from the slot, any more from device memory.
  int32_t carry = 0;
  for (long long c0 = cs; c0 < ce; c0 += 32) {
    const long long c = c0 + lane;
    const bool first = c0 == cs, v = c < ce;
    const int32_t info = !v ? 0 : (first ? ep[lane] : ld(s.cinfo + c));
    const int32_t pe = !v ? 0 : (first ? ep[32 + lane] : ld(s.packed + c));
    const int32_t ins = info & 1, ub = info >> 1;
    const unsigned bal = __ballot_sync(kFull, ins);
    const int32_t ins_le = carry + __popc(bal & (kFull >> (31 - lane)));
    carry += __popc(bal);
    if (!v) continue;
    const int32_t dpos = ub + ins_le - 1;
    const int32_t d = ep_delta(pe, c, n_real);
    if (d && dpos >= 0 && dpos < B) atomicAdd(s_d2 + dpos, d);
    if (!ins) continue;
    if (ub >= 0 && ub < B) atomicAdd(s_cnt + ub, 1);
    if (dpos < 0 || dpos >= B) continue;
    s_src[dpos] = B;
    for (int j = 0; j <= W; ++j)
      s_ins[j * B + dpos] = first ? ep[64 + 32 * j + lane]
                                  : ld(s.ckey + (long long)j * M + c);
    const int32_t p = ub - 1;
    s_ins[(W + 1) * B + dpos] = p >= 0 ? s_row[(W + 1) * B + p]
                                       : (k > 0 ? h.r.w : s_row[(W + 1) * B]);
  }
  __syncwarp();
  // History shift (entry i moves past the inserts ranked at or before
  // it) and the depth's prefix over the merged slots.
  const int32_t nblk = h.r.y;
  int32_t csum = 0;
  for (int i0 = 0; i0 < B; i0 += 32) {
    const int i = i0 + lane;
    const bool v = i < B;
    const int32_t ci = warp_incl(v ? s_cnt[i] : 0);
    const int32_t di = warp_incl(v ? s_d2[i] : 0);
    if (v) {
      s_d2[i] = add32(dsum, di);
      const int32_t dst = i + csum + ci;
      if (i < nblk && dst < B) s_src[dst] = i;
    }
    csum += __shfl_sync(kFull, ci, 31);
    dsum = add32(dsum, __shfl_sync(kFull, di, 31));
  }
  __syncwarp();
  // The merged block's rows, from the staged rows and inserts (a pad
  // slot: +inf keys, version 0).
  int32_t bmax = 0;
  for (int i = lane; i < B; i += 32) {
    const int32_t src = s_src[i];
    const int32_t* sp = src < 0 ? nullptr : (src < B ? s_row + src : s_ins + i);
    int32_t* hp = a.hmat + (long long)h.r.x * B + i;
    for (int j = 0; j <= W; ++j, hp += C) *hp = sp ? sp[j * B] : kInf;
    int32_t v = sp ? sp[(W + 1) * B] : 0;
    if (sp && s_d2[i] > 0) v = version;
    if (sp) bmax = max(bmax, v);
    *hp = v;
  }
  bmax = warp_max(bmax);
  if (lane == 0) {
    const int32_t cnt = nblk + h.ins;
    a.counts[h.r.x] = cnt;
    if (cnt > B - 1) a.st_aux[a.T + 4] = 1;
    s.leaf[k] = bmax;
    if (bmax < h.r.z) atomicOr(s.acc + kAccFell, 1);
  }
}

__global__ void __launch_bounds__(kThreads) phase3_kernel(Phase3Args a) {
  extern __shared__ int32_t smem[];
  int32_t* ws = smem;                 // 4 kWarps words
  int32_t* q_pos = ws + 4 * kWarps;   // the block's gathered write
  int32_t* q_x = q_pos + kGather;     // endpoints: positions, bits,
  int32_t* q_d = q_x + kGather;       // depth deltas before them and
  int32_t* q_gi = q_d + kGather;      // touched indexes
  const Grid g;
  Stamps st(a.stamps);
  const long long P2 = a.P2, Wr = a.Wr, M = 2LL * Wr, K = a.K, T = a.T;
  const int W = a.W, NB = a.NB;
  const P3Scratch s(a.scratch, W, P2, M, K, NB);
  const int32_t nw = *a.nw, n_g = *a.n_g, version = *a.version;
  const long long n_real = 2LL * nw < M ? 2LL * nw : M;
  const long long C = (long long)NB * a.B;
  const long long real_k = n_g < K ? n_g : K;
  auto epos = [&](long long e) {
    return e < Wr ? a.s_begin[e] : a.s_end[e - Wr];
  };
  auto clip = [&](long long gk) {
    return gk < 0 ? 0 : (gk > NB - 1 ? NB - 1 : gk);
  };

  // Stage 1: each write endpoint names itself, with its committed bit, at
  // its sorted position; each touched block its index (gmap); the
  // statuses.
  g.each(M, [&](long long e) {
    const long long p = sct(epos(e), P2);
    const long long w = e < Wr ? e : e - Wr;
    const bool cw = a.w_valid[w] && a.conflict[gat(a.wtxn[w], T)] == 0;
    if (p >= 0) s.inv[p] = (int32_t)(e << 1) | (int32_t)cw;
  });
  g.each(K + 1, [&](long long k) {
    s.first[k] = (int32_t)M;
    if (k == K) return;
    s.ins_cnt[k] = 0;
    const int32_t gk = a.g_ids[k];
    if (gk >= 0 && gk < NB) s.gmap[gk] = (int32_t)k;
  });
  g.each(T, [&](long long t) {
    a.st_aux[t] = (int8_t)(a.too_old[t] ? kStatusTooOld
                                        : (a.conflict[t] > 0 ? kStatusConflict
                                                             : 0));
  });
  if (g.leader()) {
    for (int i = 0; i < kAccs; ++i) s.acc[i] = 0;
    a.st_aux[T + 4] = 0;
  }
  g.sync(st);

  // Stage 2: over the block's chunk of sorted positions, those that hold
  // a write endpoint (inv names one at that position: the scratch is
  // never cleared, and a stale word names none or that one) and its
  // committed depth delta; the chunk's sums and last write position; the
  // touched blocks' records.
  const ChunkScan<2> pos{P2};
  {
    int32_t acc[2] = {0, 0};
    int32_t last = -1;
    for (long long p = pos.lo() + threadIdx.x; p < pos.hi(); p += kThreads) {
      int32_t x = ld(s.inv + p);
      const int32_t e = x >> 1;
      if (e >= 0 && e < M && sct(epos(e), P2) == p) {
        acc[0] += 1;
        acc[1] = add32(acc[1], (x & 1) ? (e < Wr ? 1 : -1) : 0);
        last = (int32_t)p;
      } else {
        x = -1;
      }
      s.pinfo[p] = x;
    }
    pos.publish(acc, s.tot, ws);
    last = block_max(last, ws);
    if (threadIdx.x == 0) s.tot[2LL * gridDim.x + blockIdx.x] = last;
  }
  // Each touched block's record for the merge; tpu.py's clipped
  // predecessor gather may read the last slot of the block gathered
  // before it.
  g.each(K, [&](long long k) {
    const long long b = clip(a.g_ids[k]);
    const long long bp = k > 0 ? clip(a.g_ids[k - 1]) : 0;
    *(int4*)(s.rec + 4 * k) = make_int4(
        (int32_t)b, a.counts[b], a.btree[NB + b],
        a.hmat[(W + 1) * C + bp * a.B + a.B - 1]);
  });
  g.sync(st);

  // Stage 3: the write endpoints compacted in sorted order, their ranks c
  // and the depth deltas before them from the scan. The block first
  // gathers its chunk's endpoints in shared memory (a scan a tile), then
  // works them a thread each, their chains of loads side by side: each
  // with its predecessor's position (the previous gathered one, or the
  // blocks before's last write position) and touched index, its key
  // column, in-block rank ub, insert bit (a novel key: equal neither to
  // history nor to its predecessor), touched index gi, and as the first
  // endpoint of each touched index past its predecessor's up to gi.
  {
    // the block's first tile's bits, read before the sums that place them
    const int32_t x1 = pos.lo() + threadIdx.x < pos.hi()
                           ? ld(s.pinfo + pos.lo() + threadIdx.x) : -1;
    int32_t off[2], all[2];
    pos.offsets(s.tot, ws, off, all);
    int32_t prev_p = -1;
    for (long long b = threadIdx.x; b < blockIdx.x; b += kThreads)
      prev_p = max(prev_p, ld(s.tot + 2LL * gridDim.x + b));
    prev_p = block_max(prev_p, ws);
    // touched index of endpoint c at position p: K past the real ones
    auto gi_of = [&](long long c, long long p) -> int32_t {
      return c < n_real ? (int32_t)touched_index(a, s, a.bid[p])
                        : (int32_t)K;
    };
    if (g.leader()) s.acc[kAccDepth] = all[1];
    int32_t prev_gi = -2;  // not known yet
    int32_t ins_here = 0;
    int n_q = 0;           // endpoints gathered
    long long c_q = off[0];  // the first one's rank
    // Work the gathered endpoints q_* [0, n_q), ranks from c_q.
    auto work = [&]() {
      for (int j0 = 0; j0 < n_q; j0 += kThreads) {
        const int j = j0 + threadIdx.x;
        int32_t gi = 0, ins = 0, gp = 0;
        const bool v = j < n_q;
        if (v) {
          const long long c = c_q + j;
          const int32_t p = q_pos[j], x = q_x[j];
          const int32_t pp = j > 0 ? q_pos[j - 1] : prev_p;
          bool same = c > 0 && pp >= 0;
          for (int r = 0; r <= W; ++r) {
            const int32_t kw = a.smat[(long long)r * P2 + p];
            if (same) same = kw == a.smat[(long long)r * P2 + pp];
            s.ckey[(long long)r * M + c] = kw;
          }
          const int32_t eqk = a.eq[p], ub = a.lb[p] + eqk;
          gi = gi_of(c, p);
          if (j == 0)
            gp = prev_gi != -2 ? prev_gi : (pp >= 0 ? gi_of(c - 1, pp) : -1);
          ins = c < n_real && !eqk && !same;
          const bool beg = (x >> 1) < Wr;
          s.packed[c] = add32((int32_t)((uint32_t)p << 2),
                              (beg ? 2 : 0) + (x & 1));
          s.cinfo[c] = (ub << 1) | ins;
          s.dscan[c] = q_d[j];
        }
        __syncthreads();  // q_gi of the group before is read
        if (v) q_gi[j] = gi;
        __syncthreads();
        if (v) {
          const long long c = c_q + j;
          if (j > 0) gp = q_gi[j - 1];
          for (long long kk = gp + 1; kk <= gi && kk <= K; ++kk)
            s.first[kk] = (int32_t)c;
          if (ins && gi < K) {
            atomicAdd(s.ins_cnt + gi, 1);
            ++ins_here;
          }
        }
      }
      __syncthreads();
      if (n_q) {
        prev_p = q_pos[n_q - 1];
        prev_gi = q_gi[n_q - 1];
      }
      c_q += n_q;
      n_q = 0;
      __syncthreads();  // the q_* arrays are free
    };
    for (long long t0 = pos.lo(); t0 < pos.hi(); t0 += kThreads) {
      const long long p = t0 + threadIdx.x;
      const int32_t x = t0 == pos.lo() ? x1
                                       : (p < pos.hi() ? ld(s.pinfo + p) : -1);
      const bool wp = x >= 0;
      const bool beg = wp && (x >> 1) < Wr;
      int32_t v[2] = {wp, wp && (x & 1) ? (beg ? 1 : -1) : 0}, ex[2], sum[2];
      block_excl_k<2>(v, ex, sum, ws);
      if (wp) {
        q_pos[n_q + ex[0]] = (int32_t)p;
        q_x[n_q + ex[0]] = x;
        q_d[n_q + ex[0]] = add32(off[1], ex[1]);
      }
      n_q += sum[0];
      off[1] = add32(off[1], sum[1]);
      __syncthreads();
      if (n_q > kGather - kThreads) work();
    }
    work();
    int32_t tot;
    block_excl(ins_here, ws, &tot);
    if (threadIdx.x == 0 && tot) atomicAdd(s.acc + kAccIns, tot);
  }
  g.sync(st);

  // Stage 4: the verdict bytes' tail; one warp a touched block.
  if (g.leader()) {
    const int32_t n_out = add32(*a.n, ld(s.acc + kAccIns));
    *a.n_out = n_out;
    for (int b = 0; b < 4; ++b)
      a.st_aux[T + b] = (int8_t)(uint8_t)((n_out >> (8 * b)) & 0xFF);
    a.st_aux[T + 5] = (int8_t)min(*a.p2_iters, 127);
  }
  {
    // A warp's blocks k, k + warps, ...: each staged into the warp's slot
    // in shared memory by cp.async (or, where it does not fit, the
    // block's own slot in the scratch), the next block's head read
    // meanwhile.
    const long long warps = (long long)gridDim.x * kWarps;
    const long long sw = slot_words(W, a.B), mw = warp_words(W, a.B);
    int32_t* area = smem + 4 * kWarps + (threadIdx.x >> 5) * mw;
    long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    MergeHead h;
    if (k < real_k) h = merge_head(a, s, k, n_real);
    for (; k < real_k; k += warps) {
      MergeHead next;  // the warp's next block's head, read meanwhile
      if (k + warps < real_k) next = merge_head(a, s, k + warps, n_real);
      int32_t* slot = a.shared_rows ? area : s.rows + k * mw;
      stage_slot(a, s, slot, h, M, n_real, a.shared_rows);
      __syncwarp();
      merge_block(a, s, slot, slot + sw, k, h, M, n_real, version);
      __syncwarp();  // the slot is free to fill again
      h = next;
    }
  }
  g.sync(st);

  // Stage 5: the leaves' ancestors. On the fast path no leaf falls (its
  // entries are only inserted or overwritten with the batch version, at
  // least every stored value), so each ancestor takes the maximum of its
  // old value and the new leaves under it: each run of a warp's leaves
  // under one ancestor (g_ids is sorted, so runs are contiguous) raises
  // it once by atomicMax, every level at once, no atomic waiting on
  // another (at most 32 leaves in all: each leaf its own ancestors).
  // Where a leaf fell, the leaves are set and each level recomputed from
  // its children, a barrier a level.
  auto node = [&](long long k) { return NB + clip(a.g_ids[k]); };
  if (!ld(s.acc + kAccFell) && real_k <= 32) {
    // few leaves: each raises its own ancestors
    g.each(real_k, [&](long long k) {
      const int32_t leaf = ld(s.leaf + k);
      for (long long x = node(k); x >= 1; x >>= 1) atomicMax(a.btree + x, leaf);
    });
    g.finish(st);
    return;
  }
  if (!ld(s.acc + kAccFell)) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * kWarps;
    for (long long k0 =
             ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
         k0 < real_k; k0 += warps * 32) {
      const long long k = k0 + lane;
      const bool v = k < real_k;
      const int32_t leaf = v ? ld(s.leaf + k) : 0;
      const long long x = v ? node(k) : 0;
      for (int l = 0; (1LL << l) <= NB; ++l) {
        const long long key = v ? x >> l : -1 - lane;
        int32_t m = leaf;  // the run's maximum, at its first lane
        for (int d = 1; d < 32; d <<= 1) {
          const int32_t mo = __shfl_down_sync(kFull, m, d);
          const long long ko = __shfl_down_sync(kFull, key, d);
          if (lane + d < 32 && ko == key) m = max(m, mo);
        }
        const long long kp = __shfl_up_sync(kFull, key, 1);
        if (v && (lane == 0 || kp != key)) atomicMax(a.btree + key, m);
      }
    }
    g.finish(st);
    return;
  }
  g.each(real_k, [&](long long k) { a.btree[node(k)] = ld(s.leaf + k); });
  g.sync();
  for (int lv = 1; (1 << lv) <= NB; ++lv) {
    g.each(real_k, [&](long long k) {
      const long long x = node(k) >> lv;
      a.btree[x] = max(ld(a.btree + 2 * x), ld(a.btree + 2 * x + 1));
    });
    g.sync();
  }
  g.finish(st);
}

}  // namespace

// int32 scratch words of the decode kernel for a FusedLayout (`lay`, the
// 18 sizes and offsets of the entry point): the two chunk scans' block
// sums (at most five a block of the grid).
extern "C" long long fdb_block_decode_scratch_ints(const long long* lay) {
  return 5 * ((decode_work(lay) + kThreads - 1) / kThreads);
}

// Decode the fused buffer: lay = [n_words, P2, R, Wr, T, Er, Ew, off_rb,
// off_wb, off_re_ext, off_we_ext, off_q_begin, off_q_end, off_s_begin,
// off_s_end, off_tmeta, off_tsnap, off_scalars]; stamps null, or the
// stage stamps.
extern "C" int fdb_block_decode(const void* fused, void* smat, void* rtxn,
                                void* rsnap, void* wtxn, void* w_valid,
                                void* too_old, void* scratch, void* stamps,
                                const long long* lay, void* stream) {
  DecodeArgs a;
  for (int i = 0; i < kLayout; ++i) a.lay[i] = lay[i];
  if (lay[kW] < 1 || lay[kP2] < 1 || lay[kR] < 0 || lay[kWr] < 0 ||
      lay[kT] < 1)
    return (int)cudaErrorInvalidValue;
  a.fused = (const int32_t*)fused;
  a.smat = (int32_t*)smat;
  a.rtxn = (int32_t*)rtxn;
  a.rsnap = (int32_t*)rsnap;
  a.wtxn = (int32_t*)wtxn;
  a.w_valid = (uint8_t*)w_valid;
  a.too_old = (uint8_t*)too_old;
  a.scratch = (int32_t*)scratch;
  a.stamps = (int64_t*)stamps;
  const size_t smem = (10 * kWarps + 2 * kThreads) * sizeof(int32_t);
  return launch(decode_kernel, decode_work(lay), smem, &a, stream);
}

// Phase 1: base_conf[t] = max(too_old[t], any read of t whose history
// range maximum passes its snapshot).
extern "C" int fdb_block_phase1(const void* hv, const void* btree,
                                const void* bid, const void* lb,
                                const void* eq, const void* q_begin,
                                const void* q_end, const void* rsnap,
                                const void* rtxn, const void* too_old,
                                void* base_conf, int NB, int B, int R, int T,
                                int P2, void* stream) {
  if (NB < 1 || (NB & (NB - 1)) || B < 1 || R < 0 || T < 1 || P2 < 1)
    return (int)cudaErrorInvalidValue;
  Phase1Args a;
  a.hv = (const int32_t*)hv;
  a.btree = (const int32_t*)btree;
  a.bid = (const int32_t*)bid;
  a.lb = (const int32_t*)lb;
  a.eq = (const int32_t*)eq;
  a.q_begin = (const int32_t*)q_begin;
  a.q_end = (const int32_t*)q_end;
  a.rsnap = (const int32_t*)rsnap;
  a.rtxn = (const int32_t*)rtxn;
  a.too_old = (const uint8_t*)too_old;
  a.base_conf = (int32_t*)base_conf;
  a.NB = NB;
  a.B = B;
  a.R = R;
  a.T = T;
  a.P2 = P2;
  return launch(phase1_kernel, R > T ? R : T, 0, &a, stream);
}

extern "C" long long fdb_block_phase3_scratch_ints(int W, int P2, int Wr,
                                                  int T, int K, int NB,
                                                  int B) {
  return P3Scratch::words(W, P2, Wr, T, K, NB, B);
}

// Phase 3: the touched-block merge, in place on hmat, counts and btree;
// n_out and the verdict bytes st_aux (T statuses, n_out's 4 LE bytes,
// overflow, min(p2_iters, 127)) out. ptrs, in order: hmat, counts, btree,
// n, smat, s_begin, s_end, wtxn, w_valid, nw, conflict, too_old,
// p2_iters, bid, lb, eq, g_ids, n_g, version, n_out, st_aux, scratch,
// stamps (null, or the stage stamps).
extern "C" int fdb_block_phase3(void* const* ptrs, int W, int P2, int Wr,
                                int T, int K, int NB, int B, void* stream) {
  if (W < 1 || P2 < 1 || Wr < 0 || T < 1 || K < 1 || NB < 1 ||
      (NB & (NB - 1)) || B < 1)
    return (int)cudaErrorInvalidValue;
  Phase3Args a;
  a.hmat = (int32_t*)ptrs[0];
  a.counts = (int32_t*)ptrs[1];
  a.btree = (int32_t*)ptrs[2];
  a.n = (const int32_t*)ptrs[3];
  a.smat = (const int32_t*)ptrs[4];
  a.s_begin = (const int32_t*)ptrs[5];
  a.s_end = (const int32_t*)ptrs[6];
  a.wtxn = (const int32_t*)ptrs[7];
  a.w_valid = (const uint8_t*)ptrs[8];
  a.nw = (const int32_t*)ptrs[9];
  a.conflict = (const int32_t*)ptrs[10];
  a.too_old = (const uint8_t*)ptrs[11];
  a.p2_iters = (const int32_t*)ptrs[12];
  a.bid = (const int32_t*)ptrs[13];
  a.lb = (const int32_t*)ptrs[14];
  a.eq = (const int32_t*)ptrs[15];
  a.g_ids = (const int32_t*)ptrs[16];
  a.n_g = (const int32_t*)ptrs[17];
  a.version = (const int32_t*)ptrs[18];
  a.n_out = (int32_t*)ptrs[19];
  a.st_aux = (int8_t*)ptrs[20];
  a.scratch = (int32_t*)ptrs[21];
  a.stamps = (int64_t*)ptrs[22];
  a.W = W;
  a.P2 = P2;
  a.Wr = Wr;
  a.T = T;
  a.K = K;
  a.NB = NB;
  a.B = B;
  a.shared_rows = merge_shared(W, B);
  const long long rows = a.shared_rows ? kWarps * warp_words(W, B) : 0;
  const size_t smem =
      (4 * kWarps + (rows > 4 * kGather ? rows : 4 * kGather)) *
      sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        phase3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return launch(phase3_kernel, phase3_work(P2, Wr, T, K), smem, &a, stream);
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
