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
// unique across the four endpoint columns, every write endpoint's block
// among the touched ids, and each touched block left with at most B - 1
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
// touched blocks in and out: chip_smoke.py block_bound). Measured on an
// H100 80GB HBM3 at 700 W, config 5's 8,192-txn chunk: decode 0.024 ms,
// phase 1 0.013, phase 3 0.073 (PERF.md). What bounds these kernels is
// latency: each is a cooperative grid whose stages are separated by grid
// barriers (a few microseconds each), and the prefix sums that cross
// blocks (the txn row starts, the explicit-end ranks, the write-endpoint
// ranks and the coverage depth) take three stages apiece. The design
// keeps the stage count low:
//
// - decode: the pad fill and every scan's tile sums in one stage, the
//   scans' four arrays side by side, then the columns scattered with each
//   row's txn id found by a binary search over the txn starts (no
//   per-row mark scatter and second scan).
// - phase 1: one thread per read; its interior maximum climbs the
//   block-max tree inside the thread (the canonical nodes of tpu.py's
//   _canonical_nodes_flat, node 0 read for an unused slot as tpu.py
//   does). The per-txn maximum is a plain store of 1 over the txn's
//   too_old bit (max is order-free).
// - phase 3: the write-endpoint ranks and the coverage depth's prefix are
//   grid scans over P2 and 2 Wr; each touched block is one warp with the
//   block's slots in the lanes: it places its endpoints (novel keys
//   insert, keys equal to history or to the previous endpoint overwrite),
//   shifts its history, takes the depth's prefix and rewrites its block,
//   counts and leaf in place, row by row through shared memory (for B up
//   to 256; a larger block's rows go through its own region of the
//   scratch, so every B the knobs allow is taken). Both places are kept
//   because the scratch rows cost more where the shared ones fit: with
//   every B's rows in the scratch, phase 3 took 0.10805-0.10842 ms warm
//   against 0.07270-0.07316 at `[full]`'s last fast chunk (B 32, 12,629
//   touched blocks) and 0.05284-0.05302 against 0.04487-0.04505 at
//   `[sharded]`'s (H100 80GB HBM3, 700 W; chip_smoke.py block_entries,
//   both versions in one run, PERF.md §6). The
//   segment tree's ancestor paths take one atomicMax a level, stopping at
//   the first node already at least the leaf: exact because on the fast
//   path a block's maximum never falls (entries are only inserted or
//   overwritten with the batch version, which is at least every stored
//   value, and nothing is collected). The kernel checks that: if any
//   touched leaf would fall (a batch version below a stored one), it
//   recomputes the paths level by level as tpu.py does. The walk is kept
//   beside the loop because the loop adds a grid barrier a level (17 at
//   NB 65,536): chip_smoke.py's phase3_levels times both on each path's
//   operands (`levels_ms` beside `ms`; PERF.md §6 has the H100's times).
//
// Interface: plain C entry points (loaded with ctypes), each launching one
// cooperative grid on the caller's stream, allocating nothing (each takes
// a scratch of fdb_block_*_scratch_ints int32) and returning the
// cudaError_t of the launch.

#include "grid.cuh"

namespace {

using namespace fdb;

// Largest B whose merge rows fit in shared memory (five rows of B words a
// warp, 40 KB a thread block at 256: under the 48 KB a launch gets
// without opting in); phase 3 keeps a larger block's rows in its scratch
// instead.
constexpr int kSmemB = 256;
constexpr int kModeIncrement = 1, kModeExplicit = 2;  // packing.MODE_*
constexpr int kStatusConflict = 1, kStatusTooOld = 2;  // types.py

// Exclusive prefix sums of up to four int32 arrays at once, across the
// grid, in three stages the caller separates by grid barriers: tiles()
// (each tile's sum), sums() (the tile sums' prefix, in place, and each
// array's total after them), apply() (each element's prefix to put).
// Array s has n[s] elements, val(s, i) giving element i; its tile sums
// and total take tiles(s) + 1 words of tsum from off[s].
struct Scan {
  int ns;
  long long n[4], off[5];
  __host__ __device__ static long long tiles(long long n) {
    return (n + kThreads - 1) / kThreads;
  }
  __host__ __device__ void init(int count, const long long* sizes) {
    ns = count;
    off[0] = 0;
    for (int s = 0; s < count; ++s) {
      n[s] = sizes[s];
      off[s + 1] = off[s] + tiles(sizes[s]) + 1;
    }
  }
  __host__ __device__ long long words() const { return off[ns]; }
  __device__ int32_t total(const int32_t* tsum, int s) const {
    return ld(tsum + off[s] + tiles(n[s]));
  }
  // Block b of the flattened tile list: its array and tile.
  __device__ bool locate(long long b, int* s, long long* t) const {
    for (int k = 0; k < ns; ++k) {
      const long long nt = tiles(n[k]);
      if (b < nt) {
        *s = k;
        *t = b;
        return true;
      }
      b -= nt;
    }
    return false;
  }
  __device__ long long all_tiles() const {
    long long a = 0;
    for (int k = 0; k < ns; ++k) a += tiles(n[k]);
    return a;
  }
  template <class V>
  __device__ void tiles_stage(int32_t* tsum, int32_t* ws, V val) const {
    const long long nt = all_tiles();
    for (long long b = blockIdx.x; b < nt; b += gridDim.x) {
      int s;
      long long t;
      locate(b, &s, &t);
      const long long i = t * kThreads + threadIdx.x;
      int32_t tot;
      block_excl(i < n[s] ? val(s, i) : 0, ws, &tot);
      if (threadIdx.x == 0) tsum[off[s] + t] = tot;
    }
  }
  __device__ void sums_stage(int32_t* tsum, int32_t* ws) const {
    for (int s = blockIdx.x; s < ns; s += gridDim.x) {
      const long long nt = tiles(n[s]);
      int32_t carry = 0;
      for (long long b = 0; b < nt; b += kThreads) {
        const long long i = b + threadIdx.x;
        const int32_t v = i < nt ? ld(tsum + off[s] + i) : 0;
        int32_t tot;
        const int32_t ex = block_excl(v, ws, &tot);
        if (i < nt) tsum[off[s] + i] = add32(carry, ex);
        carry = add32(carry, tot);
      }
      if (threadIdx.x == 0) tsum[off[s] + nt] = carry;
    }
  }
  template <class V, class P>
  __device__ void apply_stage(const int32_t* tsum, int32_t* ws, V val,
                              P put) const {
    const long long nt = all_tiles();
    for (long long b = blockIdx.x; b < nt; b += gridDim.x) {
      int s;
      long long t;
      locate(b, &s, &t);
      const long long i = t * kThreads + threadIdx.x;
      int32_t tot;
      const int32_t ex = block_excl(i < n[s] ? val(s, i) : 0, ws, &tot);
      if (i < n[s]) put(s, i, add32(ld(tsum + off[s] + t), ex));
    }
  }
};

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
  int32_t* scratch;    // starts_r T, starts_w T, eidx_r R, eidx_w Wr, tiles
  Scan scan;           // rcount, wcount (T each), explicit bits (R, Wr)
};

// The end-mode bits of one row's length field.
__device__ __forceinline__ int row_mode(int32_t lenf) { return lenf >> 14; }

// Row i of one segment (reads or writes): its begin column to smat at
// sorted position qb, its end column to qe (tpu.py decode_cols).
__device__ void decode_row(const DecodeArgs& a, long long off_keys,
                           long long off_ext, long long rows, long long n_ext,
                           long long i, int32_t eidx, long long qb,
                           long long qe) {
  const int W = (int)a.lay[kW];
  const long long P2 = a.lay[kP2];
  const int32_t* bk = a.fused + off_keys + i;  // word j at bk[j * rows]
  const int32_t lenf = bk[(long long)W * rows];
  const int32_t ln = lenf & 0x3FFF;
  const int mode = row_mode(lenf);
  const bool pad = ln == 0x3FFF;
  if (qb >= 0) {
    for (int j = 0; j < W; ++j) a.smat[j * P2 + qb] = bk[(long long)j * rows];
    a.smat[W * P2 + qb] = pad ? kInf : ln;
  }
  if (qe < 0) return;
  int32_t elen;
  if (n_ext && mode == kModeExplicit) {
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

// #elements of the nondecreasing starts[0, n) at most i.
__device__ long long upper_count(const int32_t* starts, long long n,
                                 long long i) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ld(starts + mid) <= i) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long W1 = a.lay[kW] + 1, P2 = a.lay[kP2], R = a.lay[kR],
                  Wr = a.lay[kWr], T = a.lay[kT], Er = a.lay[kEr],
                  Ew = a.lay[kEw];
  const int32_t* f = a.fused;
  const int32_t* tmeta = f + a.lay[kOffTmeta];
  const long long off_rb = a.lay[kOffRb], off_wb = a.lay[kOffWb];
  const int32_t* scal = f + a.lay[kOffScalars];
  int32_t* starts_r = a.scratch;
  int32_t* starts_w = starts_r + T;
  int32_t* eidx_r = starts_w + T;
  int32_t* eidx_w = eidx_r + R;
  int32_t* tsum = eidx_w + Wr;
  // The scans' inputs: per-txn read and write counts, explicit-end bits.
  auto val = [&](int s, long long i) -> int32_t {
    if (s == 0) return tmeta[i] & 0x7FFF;
    if (s == 1) return (tmeta[i] >> 15) & 0x7FFF;
    if (s == 2) return row_mode(f[off_rb + W1 * R - R + i]) == kModeExplicit;
    return row_mode(f[off_wb + W1 * Wr - Wr + i]) == kModeExplicit;
  };
  auto put = [&](int s, long long i, int32_t v) {
    int32_t* dst[4] = {starts_r, starts_w, eidx_r, eidx_w};
    dst[s][i] = v;
  };

  // Stage 1: the pad matrix, too_old, every scan's tile sums.
  g.each(W1 * P2, [&](long long i) { a.smat[i] = kInf; });
  g.each(T, [&](long long t) { a.too_old[t] = (tmeta[t] >> 30) & 1; });
  a.scan.tiles_stage(tsum, smem, val);
  g.sync();
  a.scan.sums_stage(tsum, smem);
  g.sync();
  a.scan.apply_stage(tsum, smem, val, put);
  g.sync();

  // Stage 2: every row's columns, txn id, snapshot, validity.
  const int32_t nr = scal[2], nw = scal[3];
  const int32_t* tsnap = f + a.lay[kOffTsnap];
  g.each(R + Wr, [&](long long k) {
    const bool rd = k < R;
    const long long i = rd ? k : k - R;
    const long long rows = rd ? R : Wr;
    const int32_t qb = f[a.lay[rd ? kOffQb : kOffSb] + i];
    const int32_t qe = f[a.lay[rd ? kOffQe : kOffSe] + i];
    decode_row(a, rd ? off_rb : off_wb, a.lay[rd ? kOffRe : kOffWe], rows,
               rd ? Er : Ew, i, ld((rd ? eidx_r : eidx_w) + i),
               sct(qb, P2), sct(qe, P2));
    long long t = upper_count(rd ? starts_r : starts_w, T, i) - 1;
    t = t < 0 ? 0 : (t > T - 1 ? T - 1 : t);
    if (rd) {
      a.rtxn[i] = (int32_t)t;
      a.rsnap[i] = i < nr ? tsnap[t] : kInf;
    } else {
      a.wtxn[i] = (int32_t)t;
      a.w_valid[i] = i < nw;
    }
  });
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
  Scan rank, depth;          // is_w over P2; the depth deltas over M
  int W, P2, Wr, T, K, NB, B;
};

// Scratch words beside the two scans' tile sums, in this order.
enum { kAccIns, kAccOverflow, kAccFell, kAccs };

// The merge rows of the touched blocks when B passes kSmemB: five rows
// of B words a block, after everything else.
__host__ __device__ inline long long merge_rows(long long K, long long B) {
  return B > kSmemB ? 5 * K * B : 0;
}

struct P3Scratch {
  int32_t *is_w, *packed, *cg, *cinfo, *dscan, *lastv, *leaf, *acc,
      *tsum_rank, *tsum_depth, *rows;
  __host__ __device__ static long long words(long long P2, long long M,
                                             long long K, long long B,
                                             const Scan& rank,
                                             const Scan& depth) {
    return P2 + 4 * M + 2 * K + kAccs + rank.words() + depth.words() +
           merge_rows(K, B);
  }
  __device__ P3Scratch(int32_t* s, long long P2, long long M, long long K,
                       const Scan& rank, const Scan& depth) {
    is_w = s;
    packed = is_w + P2;
    cg = packed + M;
    cinfo = cg + M;
    dscan = cinfo + M;
    lastv = dscan + M;
    leaf = lastv + K;
    acc = leaf + K;
    tsum_rank = acc + kAccs;
    tsum_depth = tsum_rank + rank.words();
    rows = tsum_depth + depth.words();
  }
};

// First c in [0, n) with cg[c] >= k (cg nondecreasing).
__device__ long long lower_count(const int32_t* cg, long long n, long long k) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ld(cg + mid) < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The coverage delta of compacted endpoint c: +1 at a committed begin,
// -1 at a committed end, 0 past the real endpoints.
__device__ __forceinline__ int32_t ep_delta(int32_t pe, long long c,
                                            long long n_real) {
  if (c >= n_real || !(pe & 1)) return 0;
  return ((pe >> 1) & 1) ? 1 : -1;
}

// One touched block k (gv: k < n_g) on one warp, lanes over its slots.
__device__ void merge_block(const Phase3Args& a, const P3Scratch& s,
                            int32_t* sw, long long k, long long M,
                            long long n_real, int32_t version) {
  const int lane = threadIdx.x & 31;
  const int B = a.B, W = a.W, K = a.K;
  const long long C = (long long)a.NB * B;
  int32_t* s_cnt = sw;        // inserts by in-block rank, then unused
  int32_t* s_d2 = sw + B;     // depth deltas by slot, then the depth
  int32_t* s_src = sw + 2 * B;   // new slot's source: -1 pad, < B history
                                 // slot, B + smat column
  int32_t* s_pred = sw + 3 * B;  // inserted slot's predecessor slot
  int32_t* s_row = sw + 4 * B;   // one row of the block before the merge
  const long long gk = a.g_ids[k];
  const long long g = gk < 0 ? 0 : (gk > a.NB - 1 ? a.NB - 1 : gk);
  const long long base = g * B;
  for (int i = lane; i < B; i += 32) {
    s_cnt[i] = 0;
    s_d2[i] = 0;
    s_src[i] = -1;
  }
  __syncwarp();
  const long long cs = lower_count(s.cg, M, k);
  long long ce = lower_count(s.cg, M, k + 1);
  // Endpoints whose block is past every touched id merge into the last
  // gathered block, as tpu.py's clip of gidx does.
  if (k == K - 1 && ce < n_real) ce = n_real;
  int32_t carry = 0, mine = 0;
  for (long long c0 = cs; c0 < ce; c0 += 32) {
    const long long c = c0 + lane;
    const bool v = c < ce;
    const int32_t info = v ? ld(s.cinfo + c) : 0;
    const int32_t ins = info & 1, ub = info >> 1;
    const int32_t inc = warp_incl(ins);
    const int32_t ins_le = carry + inc;
    carry += __shfl_sync(kFull, inc, 31);
    if (!v) continue;
    const int32_t pe = ld(s.packed + c);
    const int32_t dpos = ub + ins_le - 1;   // the key's merged slot
    const int32_t d = ep_delta(pe, c, n_real);
    if (d && dpos >= 0 && dpos < B) atomicAdd(s_d2 + dpos, d);
    if (ins) {
      if (ub >= 0 && ub < B) atomicAdd(s_cnt + ub, 1);
      if (dpos >= 0 && dpos < B) {
        s_src[dpos] = B + (int32_t)gat(pe >> 2, a.P2);
        s_pred[dpos] = ub - 1;
      }
      mine += ld(s.cg + c) == k;
    }
  }
  const int32_t ins_blk = warp_sum(mine);
  __syncwarp();
  // History shift (entry i moves past the inserts ranked at or before
  // it) and the depth's prefix over the merged slots.
  const int32_t nblk = a.counts[g];
  int32_t csum = 0;
  int32_t dsum = cs < M ? ld(s.dscan + cs) : a.depth.total(s.tsum_depth, 0);
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
  // Rows: keys and lengths, then versions, read whole before written.
  int32_t bmax = 0;
  for (int r = 0; r <= W + 1; ++r) {
    int32_t* row = a.hmat + r * C + base;
    for (int i = lane; i < B; i += 32) s_row[i] = row[i];
    __syncwarp();
    for (int i = lane; i < B; i += 32) {
      const int32_t src = s_src[i];
      int32_t v;
      if (r <= W) {
        v = src < 0 ? kInf
                    : (src < B ? s_row[src]
                               : a.smat[(long long)r * a.P2 + (src - B)]);
      } else {
        if (src < 0) {
          v = 0;
        } else if (src < B) {
          v = s_row[src];
        } else {
          // The value before the merge at the key's predecessor (flat
          // index k B + ub - 1, clipped, as tpu.py gathers it).
          const int32_t p = s_pred[i];
          v = p >= 0 ? s_row[p] : (k > 0 ? ld(s.lastv + k - 1) : s_row[0]);
        }
        if (src >= 0 && s_d2[i] > 0) v = version;
        if (src >= 0) bmax = max(bmax, v);
      }
      row[i] = v;
    }
    __syncwarp();
  }
  bmax = warp_max(bmax);
  if (lane == 0) {
    const int32_t cnt = nblk + ins_blk;
    a.counts[g] = cnt;
    if (cnt > B - 1) atomicOr(s.acc + kAccOverflow, 1);
    s.leaf[k] = bmax;
    if (bmax < ld(a.btree + a.NB + g)) atomicOr(s.acc + kAccFell, 1);
  }
}

__global__ void __launch_bounds__(kThreads) phase3_kernel(Phase3Args a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long P2 = a.P2, Wr = a.Wr, M = 2LL * Wr, K = a.K, T = a.T;
  const P3Scratch s(a.scratch, P2, M, K, a.rank, a.depth);
  int32_t* ws = smem;
  const int32_t nw = *a.nw, n_g = *a.n_g, version = *a.version;
  const long long n_real = 2LL * nw < M ? 2LL * nw : M;
  const long long C = (long long)a.NB * a.B;

  // Stage 1: clear, the statuses, the pre-merge last value of every
  // gathered block (tpu.py's clipped predecessor gather may read it).
  g.each(P2, [&](long long i) { s.is_w[i] = 0; });
  g.each(M, [&](long long i) { s.packed[i] = 0; });
  g.each(K, [&](long long k) {
    const long long gk = a.g_ids[k];
    const long long b = gk < 0 ? 0 : (gk > a.NB - 1 ? a.NB - 1 : gk);
    s.lastv[k] = a.hmat[(long long)(a.W + 1) * C + b * a.B + a.B - 1];
  });
  g.each(T, [&](long long t) {
    a.st_aux[t] = (int8_t)(a.too_old[t] ? kStatusTooOld
                                        : (a.conflict[t] > 0 ? kStatusConflict
                                                             : 0));
  });
  if (g.leader())
    for (int i = 0; i < kAccs; ++i) s.acc[i] = 0;
  g.sync();
  // Stage 2: mark the write endpoints' sorted positions.
  g.each(M, [&](long long e) {
    const long long p =
        sct(e < Wr ? a.s_begin[e] : a.s_end[e - Wr], P2);
    if (p >= 0) s.is_w[p] = 1;
  });
  g.sync();
  // Stages 3-5: their ranks among the write endpoints (in place).
  auto isw = [&](int, long long i) { return ld(s.is_w + i); };
  a.rank.tiles_stage(s.tsum_rank, ws, isw);
  g.sync();
  a.rank.sums_stage(s.tsum_rank, ws);
  g.sync();
  a.rank.apply_stage(s.tsum_rank, ws, isw,
                     [&](int, long long i, int32_t v) { s.is_w[i] = v; });
  g.sync();
  // Stage 6: compact the write endpoints in sorted order, bit-packed:
  // position << 2 | is_begin << 1 | committed.
  g.each(M, [&](long long e) {
    const bool beg = e < Wr;
    const long long w = beg ? e : e - Wr;
    const int32_t pos = beg ? a.s_begin[w] : a.s_end[w];
    const long long c = sct(ld(s.is_w + gat(pos, P2)), M);
    const bool cw = a.w_valid[w] && a.conflict[gat(a.wtxn[w], T)] == 0;
    if (c >= 0)
      s.packed[c] = add32((int32_t)((uint32_t)pos << 2),
                          (beg ? 2 : 0) + (cw ? 1 : 0));
  });
  g.sync();
  // Stage 7: per compacted endpoint its touched-block index (searchsorted
  // over g_ids), in-block rank and insert bit; the inserts summed for n;
  // and the depth deltas' tile sums.
  auto delta = [&](int, long long c) {
    return ep_delta(ld(s.packed + c), c, n_real);
  };
  int32_t ins_here = 0;
  g.each(M, [&](long long c) {
    const int32_t pe = ld(s.packed + c);
    const long long q = gat(pe >> 2, P2);
    bool same = c > 0;
    if (same) {
      const long long qp = gat(ld(s.packed + c - 1) >> 2, P2);
      for (int j = 0; j <= a.W && same; ++j)
        same = a.smat[(long long)j * P2 + q] == a.smat[(long long)j * P2 + qp];
    }
    const int32_t bq = a.bid[q], ub = a.lb[q] + a.eq[q];
    const bool eqk = a.eq[q] != 0, real = c < n_real;
    long long lo = 0, hi = K;  // first k with g_ids[k] >= bq
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (a.g_ids[mid] < bq) lo = mid + 1;
      else hi = mid;
    }
    const long long gi = real ? lo : K;
    const int32_t ins = real && !eqk && !same;
    s.cg[c] = (int32_t)gi;
    s.cinfo[c] = (ub << 1) | ins;
    if (ins && gi < K) ++ins_here;
  });
  {
    int32_t tot;
    block_excl(ins_here, ws, &tot);
    if (threadIdx.x == 0 && tot) atomicAdd(s.acc + kAccIns, tot);
  }
  a.depth.tiles_stage(s.tsum_depth, ws, delta);
  g.sync();
  a.depth.sums_stage(s.tsum_depth, ws);
  g.sync();
  a.depth.apply_stage(s.tsum_depth, ws, delta,
                      [&](int, long long c, int32_t v) { s.dscan[c] = v; });
  g.sync();
  // Stage 8: one warp a touched block.
  {
    // The warp's merge rows: in shared memory up to kSmemB slots, else
    // the touched block's own rows in the scratch.
    const bool shared = a.B <= kSmemB;
    int32_t* sw = smem + kWarps + (threadIdx.x >> 5) * 5 * a.B;
    const long long warps = (long long)gridDim.x * kWarps;
    for (long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
         k < n_g && k < K; k += warps)
      merge_block(a, s, shared ? sw : s.rows + k * 5 * a.B, k, M, n_real,
                  version);
  }
  g.sync();
  // Stage 9: the verdict bytes' tail, and the leaves' ancestor paths.
  const int32_t n_out = add32(*a.n, ld(s.acc + kAccIns));
  if (g.leader()) {
    *a.n_out = n_out;
    for (int b = 0; b < 4; ++b)
      a.st_aux[T + b] = (int8_t)(uint8_t)((n_out >> (8 * b)) & 0xFF);
    a.st_aux[T + 4] = (int8_t)(ld(s.acc + kAccOverflow) != 0);
    a.st_aux[T + 5] = (int8_t)min(*a.p2_iters, 127);
  }
  const long long real_k = n_g < K ? n_g : K;
  auto node = [&](long long k) {
    const long long gk = a.g_ids[k];
    return a.NB + (gk < 0 ? 0 : (gk > a.NB - 1 ? a.NB - 1 : gk));
  };
  if (!ld(s.acc + kAccFell)) {
    g.each(real_k, [&](long long k) {
      const int32_t v = ld(s.leaf + k);
      for (long long x = node(k); x >= 1; x >>= 1)
        if (atomicMax(a.btree + x, v) >= v) break;
    });
    return;
  }
  // A leaf fell: set the leaves, then each level from its children.
  g.each(real_k, [&](long long k) { a.btree[node(k)] = ld(s.leaf + k); });
  g.sync();
  for (int lv = 1; (1 << lv) <= a.NB; ++lv) {
    g.each(real_k, [&](long long k) {
      const long long x = node(k) >> lv;
      a.btree[x] = max(ld(a.btree + 2 * x), ld(a.btree + 2 * x + 1));
    });
    g.sync();
  }
}

void decode_scan(Scan* sc, const long long* lay) {
  const long long sizes[4] = {lay[kT], lay[kT], lay[kEr] ? lay[kR] : 0,
                              lay[kEw] ? lay[kWr] : 0};
  sc->init(4, sizes);
}

void phase3_scans(Scan* rank, Scan* depth, long long P2, long long Wr) {
  rank->init(1, &P2);
  const long long M = 2 * Wr;
  depth->init(1, &M);
}

}  // namespace

// int32 scratch words of the decode kernel for a FusedLayout (`lay`, the
// 18 sizes and offsets of the entry point).
extern "C" long long fdb_block_decode_scratch_ints(const long long* lay) {
  Scan sc;
  decode_scan(&sc, lay);
  return 2 * lay[kT] + lay[kR] + lay[kWr] + sc.words();
}

// Decode the fused buffer: lay = [n_words, P2, R, Wr, T, Er, Ew, off_rb,
// off_wb, off_re_ext, off_we_ext, off_q_begin, off_q_end, off_s_begin,
// off_s_end, off_tmeta, off_tsnap, off_scalars].
extern "C" int fdb_block_decode(const void* fused, void* smat, void* rtxn,
                                void* rsnap, void* wtxn, void* w_valid,
                                void* too_old, void* scratch,
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
  decode_scan(&a.scan, lay);
  long long work = (lay[kW] + 1) * lay[kP2];
  if (lay[kR] + lay[kWr] > work) work = lay[kR] + lay[kWr];
  return launch(decode_kernel, work, kWarps * sizeof(int32_t), &a, stream);
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

extern "C" long long fdb_block_phase3_scratch_ints(int P2, int Wr, int K,
                                                  int B) {
  Scan rank, depth;
  phase3_scans(&rank, &depth, P2, Wr);
  return P3Scratch::words(P2, 2LL * Wr, K, B, rank, depth);
}

// Phase 3: the touched-block merge, in place on hmat, counts and btree;
// n_out and the verdict bytes st_aux (T statuses, n_out's 4 LE bytes,
// overflow, min(p2_iters, 127)) out. ptrs, in order: hmat, counts, btree,
// n, smat, s_begin, s_end, wtxn, w_valid, nw, conflict, too_old,
// p2_iters, bid, lb, eq, g_ids, n_g, version, n_out, st_aux, scratch.
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
  phase3_scans(&a.rank, &a.depth, P2, Wr);
  a.W = W;
  a.P2 = P2;
  a.Wr = Wr;
  a.T = T;
  a.K = K;
  a.NB = NB;
  a.B = B;
  long long work = P2 > 2LL * Wr ? P2 : 2LL * Wr;
  if ((long long)K * 32 > work) work = (long long)K * 32;
  if (T > work) work = T;
  const size_t smem =
      (kWarps + (B <= kSmemB ? (size_t)kWarps * 5 * B : 0)) * sizeof(int32_t);
  return launch(phase3_kernel, work, smem, &a, stream);
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
