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
// Why: on the card the torch version of the compaction is about 840
// eager launches, which the host pays for one by one and the device runs
// as many small passes over the C-column state; here it is four launches
// around the decode and phase 2.
//
// Bound on the card: bytes. The state (W + 2 rows of C int32) in and out
// of densify, phase3 and redistribute, the endpoints and the reads' ranks
// for ranks: 0.0155, 0.0013, 0.0157 and 0.0151 ms at config 5's C = 2^21
// (chip_smoke.py compact_bound). Measured on an H100 80GB HBM3 at 700 W
// there: densify 0.106 ms, ranks 0.046, dense_phase3 0.304, redistribute
// 0.063 (PERF.md). What bounds these kernels is, as in block.cu, their
// grid barriers (a few microseconds each, 17 in phase 3) and the scans
// that cross blocks. The design:
//
// - Every kernel is one cooperative grid; a prefix sum over the grid is
//   three stages (tile sums, their prefix, the apply) and can carry
//   several sums of one element at once (TupleScan).
// - densify: the blocks' counts are prefix-summed, then each dense
//   position finds its block by a binary search over those prefixes (no
//   scatter into a C-column buffer and no second gather); the dedup's
//   keep bits are one scan whose apply writes each kept column.
// - ranks: tpu.py's halving walk over the dense keys, one thread a query,
//   which saturates at C - 1 exactly as tpu.py's does. Phase 1 needs range
//   maxima of the version row without tpu.py's (log C + 1) x C sparse
//   table: the kernel builds maxima of 32, 1,024, ... slots (C / 31 words)
//   and answers each of tpu.py's two power-of-two windows from them,
//   with the table's edges (a window past C takes the identity 0, an
//   empty range gives 0, a negative lo clips to 0): grid.cuh's Levels,
//   which rankfed.cu's phase 1 shares. Ranking against the
//   block state before densify (the probe) would need the columns dedup
//   drops subtracted again, so the walk runs on the dense state.
// - phase3: the write endpoints are compacted in sorted order by a scan
//   over P2; the history's merged positions come from a binary search over
//   the endpoints' ranks (they never fall), so the merged space is one
//   scatter of a permutation. One five-way scan gives each merged slot its
//   history, committed-begin, committed-end, valid and run-start counts;
//   its apply writes, per run of equal keys, the value at the run's end
//   (covered, stale clamp, rebase) and, by atomicMin, the run's first
//   valid slot. The run compaction and the coalesce are then two scans
//   whose applies write the destinations directly, and the last stage
//   gathers the keys from [history | endpoints].
// - redistribute: each output column finds its dense source arithmetically
//   (block c / B, slot c % B, source block * F + slot); leaves are a warp's
//   maximum over a block; the segment tree is folded 256 leaves a thread
//   block in shared memory, one grid barrier per 8 levels.
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

// ---------------------------------------------------------------- densify

struct DensifyArgs {
  const int32_t* hmat;    // (W + 2, NB B) block state
  const int32_t* counts;  // (NB,)
  int32_t* dense;         // (W + 2, C) out: live prefixes, deduplicated
  int32_t* m2;            // () out: its live columns
  int32_t* scratch;       // incl NB, keep C, the two scans' tile sums
  TupleScan<1> cnt, keep;
  int W, NB, B;
};

// The state slot of dense position p (p < C), or -1 for a pad: the block
// k whose live prefix holds p (the first with incl[k] > p) and p's offset
// into it, a pad where the offset reaches B (a block past B entries
// scatters only its first B, as tpu.py's densify does).
__device__ long long dense_source(const DensifyArgs& a, const int32_t* incl,
                                  long long p) {
  long long lo = 0, hi = a.NB;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ld(incl + mid) <= p) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= a.NB) return -1;
  const long long j = p - (lo ? ld(incl + lo - 1) : 0);
  return j < a.B ? lo * a.B + j : -1;
}

__global__ void __launch_bounds__(kThreads) densify_kernel(DensifyArgs a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long C = (long long)a.NB * a.B;
  const int W = a.W;
  int32_t* incl = a.scratch;
  int32_t* keepf = incl + a.NB;
  int32_t* tsum_cnt = keepf + C;
  int32_t* tsum_keep = tsum_cnt + TupleScan<1>::words(a.NB);
  // Stages 1-3: the counts' inclusive prefix.
  auto cval = [&](long long k, int32_t* v) { v[0] = a.counts[k]; };
  a.cnt.tiles_stage(tsum_cnt, smem, cval);
  g.sync();
  a.cnt.sums_stage(tsum_cnt, smem);
  g.sync();
  a.cnt.apply_stage(tsum_cnt, smem, cval,
                    [&](long long k, const int32_t* v, const int32_t* ex) {
                      incl[k] = add32(ex[0], v[0]);
                    });
  g.sync();
  // Stages 4-6: keep the last of each equal-key run among the first m
  // positions; each kept column goes to its rank, pads fill the rest.
  const int32_t m = a.cnt.total(tsum_cnt, 0);
  auto key = [&](long long src, int r) {
    return src < 0 ? kInf : a.hmat[r * C + src];
  };
  a.keep.tiles_stage(tsum_keep, smem, [&](long long p, int32_t* v) {
    bool k = p < m;
    if (k && p + 1 < C) {
      const long long s0 = dense_source(a, incl, p),
                      s1 = dense_source(a, incl, p + 1);
      bool same = true;
      for (int r = 0; r <= W && same; ++r) same = key(s0, r) == key(s1, r);
      k = !same;
    }
    keepf[p] = v[0] = k;
  });
  g.sync();
  a.keep.sums_stage(tsum_keep, smem);
  g.sync();
  const int32_t m2 = a.keep.total(tsum_keep, 0);
  a.keep.apply_stage(
      tsum_keep, smem, [&](long long p, int32_t* v) { v[0] = ld(keepf + p); },
      [&](long long p, const int32_t* v, const int32_t* ex) {
        if (!v[0]) return;
        const long long src = dense_source(a, incl, p);
        for (int r = 0; r <= W + 1; ++r)
          a.dense[r * C + ex[0]] =
              src >= 0 ? a.hmat[r * C + src] : (r <= W ? kInf : 0);
      });
  g.each(C, [&](long long q) {
    if (q < m2)
      return;
    for (int r = 0; r <= W + 1; ++r) a.dense[r * C + q] = r <= W ? kInf : 0;
  });
  if (g.leader()) *a.m2 = m2;
}

// ------------------------------------------------------------------ ranks

struct RanksArgs {
  const int32_t* hmat;     // (W + 2, C) dense state
  const int32_t* smat;     // (W + 1, P2) sorted endpoints
  const int32_t* q_begin;  // (R,)
  const int32_t* q_end;
  const int32_t* rsnap;
  const int32_t* rtxn;
  const uint8_t* too_old;  // (T,)
  int32_t* ub;             // (P2,) out: #history <= key (C for a pad)
  uint8_t* eq;             // (P2,) out: the history entry at lb equals it
  int32_t* base_conf;      // (T,) out
  int32_t* scratch;        // lb P2, the levels
  Levels lv;
  int W, P2, R, T;
  long long C;
};

__global__ void __launch_bounds__(kThreads) ranks_kernel(RanksArgs a) {
  const Grid g;
  const long long C = a.C, P2 = a.P2;
  const int W = a.W;
  const int32_t* hv = a.hmat + (W + 1) * C;
  int32_t* lb = a.scratch;
  int32_t* lvls = lb + P2;
  // Stage 1: the ranks (tpu.py's halving walk), base_conf = too_old,
  // the first maximum level.
  g.each(a.T, [&](long long t) { a.base_conf[t] = a.too_old[t] ? 1 : 0; });
  g.each(P2, [&](long long q) {
    long long pos = 0;
    for (long long s = C / 2; s >= 1; s /= 2)
      if (key_lt(a.hmat, C, pos + s - 1, a.smat, P2, q, W)) pos += s;
    const bool e =
        key_eq(a.hmat, C, pos < C - 1 ? pos : C - 1, a.smat, P2, q, W);
    lb[q] = (int32_t)pos;
    a.eq[q] = e;
    a.ub[q] = a.smat[W * P2 + q] == kInf ? (int32_t)C : (int32_t)pos + e;
  });
  a.lv.build(g, hv, lvls);
  // Last stage: each read's history maximum over [rank_b - 1, rank_e) by
  // tpu.py's two overlapping power-of-two windows.
  g.each(a.R, [&](long long i) {
    const int32_t hi = ld(lb + gat(a.q_end[i], P2));
    const int32_t lo = add32(ld(a.ub + gat(a.q_begin[i], P2)), -1);
    if (a.lv.window_max(hv, lvls, lo, hi, 64) > a.rsnap[i])
      a.base_conf[gat(a.rtxn[i], a.T)] = 1;
  });
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
  int W, P2, Wr, T;
  long long C;
};

// The scratch of phase 3, in this order.
struct P3Scratch {
  int32_t *is_w, *packed, *ubc, *vb, *posb, *merged, *fv, *valr, *csrc,
      *cval, *src2, *hvn, *t_rank, *t_runs, *t_valid, *t_keep;
  __host__ __device__ static long long words(long long C, long long P2,
                                             long long M) {
    const long long N3 = C + M;
    return P2 + 4 * M + 5 * N3 + 2 * C + TupleScan<1>::words(P2) +
           TupleScan<5>::words(N3) + 2 * TupleScan<1>::words(N3);
  }
  __device__ P3Scratch(int32_t* s, long long C, long long P2, long long M) {
    const long long N3 = C + M;
    is_w = s;
    packed = is_w + P2;
    ubc = packed + M;
    vb = ubc + M;
    posb = vb + M;
    merged = posb + M;
    fv = merged + N3;
    valr = fv + N3;
    csrc = valr + N3;
    cval = csrc + N3;
    src2 = cval + N3;
    hvn = src2 + C;
    t_rank = hvn + C;
    t_runs = t_rank + TupleScan<1>::words(P2);
    t_valid = t_runs + TupleScan<5>::words(N3);
    t_keep = t_valid + TupleScan<1>::words(N3);
  }
};

__global__ void __launch_bounds__(kThreads) phase3_kernel(Phase3Args a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long C = a.C, P2 = a.P2, Wr = a.Wr, M = 2 * Wr, N3 = C + M;
  const int W = a.W;
  const long long T = a.T;
  const P3Scratch s(a.scratch, C, P2, M);
  const int32_t* hv = a.hmat + (W + 1) * C;
  const int32_t n = *a.n, version = *a.version, oldest = *a.oldest_eff;
  const TupleScan<1> rank{P2}, valid_runs{N3}, keep2{N3};
  const TupleScan<5> runs{N3};

  // Stage 1: clear; the statuses.
  g.each(P2, [&](long long i) { s.is_w[i] = 0; });
  g.each(M, [&](long long i) { s.packed[i] = 0; });
  g.each(N3, [&](long long i) {
    s.merged[i] = 0;
    s.fv[i] = (int32_t)N3;
  });
  g.each(T, [&](long long t) {
    a.st_aux[t] = (int8_t)(a.too_old[t] ? kStatusTooOld
                                        : (a.conflict[t] > 0 ? kStatusConflict
                                                             : 0));
  });
  g.sync();
  // Stage 2: mark the write endpoints' sorted positions.
  g.each(M, [&](long long e) {
    const long long p = sct(e < Wr ? a.s_begin[e] : a.s_end[e - Wr], P2);
    if (p >= 0) s.is_w[p] = 1;
  });
  g.sync();
  // Stages 3-5: their ranks among the write endpoints (in place).
  auto isw = [&](long long i, int32_t* v) { v[0] = ld(s.is_w + i); };
  rank.tiles_stage(s.t_rank, smem, isw);
  g.sync();
  rank.sums_stage(s.t_rank, smem);
  g.sync();
  rank.apply_stage(s.t_rank, smem, isw,
                   [&](long long i, const int32_t*, const int32_t* ex) {
                     s.is_w[i] = ex[0];
                   });
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
  // Stage 7: per compacted endpoint its rank, merged position and merged
  // bits: committed begin, committed end, same key as its merged
  // predecessor, source column C + position.
  g.each(M, [&](long long p) {
    const int32_t pe = ld(s.packed + p);
    const int32_t sidx = pe >> 2;
    const long long q = gat(sidx, P2);
    const int32_t ub_c = a.ub[q];
    const bool eq_c = a.eq[q] != 0;
    const int32_t committed = pe & 1, is_begin = (pe >> 1) & 1;
    bool same_prev = eq_c && ub_c > 0;
    if (p > 0) {
      const int32_t pp = ld(s.packed + p - 1);
      const long long qp = gat(pp >> 2, P2);
      if (a.ub[qp] == ub_c)  // the previous endpoint is its predecessor
        same_prev = key_eq(a.smat, P2, q, a.smat, P2, qp, W);
    }
    s.ubc[p] = ub_c;
    s.posb[p] = add32((int32_t)p, ub_c);
    s.vb[p] = add32(add32((committed & is_begin) << 1,
                          (committed & (1 - is_begin)) << 2),
                    add32((int32_t)same_prev << 3,
                          (int32_t)((uint32_t)add32((int32_t)C, sidx) << 4)));
  });
  g.sync();
  // Stage 8: the merged space, history first among equal ranks: history
  // entry j lands after the endpoints ranked at most j.
  g.each(C, [&](long long j) {
    long long lo = 0, hi = M;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (ld(s.ubc + mid) <= j) lo = mid + 1;
      else hi = mid;
    }
    const long long d = sct(j + lo, N3);
    if (d >= 0)
      s.merged[d] = add32(j < n, (int32_t)((uint32_t)j << 4));
  });
  g.each(M, [&](long long p) {
    const long long d = sct(ld(s.posb + p), N3);
    if (d >= 0) s.merged[d] = ld(s.vb + p);
  });
  g.sync();
  // Stages 9-11: per merged slot, its history, committed-begin,
  // committed-end, valid and run-start counts. A run of equal keys gets
  // its value at its last slot (covered by a committed write: the batch
  // version, else the history value there; stale clamp and rebase) and
  // its first valid slot by atomicMin.
  auto bits = [&](long long i, int32_t* v) {
    const int32_t x = ld(s.merged + i);
    v[0] = x & 1;
    v[1] = (x >> 1) & 1;
    v[2] = (x >> 2) & 1;
    v[3] = v[0] | v[1] | v[2];
    v[4] = !((x >> 3) & 1);
  };
  runs.tiles_stage(s.t_runs, smem, bits);
  g.sync();
  runs.sums_stage(s.t_runs, smem);
  g.sync();
  runs.apply_stage(
      s.t_runs, smem, bits,
      [&](long long i, const int32_t* v, const int32_t* ex) {
        const int32_t rid = add32(ex[4], v[4]) - 1;
        if (rid < 0) return;  // before the first run start: never kept
        if (v[3]) atomicMin(s.fv + rid, (int32_t)i);
        if (i + 1 < N3 && ((ld(s.merged + i + 1) >> 3) & 1)) return;
        const int32_t h = add32(ex[0], v[0]), wb = add32(ex[1], v[1]),
                      we = add32(ex[2], v[2]);
        const long long k = (long long)h - 1;
        int32_t val = wb > we ? version : hv[k < 0 ? 0 : (k > C - 1 ? C - 1 : k)];
        s.valr[rid] = val <= oldest ? 0 : sub32(val, oldest);
      });
  g.sync();
  // Stages 12-14: compaction 1, the runs with a valid slot to the front.
  auto has_valid = [&](long long r, int32_t* v) { v[0] = ld(s.fv + r) < N3; };
  valid_runs.tiles_stage(s.t_valid, smem, has_valid);
  g.sync();
  valid_runs.sums_stage(s.t_valid, smem);
  g.sync();
  valid_runs.apply_stage(
      s.t_valid, smem, has_valid,
      [&](long long r, const int32_t* v, const int32_t* ex) {
        if (!v[0]) return;
        // tpu.py scatters with max into zeros: a negative value lands as 0
        s.csrc[ex[0]] = max(ld(s.merged + ld(s.fv + r)) >> 4, 0);
        s.cval[ex[0]] = max(ld(s.valr + r), 0);
      });
  g.sync();
  // Stages 15-17: coalesce equal neighbouring values; compaction 2 into
  // the C columns (past them the entries drop).
  const int32_t m1 = valid_runs.total(s.t_valid, 0);
  auto kept = [&](long long d, int32_t* v) {
    v[0] = d < m1 && (d == 0 || ld(s.cval + d) != ld(s.cval + d - 1));
  };
  keep2.tiles_stage(s.t_keep, smem, kept);
  g.sync();
  keep2.sums_stage(s.t_keep, smem);
  g.sync();
  keep2.apply_stage(s.t_keep, smem, kept,
                    [&](long long d, const int32_t* v, const int32_t* ex) {
                      if (!v[0] || ex[0] >= C) return;
                      s.src2[ex[0]] = ld(s.csrc + d);
                      s.hvn[ex[0]] = ld(s.cval + d);
                    });
  g.sync();
  // Stage 18: the keys from [history | endpoints], pads past new_n, the
  // verdict bytes' tail.
  const int32_t nn = keep2.total(s.t_keep, 0);
  g.each((W + 2) * C, [&](long long x) {
    const int r = (int)(x / C);
    const long long e = x - r * C;
    int32_t v;
    if (e >= nn) {
      v = r <= W ? kInf : 0;
    } else if (r > W) {
      v = ld(s.hvn + e);
    } else {
      long long src = ld(s.src2 + e);
      src = src < 0 ? 0 : (src > C + P2 - 1 ? C + P2 - 1 : src);
      v = src < C ? a.hmat[r * C + src] : a.smat[r * P2 + src - C];
    }
    a.hmat_out[x] = v;
  });
  if (g.leader()) {
    *a.new_n = nn;
    for (int b = 0; b < 4; ++b)
      a.st_aux[T + b] = (int8_t)(uint8_t)((nn >> (8 * b)) & 0xFF);
    a.st_aux[T + 4] = (int8_t)(nn > C);
    a.st_aux[T + 5] = (int8_t)min(*a.p2_iters, 127);
  }
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
  int W, NB_out, B, T;
  long long C;
};

__global__ void __launch_bounds__(kThreads) redist_kernel(RedistArgs a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long C = a.C, NB = a.NB_out, B = a.B, F = B / 2,
                  C_out = NB * B;
  const int W = a.W;
  const int32_t nn = *a.new_n;
  const long long live_end = nn < C ? nn : C;  // dense columns that move
  // Stage 1: every output column from its dense source (block k = c / B,
  // slot j = c % B < F: dense column k F + j), the counts, the fences,
  // the leaves (a warp's maximum over a block), the overflow byte.
  g.each((W + 2) * C_out, [&](long long x) {
    const int r = (int)(x / C_out);
    const long long c = x - r * C_out, j = c % B, src = c / B * F + j;
    a.out[x] = j < F && src < live_end ? a.hmat_d[r * C + src]
                                       : (r <= W ? kInf : 0);
  });
  g.each(NB, [&](long long k) {
    const long long left = (long long)nn - k * F;
    a.counts[k] = (int32_t)(left < 0 ? 0 : (left > F ? F : left));
    const bool live = k * F < nn;
    const long long src = k * F < C - 1 ? k * F : C - 1;
    for (int r = 0; r <= W; ++r)
      a.fences[r * NB + k] = live ? a.hmat_d[r * C + src] : kInf;
  });
  {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * kWarps;
    for (long long k = g.first >> 5; k < NB; k += warps) {
      int32_t m = F < B ? 0 : INT32_MIN;  // a block's pad slots hold 0
      for (long long j = lane; j < F; j += 32) {
        const long long src = k * F + j;
        if (src < live_end) m = max(m, a.hmat_d[(W + 1) * C + src]);
      }
      m = warp_max(m);
      if (lane == 0) a.btree[NB + k] = m;
    }
  }
  if (g.leader()) {
    a.btree[0] = 0;
    const int8_t over = nn > (long long)NB * F;
    if (over > a.st_aux[a.T + 4]) a.st_aux[a.T + 4] = over;
  }
  g.sync();
  // The tree bottom-up: each thread block folds up to 256 nodes of the
  // current bottom level (bt[cur, 2 cur)) in shared memory, writing every
  // level of its subtree; then the subtrees' roots are the next bottom.
  for (long long cur = NB; cur > 1;) {
    const long long gsz = cur < kThreads ? cur : kThreads;
    for (long long b = blockIdx.x; b < cur / gsz; b += gridDim.x) {
      int32_t v = threadIdx.x < gsz ? ld(a.btree + cur + b * gsz + threadIdx.x)
                                    : 0;
      long long lvl = cur;
      for (long long w = gsz / 2; w >= 1; w /= 2) {
        smem[threadIdx.x] = v;
        __syncthreads();
        lvl /= 2;
        if (threadIdx.x < w) {
          v = max(smem[2 * threadIdx.x], smem[2 * threadIdx.x + 1]);
          a.btree[lvl + b * w + threadIdx.x] = v;
        }
        __syncthreads();
      }
    }
    cur /= gsz;
    g.sync();
  }
}

}  // namespace

extern "C" long long fdb_compact_densify_scratch_ints(int NB, int B) {
  const long long C = (long long)NB * B;
  return NB + C + TupleScan<1>::words(NB) + TupleScan<1>::words(C);
}

// Densify + dedup: the block state (hmat (W + 2, NB B), counts (NB,)) as
// one sorted dense matrix of its live entries, the last of each equal-key
// run kept, pads past m2.
extern "C" int fdb_compact_densify(const void* hmat, const void* counts,
                                   void* dense, void* m2, void* scratch,
                                   int W, int NB, int B, void* stream) {
  if (W < 1 || NB < 1 || B < 1) return (int)cudaErrorInvalidValue;
  DensifyArgs a;
  a.hmat = (const int32_t*)hmat;
  a.counts = (const int32_t*)counts;
  a.dense = (int32_t*)dense;
  a.m2 = (int32_t*)m2;
  a.scratch = (int32_t*)scratch;
  a.W = W;
  a.NB = NB;
  a.B = B;
  a.cnt.n = NB;
  a.keep.n = (long long)NB * B;
  return launch(densify_kernel, a.keep.n, kWarps * sizeof(int32_t), &a,
                stream);
}

extern "C" long long fdb_compact_ranks_scratch_ints(long long C, int P2) {
  Levels lv;
  lv.init(C);
  return P2 + lv.words();
}

// The dense resolve's ranks and phase 1. ptrs, in order: hmat, smat,
// q_begin, q_end, rsnap, rtxn, too_old, ub, eq, base_conf, scratch.
extern "C" int fdb_compact_ranks(void* const* ptrs, int W, long long C,
                                 int P2, int R, int T, void* stream) {
  if (W < 1 || C < 2 || P2 < 1 || R < 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  RanksArgs a;
  a.hmat = (const int32_t*)ptrs[0];
  a.smat = (const int32_t*)ptrs[1];
  a.q_begin = (const int32_t*)ptrs[2];
  a.q_end = (const int32_t*)ptrs[3];
  a.rsnap = (const int32_t*)ptrs[4];
  a.rtxn = (const int32_t*)ptrs[5];
  a.too_old = (const uint8_t*)ptrs[6];
  a.ub = (int32_t*)ptrs[7];
  a.eq = (uint8_t*)ptrs[8];
  a.base_conf = (int32_t*)ptrs[9];
  a.scratch = (int32_t*)ptrs[10];
  a.lv.init(C);
  a.W = W;
  a.C = C;
  a.P2 = P2;
  a.R = R;
  a.T = T;
  long long work = P2 > R ? P2 : R;
  if (a.lv.n && a.lv.size[1] > work) work = a.lv.size[1];
  return launch(ranks_kernel, work, 0, &a, stream);
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
  a.W = W;
  a.C = C;
  a.P2 = P2;
  a.Wr = Wr;
  a.T = T;
  return launch(phase3_kernel, C + 2LL * Wr, 5 * kWarps * sizeof(int32_t),
                &a, stream);
}

// Redistribute phase 3's dense state into NB_out blocks at fill B / 2 and
// rebuild the directory. ptrs, in order: hmat_d, new_n, st_aux, out,
// counts, btree, fences.
extern "C" int fdb_compact_redistribute(void* const* ptrs, int W, long long C,
                                        int NB_out, int B, int T,
                                        void* stream) {
  if (W < 1 || C < 1 || NB_out < 1 || (NB_out & (NB_out - 1)) || B < 2 ||
      T < 1)
    return (int)cudaErrorInvalidValue;
  RedistArgs a;
  a.hmat_d = (const int32_t*)ptrs[0];
  a.new_n = (const int32_t*)ptrs[1];
  a.st_aux = (int8_t*)ptrs[2];
  a.out = (int32_t*)ptrs[3];
  a.counts = (int32_t*)ptrs[4];
  a.btree = (int32_t*)ptrs[5];
  a.fences = (int32_t*)ptrs[6];
  a.W = W;
  a.C = C;
  a.NB_out = NB_out;
  a.B = B;
  a.T = T;
  return launch(redist_kernel, (long long)NB_out * B, kThreads * sizeof(int32_t),
                &a, stream);
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
