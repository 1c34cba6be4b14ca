// The rank-fed resolve's phases 1 and 3, for Hopper (sm_90a).
//
// Replaces, in the JAX package's
// foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl (XLA-jitted;
// no pallas_call), what runs around phase 2 (csrc/phase2.cu):
//   phase1  the read-vs-history check (:210-215): per read the range
//           maximum of the version vector hv over [rank_b - 1, rank_e) by
//           `_table_range_query`'s rules (:150-161), conflict where it
//           passes the read's snapshot, scattered to its txn by max, and
//           a max with too_old; with phase 2's two derived operands: the
//           case-B stab leaf (qb2 - 1 clipped into [0, M), -1 where qb2
//           is 0, :220) and w_valid as bool;
//   phase3  the superset merge (:255-291) and the statuses (:293-296):
//           lbB by a scatter-count of min(ub_c, C) and a prefix sum over
//           C, the merged positions posA = j + lbB[j] and posB = p +
//           ub_c[p], the coverage depth as a prefix of the committed
//           endpoints' +1 / -1 in merged order, base and live slots, the
//           batch's version where depth > 0, the rebase and horizon
//           clamp, and hv_new = merged[:C].
// The plain torch versions are foundationdb_tpu_torch/resolver/
// rankfed_ops.py `phase1_ref` and `phase3_ref`; every output equals them
// bit for bit on every input the host builds. Phase 3 uses one property
// of those inputs: ub_c never falls in sorted order and lies in [0, C]
// (pads carry n), so posA and posB are each strictly increasing and
// together a permutation of [0, C + M): every slot of hv_new is written
// once, from its one source. hv is only read; hv_new is another buffer.
//
// Bound on the card: bytes. Phase 1 must read hv once (4 C), the reads'
// four words and too_old, and write base_conf; phase 3 read hv and the
// endpoints once and write hv_new and the statuses: at C = 2^23 each
// moves about 34 MB, some 0.01 ms at 3.35 TB/s. The design:
// - Neither builds tpu.py's (log C + 1) x C table (24 rows of 32 MB at C
//   = 2^23): phase 1 builds maxima of 32, 1,024, ... slots (C / 31 words)
//   and answers each of the query's two power-of-two windows from them
//   (grid.cuh Levels; compact.cu's ranks answers by warp from
//   LiveLevels).
// - Phase 3 never materializes the C + M merged vector: the scatter-count
//   and the depth's +1 / -1 go into two C-long words, one two-way grid
//   scan (grid.cuh TupleScan) turns them into lbB and the depth in place,
//   and a last stage writes each history slot and each endpoint to its
//   merged position below C.
// Every kernel is one cooperative grid; what bounds them is, as in
// compact.cu, their grid barriers and phase 3's scan over C.
//
// Interface: plain C entry points (loaded with ctypes), each launching
// one cooperative grid on the caller's stream, allocating nothing (each
// takes a scratch of fdb_rankfed_*_scratch_ints int32) and returning the
// cudaError_t of the launch.

#include "grid.cuh"

namespace {

using namespace fdb;

constexpr int kCommitted = 0, kConflict = 1, kTooOld = 2;  // types.py

struct Phase1Args {
  const int32_t* hv;       // (C,) version offsets
  const int32_t* rank_b;   // (R,)
  const int32_t* rank_e;   // (R,)
  const int32_t* rsnap;    // (R,)
  const int32_t* rtxn;     // (R,)
  const int32_t* too_old;  // (T,) nonzero: too old
  const int32_t* qb2;      // (R,)
  const int32_t* w_valid;  // (Wr,) nonzero: a real write row
  int32_t* base_conf;      // (T,) out
  int32_t* leaf;           // (R,) out
  uint8_t* valid;          // (Wr,) out, bool
  int32_t* scratch;        // the levels
  Levels lv;
  int R, T, Wr, M, max_row;
};

__global__ void __launch_bounds__(kThreads)
    rankfed_phase1_kernel(Phase1Args a) {
  const Grid g;
  // Stage 1: base_conf = too_old, phase 2's leaf and validity, the first
  // maximum level (one barrier a level).
  g.each(a.T, [&](long long t) { a.base_conf[t] = a.too_old[t] != 0; });
  g.each(a.R, [&](long long r) {
    const int32_t q = a.qb2[r];
    const int32_t l = add32(q, -1);
    a.leaf[r] = q > 0 ? (l < 0 ? 0 : (l > a.M - 1 ? a.M - 1 : l)) : -1;
  });
  g.each(a.Wr, [&](long long w) { a.valid[w] = a.w_valid[w] != 0; });
  a.lv.build(g, a.hv, a.scratch);
  // Last stage: each read's history maximum over [rank_b - 1, rank_e),
  // a conflict past its snapshot (a scatter's index rule: out of range
  // drops).
  g.each(a.R, [&](long long r) {
    const int32_t hist = a.lv.window_max(a.hv, a.scratch,
                                         add32(a.rank_b[r], -1), a.rank_e[r],
                                         a.max_row);
    const long long t = sct(a.rtxn[r], a.T);
    if (hist > a.rsnap[r] && t >= 0) a.base_conf[t] = 1;
  });
}

struct Phase3Args {
  const int32_t* hv;        // (C,)
  const int32_t* conflict;  // (T,) phase 2's vector
  const int32_t* wtxn;      // (Wr,)
  const int32_t* w_valid;   // (Wr,) nonzero: a real write row
  const int32_t* ub_c;      // (M,) #mirror entries <= each sorted endpoint
  const int32_t* wsrc;      // (M,) write row << 1 | is_begin
  const int32_t* too_old;   // (T,) nonzero: too old
  const int32_t* scalars;   // (3,) version, oldest_eff, n
  int32_t* hv_new;          // (C,) out
  int32_t* statuses;        // (T,) out
  int32_t* scratch;         // cnt C, depth C, the scan's tile sums
  TupleScan<2> scan;
  int Wr, M, T;
  long long C;
};

// Endpoint p's write row, whether that row is valid, and its +1 / -1 / 0
// in the coverage depth (committed begins +1, committed ends -1).
struct Endpoint {
  bool valid;
  int32_t delta;
  __device__ Endpoint(const Phase3Args& a, long long p) {
    const int32_t w = a.wsrc[p];
    const long long row = gat(w >> 1, a.Wr);
    valid = a.w_valid[row] != 0;
    const bool cw = valid && a.conflict[gat(a.wtxn[row], a.T)] == 0;
    delta = cw ? ((w & 1) ? 1 : -1) : 0;
  }
};

__global__ void __launch_bounds__(kThreads)
    rankfed_phase3_kernel(Phase3Args a) {
  extern __shared__ int32_t smem[];
  const Grid g;
  const long long C = a.C, M = a.M, N3 = C + M;
  int32_t* cnt = a.scratch;        // the scatter-count, then lbB
  int32_t* depth = cnt + C;        // the endpoints' +1 / -1, then depth
  int32_t* tsum = depth + C;
  const int32_t version = a.scalars[0], oldest = a.scalars[1],
                n = a.scalars[2];
  auto rebase = [&](int32_t v) {
    return v <= oldest ? 0 : (int32_t)((uint32_t)v - (uint32_t)oldest);
  };
  // Stage 1: clear; the statuses.
  g.each(C, [&](long long i) {
    cnt[i] = 0;
    depth[i] = 0;
  });
  g.each(a.T, [&](long long t) {
    a.statuses[t] = a.too_old[t] != 0
                        ? kTooOld
                        : (a.conflict[t] > 0 ? kConflict : kCommitted);
  });
  g.sync();
  // Stage 2: the scatter-count of min(ub_c, C) (slot C falls outside the
  // prefix lbB reads), each endpoint's +1 / -1 at its merged position.
  g.each(M, [&](long long p) {
    const int32_t u = a.ub_c[p];
    const long long c = sct(u < C ? u : C, C + 1);
    if (c >= 0 && c < C) atomicAdd(cnt + c, 1);
    const long long pos = sct(add32((int32_t)p, u), N3);
    if (pos >= 0 && pos < C) depth[pos] = Endpoint(a, p).delta;
  });
  g.sync();
  // Stages 3-5: both inclusive prefix sums, in place: lbB and the depth.
  auto val = [&](long long i, int32_t* v) {
    v[0] = ld(cnt + i);
    v[1] = ld(depth + i);
  };
  a.scan.tiles_stage(tsum, smem, val);
  g.sync();
  a.scan.sums_stage(tsum, smem);
  g.sync();
  a.scan.apply_stage(tsum, smem, val,
                     [&](long long i, const int32_t* v, const int32_t* ex) {
                       cnt[i] = add32(ex[0], v[0]);
                       depth[i] = add32(ex[1], v[1]);
                     });
  g.sync();
  // Stage 6: each history slot j and each endpoint p at its merged
  // position, where that is below C: the batch's version where it is live
  // and covered, else its base; rebased and clamped at the horizon.
  g.each(C, [&](long long j) {
    const long long pos = sct(add32((int32_t)j, ld(cnt + j)), N3);
    if (pos < 0 || pos >= C) return;
    const bool live = j < n;
    a.hv_new[pos] =
        rebase(live && ld(depth + pos) > 0 ? version : a.hv[j]);
  });
  g.each(M, [&](long long p) {
    const int32_t u = a.ub_c[p];
    const long long pos = sct(add32((int32_t)p, u), N3);
    if (pos < 0 || pos >= C) return;
    const Endpoint e(a, p);
    const int32_t k = add32(u, -1);  // hv at clip(ub_c - 1, 0, C - 1)
    const int32_t base = e.valid ? a.hv[k < 0 ? 0 : (k > C - 1 ? C - 1 : k)]
                                 : 0;
    a.hv_new[pos] = rebase(e.valid && ld(depth + pos) > 0 ? version : base);
  });
}

// Rows of tpu.py's table over C slots (`_build_table`: one for the row,
// one a doubling below C), less one: the query's cap on its window.
int table_max_row(long long C) {
  int rows = 1;
  for (long long s = 1; s < C; s *= 2) ++rows;
  return rows - 1;
}

}  // namespace

extern "C" long long fdb_rankfed_phase1_scratch_ints(long long C) {
  Levels lv;
  lv.init(C);
  return lv.words() > 0 ? lv.words() : 1;
}

// Phase 1. ptrs, in order: hv, rank_b, rank_e, rsnap, rtxn, too_old, qb2,
// w_valid, base_conf, leaf, valid, scratch.
extern "C" int fdb_rankfed_phase1(void* const* ptrs, long long C, int R,
                                  int T, int Wr, int M, void* stream) {
  if (C < 1 || R < 0 || T < 1 || Wr < 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  Phase1Args a;
  a.hv = (const int32_t*)ptrs[0];
  a.rank_b = (const int32_t*)ptrs[1];
  a.rank_e = (const int32_t*)ptrs[2];
  a.rsnap = (const int32_t*)ptrs[3];
  a.rtxn = (const int32_t*)ptrs[4];
  a.too_old = (const int32_t*)ptrs[5];
  a.qb2 = (const int32_t*)ptrs[6];
  a.w_valid = (const int32_t*)ptrs[7];
  a.base_conf = (int32_t*)ptrs[8];
  a.leaf = (int32_t*)ptrs[9];
  a.valid = (uint8_t*)ptrs[10];
  a.scratch = (int32_t*)ptrs[11];
  a.lv.init(C);
  a.R = R;
  a.T = T;
  a.Wr = Wr;
  a.M = M;
  a.max_row = table_max_row(C);
  long long work = R > T ? R : T;
  if (Wr > work) work = Wr;
  if (a.lv.n && a.lv.size[1] > work) work = a.lv.size[1];
  return launch(rankfed_phase1_kernel, work, 0, &a, stream);
}

extern "C" long long fdb_rankfed_phase3_scratch_ints(long long C) {
  return 2 * C + TupleScan<2>::words(C);
}

// Phase 3. ptrs, in order: hv, conflict, wtxn, w_valid, ub_c, wsrc,
// too_old, scalars, hv_new, statuses, scratch.
extern "C" int fdb_rankfed_phase3(void* const* ptrs, long long C, int Wr,
                                  int M, int T, void* stream) {
  if (C < 1 || Wr < 0 || M < 0 || T < 1) return (int)cudaErrorInvalidValue;
  Phase3Args a;
  a.hv = (const int32_t*)ptrs[0];
  a.conflict = (const int32_t*)ptrs[1];
  a.wtxn = (const int32_t*)ptrs[2];
  a.w_valid = (const int32_t*)ptrs[3];
  a.ub_c = (const int32_t*)ptrs[4];
  a.wsrc = (const int32_t*)ptrs[5];
  a.too_old = (const int32_t*)ptrs[6];
  a.scalars = (const int32_t*)ptrs[7];
  a.hv_new = (int32_t*)ptrs[8];
  a.statuses = (int32_t*)ptrs[9];
  a.scratch = (int32_t*)ptrs[10];
  a.scan.n = C;
  a.Wr = Wr;
  a.M = M;
  a.T = T;
  a.C = C;
  long long work = C > M ? C : M;
  if (T > work) work = T;
  return launch(rankfed_phase3_kernel, work, 2 * kWarps * sizeof(int32_t),
                &a, stream);
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
