// Phase 2 of the resolver, the intra-batch fixed point, for Hopper (sm_90a).
//
// Replaces the JAX package's
// foundationdb_tpu/resolver/tpu.py::_phase2_fixed_point (:358-437: the
// geometry, the pointer-jumping seed, then the verification
// `lax.while_loop`, run by the block and dense kernels) and the
// verification loop of
// foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl (:223-253, no
// seed). Both are XLA-jitted; neither reaches a pallas_call. The plain
// torch version is foundationdb_tpu_torch/resolver/phase2.py
// `phase2_rounds_ref` (with `geometry_ref` for the geometry).
//
// Why it exists: the resolvers' dispatch contract. The JAX package's
// submit enqueues its whole resolve and never waits for the device; its
// loop stops on a device boolean. This kernel runs the seed and every
// round on the device in one launch, so a submit makes no host read and
// launches no seed op.
//
// What it computes. The min-writer of a read r under write values wval:
//   case A = min wval[perm[j]] over j in [lo[r], hi[r])  (writes that
//            begin strictly inside read r's span, in begin-rank order)
//   case B = min wval[w] over writes w whose segment [seg_lo, seg_hi)
//            covers leaf[r] (none where leaf[r] < 0)
//   mw(r)  = min(case A, case B)
// The seed (when asked, tpu.py:385-417): pot = mw under wval = w_valid ?
// wtxn : INF, kept where pot < rtxn; parent[t] = min pot over t's reads;
// per txn the link table (a, b) = (f(0), f(1)) of its committed-ness as a
// function of its parent's (base conflict: const 0; a parent: NOT; none:
// const 1), composed along the parent chain to its end; seed[t] =
// max(base[t], 1 - a[t]). JAX composes by n_jump = bit_length(T - 1)
// synchronous doublings, enough for any chain (parent < t), so its tables
// are the whole chains' compositions; here each txn's thread composes its
// chain asynchronously, reading whatever its ancestors have composed so
// far (a word is a valid prefix composition at every moment), to the same
// tables with one barrier. One round (Jacobi: it reads only c_j):
//   wval[w] = w_valid[w] && c_j[wtxn[w]] == 0 ? wtxn[w] : INF
//   ev[t]   = 1 if some read r of t = rtxn[r] has mw(r) < t
//   c_{j+1} = max(base, ev); repeat while c changes and it < cap.
// The counter starts at it0 (the seed's n_jump, or 0) and is returned.
//
// The geometry (tpu.py:358-365), where the caller passes q_end in place
// of perm, lo and hi (the block and dense kernels; the rank-fed set's
// host computes all three): the operands are then s_begin = seg_lo,
// q_begin = leaf and P2 = L, and the prologue computes
//   wb_excl[p] = #write begins at slots < p   (is_wb = s_begin's slots)
//   lo[r] = wb_excl[q_begin[r]], hi[r] = wb_excl[q_end[r]]
//   perm[wb_excl[s_begin[w]]] = w            (0 where nothing lands)
// with tpu.py's index rules (a scatter drops an index out of range, a
// gather clamps it). is_wb is a bit a slot (P2 / 32 words, set by
// atomicOr); one thread block scans the words' bit counts, and a rank is
// that prefix plus a popcount in the word: three stages and barriers
// before the seed, no P2-long array. perm is deterministic because the
// host gives every write row, pads included, its own begin slot.
//
// Bound on the card: bytes, in theory. Each operand is read once and the
// vector written once (12 T + 16 R + 17 Wr + 4 bytes; 8 T with the seed,
// which does not read conflict0), well under a microsecond at the
// resolver's shapes. What bounds the kernel is
// latency: every stage is a chain of dependent accesses to state other
// threads wrote (an L2 or shared-memory round trip each), and a barrier
// ends it; a stage costs 1.5-6 us on an H100 whatever its size below
// ~10^5 items. So the design cuts stages and round trips:
//
// - One launch for the geometry on: the seed (one min-writer pass, then
//   the chains composed asynchronously, one barrier) and every round.
// - Inserts the next stage alone reads are reductions nobody waits for
//   (red.global / red.shared); the level word and the changed
//   flag take one reduction a block, after a block-wide maximum or OR.
// - Two barriers a round, no reset stage. Tree nodes hold keys
//   (field << vbits | value), field = fmax - 1 - tag with one tag per
//   build, so one unsigned atomicMin keeps the least value of the newest
//   build and any older key (or the fill, field fmax) reads as INF. The
//   evidence holds the round that set it, the changed flag the last
//   round that changed. c_{j+1} is computed where it is used from base
//   and the evidence of round j, and kept per txn by its owning thread
//   for the changed test. When the tags of one fill run out (over 32,767
//   builds at T 65,536) the trees are filled again behind one barrier.
// - A stab reads only the levels at or below the highest canonical node
//   of its build (one atomicMax per build): point writes cost a read 2-3
//   loads, not log2(n_leaves). A case-A range of up to kScan ranks is
//   read directly, and the case-A tree (a min segment tree over begin
//   rank, leaves Wr + j, built by walks up that stop at the first node
//   at or below their key) is built only when some read's range is
//   longer: config-5 traffic never builds it. A walk up takes one atomic
//   round trip a level.
// - Two tiers; phase2.choose_tier picks one from the shapes before the
//   launch, the one the card measured faster (chip_smoke.py's
//   phase2-cluster-* entries time both on config-1 batches). BLOCK: one
//   thread block of 1,024 threads holding the state and copies of the
//   read-only operands in its shared memory (the write's validity folded
//   into its txn), barriers __syncthreads(): no stage leaves the SM, so
//   it bounds on the block's own latency and issue rate and wins on
//   small batches. GRID: a cooperative grid sized to the work (one thread
//   a read, write or txn, at most every resident block), state in global
//   memory read through L2 (ld.global.cg: other blocks write it),
//   barriers grid.sync(); it bounds on those round trips and barriers,
//   and takes everything larger.

// Interface: plain C entry points (loaded with ctypes).
// fdb_phase2_limits() queries a device once (SMs, shared memory, the grid
// kernel's occupancy) and sets the block kernel's shared memory limit on
// it; fdb_phase2_rounds() launches the tier it is told on the caller's
// stream, allocates nothing (the grid tier takes a scratch of
// fdb_phase2_scratch_ints() int32) and returns the cudaError_t of the
// launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGridThreads = 256;
constexpr int kBlockThreads = 1024;
constexpr int kMaxT = 1 << 24;           // keeps vbits, builds and ptr in range
constexpr int kScan = 16;                // case-A ranges read directly
constexpr int kMaxLeaves = 1 << 25;      // L and Wr below it (exclusive)
constexpr int kLevels = 26;              // tree levels: 2 L and 2 Wr < 2^26
constexpr int32_t kInf = INT32_MAX;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // fill: a node of no build, no word
constexpr uint32_t kPtrMask = (1u << 30) - 1;
// Words beside the state: the changed flag, the level word, the block's
// own level word and its long-range bit (block tier).
constexpr int kFlag = 0, kLevel = 1, kBlockLevel = 2, kLong = 3, kMisc = 4;

// State arrays, in this order in a tier's memory: conf, ev and the seed's
// link words T each, the case-A tree 2 Wr, the case-B tree 2 L.
enum { kConf, kEv, kWord, kTreeA, kTreeB, kArrays };

struct Args {
  const int32_t* base;       // (T,) phase-1 conflicts (history, tooOld)
  const int32_t* conflict0;  // (T,) the loop's initial vector (no seed)
  const int32_t* perm;       // (Wr,) write row at each begin rank (case A)
  const int32_t* lo;         // (R,) case A range [lo, hi) in rank order
  const int32_t* hi;         // (R,)  (perm, lo, hi: null with q_end)
  const int32_t* seg_lo;     // (Wr,) write segment [seg_lo, seg_hi) (case B)
  const int32_t* seg_hi;     // (Wr,)
  const int32_t* leaf;       // (R,) leaf the read stabs, < 0: none
  const int32_t* rtxn;       // (R,) owning txn of each read
  const int32_t* wtxn;       // (Wr,) owning txn of each write
  const uint8_t* w_valid;    // (Wr,) bool
  const int32_t* q_end;      // (R,) the geometry's read ends, or null
  int32_t* out;              // (T,) the fixed point
  int32_t* it_out;           // (1,) the round counter at exit
  int32_t* scratch;          // grid tier: state and a long-range bit a block
  int T, R, Wr, L, it0, cap, seed;
  bool geo;                  // q_end given: the prologue derives perm, lo, hi
};

// The read-only operands, where a tier reads them: global memory through
// the read-only path (grid), or copies in shared memory (block), the
// write's validity folded into its txn (-1: not valid).
struct Operands {
  const int32_t *lo, *hi, *leaf, *rtxn, *perm, *seg_lo, *seg_hi, *wtxn,
      *base;
  const uint8_t* valid;
  bool smem;
  bool derived;  // perm, lo, hi written by this launch (grid: past L1)

  __device__ int32_t get(const int32_t* p, long long i) const {
    return smem ? p[i] : __ldg(p + i);
  }
  // perm, lo and hi, which the geometry may have written in this launch.
  __device__ int32_t geo(const int32_t* p, long long i) const {
    return smem ? p[i] : derived ? __ldcg(p + i) : __ldg(p + i);
  }
  // The txn of write w, or -1 where it is not valid.
  __device__ int32_t txn(long long w) const {
    if (smem) return wtxn[w];
    return valid[w] ? __ldg(wtxn + w) : -1;
  }
};

// int32 slots of the state, and of the block tier's operand copies.
__host__ __device__ inline long long state_ints(int T, int Wr, int L) {
  return 3LL * T + 2LL * Wr + 2LL * L + kMisc;
}
__host__ __device__ inline long long operand_ints(int T, int R, int Wr) {
  return 4LL * R + 4LL * Wr + T;
}
// The geometry's bit words of the P2 = L slots (is_wb), and their prefix.
__host__ __device__ inline long long geo_words(int L) {
  return ((long long)L + 31) / 32;
}

__device__ inline long long gat(long long i, long long n) {  // tpu.py gather
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
__device__ inline long long sct(long long i, long long n) {  // tpu.py scatter
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

__device__ inline long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// ---------------------------------------------------------------- tiers

// Grid tier: state in global memory (conf is the output itself), read
// through L2 (ld.global.cg) since other blocks write it.
struct GridTier {
  int32_t* arr[kArrays];
  int32_t* misc;
  int32_t* longs;  // a long-range bit per block
  int32_t* mine;   // this block's level word, in its shared memory
  int32_t* ws;     // 32 words of shared memory for a block scan
  int32_t *dperm, *dlo, *dhi, *bits, *pre;  // the geometry's, in scratch
  long long first, stride;
  Operands o;

  __device__ GridTier(const Args& a, int32_t* block_level, int32_t* ws_) {
    o.lo = a.lo; o.hi = a.hi; o.leaf = a.leaf; o.rtxn = a.rtxn;
    o.perm = a.perm; o.seg_lo = a.seg_lo; o.seg_hi = a.seg_hi;
    o.wtxn = a.wtxn; o.base = a.base; o.valid = a.w_valid;
    o.smem = false;
    o.derived = a.geo;
    mine = block_level;
    ws = ws_;
    arr[kConf] = a.out;
    int32_t* s = a.scratch;
    arr[kEv] = s;
    arr[kWord] = s + a.T;
    arr[kTreeA] = s + 2LL * a.T;
    arr[kTreeB] = arr[kTreeA] + 2LL * a.Wr;
    misc = arr[kTreeB] + 2LL * a.L;
    longs = misc + kMisc;
    dperm = longs + gridDim.x;
    dlo = dperm + a.Wr;
    dhi = dlo + a.R;
    bits = dhi + a.R;
    pre = bits + geo_words(a.L);
    if (a.geo) {
      o.perm = dperm;
      o.lo = dlo;
      o.hi = dhi;
    }
    first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    stride = (long long)gridDim.x * blockDim.x;
  }
  __device__ int32_t* at(int k, long long i) const { return arr[k] + i; }
  __device__ static int32_t ld(const int32_t* p) { return __ldcg(p); }
  __device__ static void st(int32_t* p, int32_t v) { __stcg(p, v); }
  __device__ void sync() const { cg::this_grid().sync(); }
  __device__ bool leader() const { return first == 0; }
  // Items every thread shares out; a txn is always on the same thread
  // (it keeps c_j[t] for the changed test).
  template <class F> __device__ void items(long long n, F f) const {
    for (long long i = first; i < n; i += stride) f(i);
  }
  template <class F> __device__ void own(int T, F f) const {
    for (long long t = first; t < T; t += stride) f((int)t);
  }
  template <class F> __device__ void fill(int k, long long n, F f) const {
    for (long long i = first; i < n; i += stride) f(arr[k] + i);
  }
  // Flag and level words to -1, before a barrier.
  __device__ void init_misc() const {
    if (first == 0) {
      st(misc + kFlag, -1);
      st(misc + kLevel, -1);
    }
    if (threadIdx.x == 0) *mine = -1;
  }
  // Any read's case-A range over kScan, anywhere: a bit a block, stored
  // before a barrier, read after it.
  __device__ void long_put(bool seen) const {
    const int any = __syncthreads_or(seen);
    if (threadIdx.x == 0) st(longs + blockIdx.x, any);
  }
  __device__ bool long_get() const {
    bool any = false;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
      any |= ld(longs + b) != 0;
    return __syncthreads_or(any) != 0;
  }
  // Round j changed c somewhere in this block: one reduction a block.
  __device__ void flag_set(bool changed, int32_t j) const {
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicMax(misc + kFlag, j);
  }
  __device__ int32_t flag() const { return ld(misc + kFlag); }
  __device__ int32_t* level() const { return misc + kLevel; }
  __device__ int32_t* block_level() const { return mine; }
  __device__ void out(const Args&) const {}  // conf is out
  __device__ void load_operands(const Args&) const {}
};

// Block tier: one thread block, the state and the operand copies in its
// shared memory.
struct BlockTier {
  int32_t* arr[kArrays];
  int32_t* misc;
  int32_t* copies;  // lo, hi, leaf, rtxn (R each); perm, seg_lo, seg_hi,
                    // wtxn (Wr each); base (T); the geometry's words
  int32_t* ws;      // 32 words for a block scan (the geometry's)
  int32_t *dperm, *dlo, *dhi, *bits, *pre;
  Operands o;

  __device__ BlockTier(const Args& a, int32_t* smem) {
    int32_t* p = smem;
    const long long n[kArrays] = {a.T, a.T, a.T, 2LL * a.Wr, 2LL * a.L};
    for (int k = 0; k < kArrays; ++k) {
      arr[k] = p;
      p += n[k];
    }
    misc = p;
    p += kMisc;
    copies = p;
    o.lo = p; o.hi = p + a.R; o.leaf = p + 2LL * a.R; o.rtxn = p + 3LL * a.R;
    p += 4LL * a.R;
    o.perm = p; o.seg_lo = p + a.Wr; o.seg_hi = p + 2LL * a.Wr;
    o.wtxn = p + 3LL * a.Wr;
    o.base = p + 4LL * a.Wr;
    o.valid = nullptr;
    o.smem = true;
    o.derived = a.geo;
    dlo = copies;
    dhi = copies + a.R;
    dperm = copies + 4LL * a.R;
    bits = copies + operand_ints(a.T, a.R, a.Wr);
    pre = bits + geo_words(a.L);
    ws = pre + geo_words(a.L);
  }
  // The operand copies, before the first barrier (perm, lo and hi where
  // the geometry does not derive them).
  __device__ void load_operands(const Args& a) const {
    int32_t* c = copies;
    for (int i = threadIdx.x; i < a.R; i += blockDim.x) {
      if (!a.geo) {
        c[i] = __ldg(a.lo + i);
        c[a.R + i] = __ldg(a.hi + i);
      }
      c[2 * a.R + i] = __ldg(a.leaf + i);
      c[3 * a.R + i] = __ldg(a.rtxn + i);
    }
    c += 4 * a.R;
    for (int i = threadIdx.x; i < a.Wr; i += blockDim.x) {
      if (!a.geo) c[i] = __ldg(a.perm + i);
      c[a.Wr + i] = __ldg(a.seg_lo + i);
      c[2 * a.Wr + i] = __ldg(a.seg_hi + i);
      c[3 * a.Wr + i] = a.w_valid[i] ? __ldg(a.wtxn + i) : -1;
    }
    c += 4 * a.Wr;
    for (int i = threadIdx.x; i < a.T; i += blockDim.x)
      c[i] = __ldg(a.base + i);
  }
  __device__ int32_t* at(int k, long long i) const { return arr[k] + i; }
  __device__ static int32_t ld(const int32_t* p) {
    return *(const volatile int32_t*)p;
  }
  __device__ static void st(int32_t* p, int32_t v) {
    *(volatile int32_t*)p = v;
  }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool leader() const { return threadIdx.x == 0; }
  template <class F> __device__ void items(long long n, F f) const {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) f(i);
  }
  template <class F> __device__ void own(int T, F f) const {
    for (int t = threadIdx.x; t < T; t += blockDim.x) f(t);
  }
  template <class F> __device__ void fill(int k, long long n, F f) const {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) f(arr[k] + i);
  }
  __device__ void init_misc() const {
    if (threadIdx.x == 0)
      for (int i = 0; i < kMisc; ++i) st(misc + i, -1);
  }
  __device__ void long_put(bool seen) const {
    const int any = __syncthreads_or(seen);
    if (threadIdx.x == 0) st(misc + kLong, any);
  }
  __device__ bool long_get() const { return ld(misc + kLong) != 0; }
  __device__ void flag_set(bool changed, int32_t j) const {
    if (__syncthreads_or(changed) && threadIdx.x == 0) st(misc + kFlag, j);
  }
  __device__ int32_t flag() const { return ld(misc + kFlag); }
  __device__ int32_t* level() const { return misc + kLevel; }
  __device__ int32_t* block_level() const { return misc + kBlockLevel; }
  __device__ void out(const Args& a) const {
    own(a.T, [&](int t) { a.out[t] = ld(at(kConf, t)); });
  }
};

// ------------------------------------------------------------- the loop

template <class S>
struct Phase2 {
  const Args& a;
  const S& s;
  int T, R, Wr, L, vbits;
  uint32_t vinf, fmax;
  int tag = -1, build = -1;
  bool tree_a = false;  // some read's case-A range is over kScan

  __device__ Phase2(const Args& a_, const S& s_) : a(a_), s(s_) {
    T = a.T; R = a.R; Wr = a.Wr; L = a.L;
    vbits = 32 - __clz(T);   // a value field holding 0..T-1 and INF
    vinf = (1u << vbits) - 1;
    fmax = (1u << (32 - vbits)) - 1;
  }

  __device__ uint32_t key(int32_t v) const {
    const uint32_t f = fmax - 1 - (uint32_t)tag;
    return (f << vbits) | (v >= 0 && v < T ? (uint32_t)v : vinf);
  }
  __device__ int32_t value(uint32_t k) const {
    if ((k >> vbits) != fmax - 1 - (uint32_t)tag) return kInf;
    const uint32_t v = k & vinf;
    return v == vinf ? kInf : (int32_t)v;
  }
  // A tree node: the reduction alone, waited for by nobody until the
  // barrier.
  __device__ static void min_red(int32_t* p, uint32_t k) {
    atomicMin((unsigned int*)p, k);
  }

  // The trees to the fill, before a barrier.
  __device__ void fill_trees() const {
    s.fill(kTreeA, 2LL * Wr, [](int32_t* p) { *p = (int32_t)kEmpty; });
    s.fill(kTreeB, 2LL * L, [](int32_t* p) { *p = (int32_t)kEmpty; });
  }

  // The next build's tag; a new fill of the trees when a fill's tags
  // are spent (between stages: after a barrier, before the build).
  __device__ void next_build() {
    ++build;
    if (++tag < (int)fmax) return;
    fill_trees();
    s.sync();
    tag = 0;
  }

  // c_j[t] for any t: j == 0 the start vector (the seed or conflict0),
  // else max(base, the evidence of round j - 1).
  __device__ int32_t conf_at(int t, int j) const {
    const int32_t b = s.o.get(s.o.base, t);
    if (j > 0) return max(b, S::ld(s.at(kEv, t)) == j - 1 ? 1 : 0);
    if (!a.seed) return __ldg(a.conflict0 + t);
    const uint32_t w = (uint32_t)S::ld(s.at(kWord, t));
    return max(b, 1 - (int32_t)((w >> 30) & 1));
  }

  // Key k into the canonical nodes of leaves [l, r) of the case-B tree;
  // returns the height of the highest (-1: none).
  __device__ int insert(long long l, long long r, uint32_t k) const {
    int top = -1;
    l += L;
    r += L;
    for (int h = 0; l < r; ++h, l >>= 1, r >>= 1) {
      if (l & 1) { min_red(s.at(kTreeB, l++), k); top = h; }
      if (r & 1) { min_red(s.at(kTreeB, --r), k); top = h; }
    }
    return top;
  }

  // Stage 1: the trees from the write values wval(t) of each write's txn
  // t (-1: not valid; kInf: the write does not count).
  template <class W> __device__ void build_trees(W wval) const {
    int hmax = -1;
    s.items(Wr, [&](long long w) {
      const long long lo = clampll(s.o.get(s.o.seg_lo, w), 0, L);
      const long long hi = clampll(s.o.get(s.o.seg_hi, w), 0, L);
      if (lo >= hi) return;
      const int32_t v = wval(s.o.txn(w));
      if (v != kInf) hmax = max(hmax, insert(lo, hi, key(v)));
    });
    // The level word: a maximum over the block first (the word of an
    // older build is below any of this one's), one reduction a block.
    if (hmax >= 0) atomicMax(s.block_level(), (build << 6) | hmax);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int32_t lw = *(volatile int32_t*)s.block_level();
      if (lw >> 6 == build) atomicMax(s.level(), lw);
    }
    if (!tree_a) return;
    s.items(Wr, [&](long long j) {
      const int32_t v =
          wval(s.o.txn(min(max(s.o.geo(s.o.perm, j), 0), Wr - 1)));
      const uint32_t k = key(v);
      long long node = Wr + j;
      S::st(s.at(kTreeA, node), (int32_t)k);
      if (v == kInf) return;
      // Up while this key lowers the node: one atomic round trip a level
      // (a node already at or below it has a walker of its own above).
      for (node >>= 1; node >= 1; node >>= 1)
        if (atomicMin((unsigned int*)s.at(kTreeA, node), k) <= k) break;
    });
  }

  // Stage 2: per read, its min-writer mw under wval; hit(t, mw) where
  // mw < t. Without the case-A tree every range is at most kScan ranks,
  // read directly. The read's operands load together, ahead of the state
  // they index; a case-A query's nodes load together, ahead of their
  // minimum (kLevels steps, a predicate each: no load waits on another).
  template <class W, class H> __device__ void query(W wval, H hit) const {
    const int32_t lw = S::ld(s.level());
    const int top = (lw >> 6) == build ? (lw & 63) : -1;
    s.items(R, [&](long long r) {
      long long l = clampll(s.o.geo(s.o.lo, r), 0, Wr);
      long long h = clampll(s.o.geo(s.o.hi, r), 0, Wr);
      const int32_t x = s.o.get(s.o.leaf, r);
      const int32_t t = s.o.get(s.o.rtxn, r);
      if (t < 0 || t >= T) return;  // no txn to hit
      uint32_t m = kEmpty;
      int32_t direct = kInf;
      if (x >= 0 && x < L) {
        const long long node = L + (long long)x;
#pragma unroll 4
        for (int k = 0; k <= top && (node >> k) >= 1; ++k)
          m = min(m, (uint32_t)S::ld(s.at(kTreeB, node >> k)));
      }
      if (!tree_a) {
#pragma unroll 4
        for (; l < h; ++l)
          direct = min(direct, wval(s.o.txn(min(
                                   max(s.o.geo(s.o.perm, l), 0), Wr - 1))));
      } else {
        l += Wr;
        h += Wr;
#pragma unroll
        for (int k = 0; k < kLevels; ++k, l >>= 1, h >>= 1) {
          if (l < h && (l & 1)) m = min(m, (uint32_t)S::ld(s.at(kTreeA, l++)));
          if (l < h && (h & 1)) m = min(m, (uint32_t)S::ld(s.at(kTreeA, --h)));
        }
      }
      const int32_t v = min(value(m), direct);
      if (v < t) hit(t, v);
    });
  }

  // The link word of txn t from its parent (kept in conf until the jumps
  // end): ptr (T: none) | a << 30 | b << 31.
  __device__ uint32_t link(int t) const {
    const int32_t p = S::ld(s.at(kConf, t));
    const bool has = p != kInf, bc = s.o.get(s.o.base, t) > 0;
    return (has ? (uint32_t)p : (uint32_t)T) | (uint32_t)(!bc) << 30 |
           (uint32_t)(!(bc || has)) << 31;
  }

  // The geometry's rank of slot p in [0, L): write begins at slots < p.
  __device__ int32_t rank(long long p) const {
    const uint32_t w = (uint32_t)S::ld(s.bits + (p >> 5));
    return S::ld(s.pre + (p >> 5)) + __popc(w & ((1u << (p & 31)) - 1u));
  }

  // One block's exclusive prefix of the geometry's words' bit counts
  // (block 0 of the grid): a run of words a thread, one block scan.
  __device__ void scan_words() const {
    const long long nw = geo_words(L);
    const long long per = (nw + blockDim.x - 1) / blockDim.x;
    const long long b = threadIdx.x * per, e = min(nw, b + per);
    int32_t sum = 0;
    for (long long i = b; i < e; ++i)
      sum += __popc((uint32_t)S::ld(s.bits + i));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t inc = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t t = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += t;
    }
    if (lane == 31) s.ws[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int nwarps = blockDim.x >> 5;
      int32_t w = lane < nwarps ? s.ws[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t t = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += t;
      }
      if (lane < nwarps) s.ws[lane] = w;
    }
    __syncthreads();
    int32_t ex = (warp ? s.ws[warp - 1] : 0) + inc - sum;
    for (long long i = b; i < e; ++i) {
      S::st(s.pre + i, ex);
      ex += __popc((uint32_t)S::ld(s.bits + i));
    }
  }

  // The geometry (tpu.py:358-365), after the stage that cleared the bit
  // words and perm: the write begins' bits, their prefix, each read's
  // [lo, hi) and each write's place in perm. Returns whether one of this
  // thread's reads has a case-A range over kScan.
  __device__ bool geometry() const {
    s.sync();
    s.items(Wr, [&](long long w) {
      const long long p = sct(s.o.get(s.o.seg_lo, w), L);
      if (p >= 0) atomicOr((unsigned int*)(s.bits + (p >> 5)), 1u << (p & 31));
    });
    s.sync();
    if (blockIdx.x == 0) scan_words();
    s.sync();
    bool seen = false;
    s.items(R, [&](long long r) {
      const int32_t l = rank(gat(s.o.get(s.o.leaf, r), L));
      const int32_t h = rank(gat(__ldg(a.q_end + r), L));
      S::st(s.dlo + r, l);
      S::st(s.dhi + r, h);
      seen |= clampll(h, 0, Wr) - clampll(l, 0, Wr) > kScan;
    });
    s.items(Wr, [&](long long w) {
      const long long j = sct(rank(gat(s.o.get(s.o.seg_lo, w), L)), Wr);
      if (j >= 0) S::st(s.dperm + j, (int32_t)w);
    });
    return seen;
  }

  __device__ void seed_stage() {
    next_build();
    auto wval0 = [](int32_t t) { return t < 0 ? kInf : t; };
    build_trees(wval0);
    s.sync();
    query(wval0, [&](int t, int32_t v) {
      min_red(s.at(kConf, t), (uint32_t)v);
    });
    s.sync();
    // Each txn composes its chain; a word read is its owner's progress
    // (kEmpty: none yet, so the parent's own link).
    s.own(T, [&](int t) {
      uint32_t w = link(t);
      while ((w & kPtrMask) != (uint32_t)T) {
        const int p = (int)(w & kPtrMask);
        uint32_t wp = (uint32_t)S::ld(s.at(kWord, p));
        if (wp == kEmpty) wp = link(p);
        const uint32_t a0 = (w >> 30) & 1, b0 = w >> 31;
        const uint32_t na = (wp >> 30) & 1 ? b0 : a0;
        const uint32_t nb = wp >> 31 ? b0 : a0;
        w = (wp & kPtrMask) | na << 30 | nb << 31;
        S::st(s.at(kWord, t), (int32_t)w);
      }
      S::st(s.at(kWord, t), (int32_t)w);
    });
    s.sync();
  }

  __device__ void run() {
    fill_trees();
    s.fill(kEv, T, [](int32_t* p) { *p = -1; });
    if (a.seed) {
      s.fill(kConf, T, [](int32_t* p) { *p = kInf; });
      s.fill(kWord, T, [](int32_t* p) { *p = (int32_t)kEmpty; });
    }
    s.init_misc();
    bool seen = false;  // a case-A range over kScan among this thread's
    if (a.geo) {
      s.items(geo_words(L), [&](long long i) { S::st(s.bits + i, 0); });
      s.items(Wr, [&](long long j) { S::st(s.dperm + j, 0); });
    } else {
      s.items(R, [&](long long r) {
        seen |= clampll(__ldg(a.hi + r), 0, Wr) -
                    clampll(__ldg(a.lo + r), 0, Wr) > kScan;
      });
    }
    s.load_operands(a);
    if (a.geo) seen = geometry();
    s.long_put(seen);
    s.sync();
    tree_a = s.long_get();
    if (a.seed) seed_stage();

    for (int j = 0;; ++j) {
      const bool more = a.it0 + j < a.cap;  // it0 <= cap < 2^31
      if (more) next_build();
      bool changed = false;
      s.own(T, [&](int t) {
        const int32_t c = conf_at(t, j);
        int32_t* p = s.at(kConf, t);
        if (j > 0 && S::ld(p) != c) changed = true;
        S::st(p, c);
      });
      // wval under c_j: computed in stage 1, where conf is being
      // written; read from conf in stage 2, where the evidence is.
      auto wval = [&](int32_t t) {
        return t >= 0 && conf_at(min(t, T - 1), j) == 0 ? t : kInf;
      };
      auto wval_kept = [&](int32_t t) {
        return t >= 0 && S::ld(s.at(kConf, min(t, T - 1))) == 0 ? t : kInf;
      };
      if (more) {
        s.flag_set(changed, j);
        build_trees(wval);
        s.sync();
      }
      if (!more || (j > 0 && s.flag() != j)) {
        s.out(a);
        if (s.leader()) *a.it_out = a.it0 + j;
        return;
      }
      query(wval_kept, [&](int t, int32_t) { S::st(s.at(kEv, t), j); });
      s.sync();
    }
  }
};

__global__ void __launch_bounds__(kGridThreads) grid_kernel(Args a) {
  __shared__ int32_t block_level;
  __shared__ int32_t ws[32];
  GridTier s(a, &block_level, ws);
  Phase2<GridTier>(a, s).run();
}

__global__ void __launch_bounds__(kBlockThreads, 1) block_kernel(Args a) {
  extern __shared__ int32_t smem[];
  BlockTier s(a, smem);
  Phase2<BlockTier>(a, s).run();
}

}  // namespace

// Threads of each block of a tier: 0 grid, 1 block.
extern "C" int fdb_phase2_block_threads(int tier) {
  return tier ? kBlockThreads : kGridThreads;
}

// int32 slots of the grid tier's scratch for a grid of `blocks`: the
// state but the conflict vector (the output), a long-range bit a block,
// and with the geometry (geo != 0) perm, lo, hi and the bit words and
// their prefix.
extern "C" long long fdb_phase2_scratch_ints(int T, int R, int Wr, int L,
                                             int blocks, int geo) {
  return state_ints(T, Wr, L) - T + blocks +
         (geo ? Wr + 2LL * R + 2 * geo_words(L) : 0);
}

// Bytes of shared memory the block tier takes: the state and the
// operand copies, and with the geometry its bit words, their prefix and
// 32 words for their scan.
extern "C" long long fdb_phase2_block_bytes(int T, int R, int Wr, int L,
                                            int geo) {
  return 4 * (state_ints(T, Wr, L) + operand_ints(T, R, Wr) +
              (geo ? 2 * geo_words(L) + 32 : 0));
}

// One query of the current device, and the block kernel's shared memory
// limit set on it: out = [SMs, shared memory a block may opt in to, grid
// kernel blocks per SM].
extern "C" int fdb_phase2_limits(int* out) {
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel,
                                                      kGridThreads, 0);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = sms;
  out[1] = smem;
  out[2] = per_sm;
  return 0;
}

// Launch tier 0 (a cooperative grid of `size` blocks) or 1 (one block,
// size 1, with smem_bytes of shared memory, at least
// fdb_phase2_block_bytes) on `stream`; seed != 0 runs the
// pointer-jumping seed first (conflict0 is then not read). geo != 0
// asks for the geometry from q_end: perm, lo and hi are then not read,
// seg_lo is s_begin, leaf q_begin and L P2; else q_end is not read.
extern "C" int fdb_phase2_rounds(
    const void* base, const void* conflict0, const void* perm,
    const void* lo, const void* hi, const void* seg_lo, const void* seg_hi,
    const void* leaf, const void* rtxn, const void* wtxn,
    const void* w_valid, const void* q_end, void* out, void* it_out,
    void* scratch, int T, int R, int Wr, int L, int it0, int cap, int seed,
    int geo, int tier, int size, long long smem_bytes, void* stream) {
  if (T < 1 || T >= kMaxT || R < 0 || Wr < 0 || Wr >= kMaxLeaves ||
      L < 1 || L >= kMaxLeaves || size < 1 || it0 > cap ||
      (tier == 1 &&
       (size != 1 || smem_bytes < fdb_phase2_block_bytes(T, R, Wr, L, geo))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.base = (const int32_t*)base;
  a.conflict0 = (const int32_t*)conflict0;
  a.perm = (const int32_t*)perm;
  a.lo = (const int32_t*)lo;
  a.hi = (const int32_t*)hi;
  a.seg_lo = (const int32_t*)seg_lo;
  a.seg_hi = (const int32_t*)seg_hi;
  a.leaf = (const int32_t*)leaf;
  a.rtxn = (const int32_t*)rtxn;
  a.wtxn = (const int32_t*)wtxn;
  a.w_valid = (const uint8_t*)w_valid;
  a.q_end = (const int32_t*)q_end;
  a.geo = geo != 0;
  a.out = (int32_t*)out;
  a.it_out = (int32_t*)it_out;
  a.scratch = (int32_t*)scratch;
  a.T = T;
  a.R = R;
  a.Wr = Wr;
  a.L = L;
  a.it0 = it0;
  a.cap = cap;
  a.seed = seed != 0;
  if (tier == 0) {
    void* params[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)grid_kernel, dim3(size), dim3(kGridThreads), params, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    block_kernel<<<1, kBlockThreads, (size_t)smem_bytes,
                   (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
