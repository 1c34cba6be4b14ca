// Phase 2 of the resolver, the intra-batch fixed point, for Hopper (sm_90a).
//
// Replaces the verification loop `lax.while_loop` of the JAX package in
// foundationdb_tpu/resolver/tpu.py::_phase2_fixed_point (loop :419-437,
// the block and dense kernels' phase 2) and in
// foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl (:223-253, the
// rank-fed set's phase 2). Both are XLA-jitted; neither reaches a
// pallas_call. The plain torch version is
// foundationdb_tpu_torch/resolver/phase2.py `phase2_rounds_ref`.
//
// Why it was written: the resolvers' dispatch contract. The JAX package's
// submit enqueues its whole resolve and never waits for the device
// (tpu.py:103-107); its loop stops on a device boolean. Eager torch cannot
// stop on a device value without reading it on the host, so the port ran
// the rounds in groups with one host read per group, and each read waited
// for everything queued before it. This kernel runs every round on the
// device, so a submit makes no host read and the host packs the next
// chunk while the card resolves this one.
//
// One round, Jacobi style (it reads only the old conflict vector `cur`
// and writes the new one `nxt`, so the round count equals the JAX loop's):
//   wval[w] = w_valid[w] && cur[wtxn[w]] == 0 ? wtxn[w] : INT32_MAX
//   case A  = min wval[perm[j]] over j in [lo[r], hi[r])   (writes that
//             begin strictly inside read r's span)
//   case B  = min wval[w] over writes w whose segment [seg_lo, seg_hi)
//             covers leaf[r] (no stab where leaf[r] < 0)
//   ev[t]   = 1 if some read r of txn t = rtxn[r] has min(A, B) < t
//   nxt[t]  = max(base[t], ev[t]); repeat while nxt != cur and it < cap.
// The loop counter starts at it0 (gpu.py: the pointer-jumping rounds that
// seeded conflict0; rankfed.py: 0) and is returned.
//
// Bound on the card: bytes. One round must read the conflict vector and
// write the new one (8*T bytes), read rtxn, lo, hi and leaf per read
// (16*R) and wtxn, w_valid, perm, seg_lo and seg_hi per write (17*Wr);
// times the rounds. At the resolver's shapes that is a few microseconds a
// round, below the cost of the three grid-wide barriers a round takes and
// of the launch: those bound this kernel in practice.
//
// The design:
// - One cooperative grid (cudaLaunchCooperativeKernel), every block
//   resident: as many blocks of kThreads per SM as the occupancy query
//   allows, times the SMs of the current device, computed at each launch.
//   Every stage is a grid-stride loop, so any T, R and Wr run on one grid;
//   cooperative_groups' grid sync separates the stages. A launch the CUDA
//   runtime refuses returns its error; the wrapper raises naming the grid.
// - Case A is a min segment tree over the rank order (leaves Wr + j,
//   node i = min(2i, 2i+1), any Wr), built in one stage: each leaf's
//   thread walks up with atomicMin and stops at the first node already at
//   or below its value (whoever lowered that node walks on above it). A
//   read queries the O(log Wr) canonical nodes of [lo, hi). The JAX
//   package builds a sparse table instead; both give the exact minimum.
// - Case B is the interval tree of the JAX loop: each committed write
//   atomicMins its value into the canonical nodes of its segment, computed
//   here from the two bounds with the JAX loop's step count. An unused
//   canonical slot sends nothing, where the torch version scatters every
//   unused slot to dump node 0 (never read by a stab).
// - Writes of value INT32_MAX (uncommitted or invalid) touch no tree.
// - Data written inside the kernel is read with ld.global.cg (L2), never
//   from a stale L1 line of an earlier stage or round.
// - Between rounds the trees are reset to INT32_MAX and the evidence to 0
//   in the stage after their last read; a per-round changed flag (two
//   slots, by round parity) is cleared one stage after every thread read
//   it.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on
// the caller's stream, allocates nothing (the wrapper passes a scratch
// buffer of fdb_phase2_scratch_ints() int32) and returns the cudaError_t of
// the launch; the grid it used is written to *grid_blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInf = INT32_MAX;

struct Args {
  const int32_t* base;       // (T,) phase-1 conflicts (history, tooOld)
  const int32_t* conflict0;  // (T,) the loop's initial conflict vector
  const int32_t* perm;       // (Wr,) write row at each begin rank (case A)
  const int32_t* lo;         // (R,) case A range [lo, hi) in rank order
  const int32_t* hi;         // (R,)
  const int32_t* seg_lo;     // (Wr,) write segment [seg_lo, seg_hi) (case B)
  const int32_t* seg_hi;     // (Wr,)
  const int32_t* leaf;       // (R,) leaf the read stabs, < 0: none
  const int32_t* rtxn;       // (R,) owning txn of each read
  const int32_t* wtxn;       // (Wr,) owning txn of each write
  const uint8_t* w_valid;    // (Wr,) bool
  int32_t* out;              // (T,) the fixed point
  int32_t* it_out;           // (1,) the round counter at exit
  int32_t* tmp;              // (T,) second conflict buffer
  int32_t* ev;               // (T,) evidence per txn
  int32_t* tree_a;           // (2*Wr,) case A min tree
  int32_t* tree_b;           // (2*L,) case B interval tree
  int32_t* flags;            // (2,) changed flag per round parity
  int T, R, Wr, L, it0, cap;
};

__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldcg(p); }

__device__ __forceinline__ void min_at(int32_t* p, int32_t v) {
  if (ld(p) > v) atomicMin(p, v);
}

// wval of write w under conflict vector cur (the gather index clamped as
// JAX clamps it).
__device__ __forceinline__ int32_t wval(const Args& a, const int32_t* cur,
                                        int w) {
  if (!a.w_valid[w]) return kInf;
  const int32_t t = __ldg(a.wtxn + w);
  return ld(cur + min(max(t, 0), a.T - 1)) == 0 ? t : kInf;
}

__global__ void __launch_bounds__(kThreads) phase2_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int T = a.T, R = a.R, Wr = a.Wr, L = a.L;
  const int levels = L > 0 ? 32 - __clz(L) : 0;  // L.bit_length()

  // Initial state: trees empty, no evidence, flags clear.
  for (long long i = gtid; i < 2LL * Wr; i += stride) a.tree_a[i] = kInf;
  for (long long i = gtid; i < 2LL * L; i += stride) a.tree_b[i] = kInf;
  for (long long i = gtid; i < T; i += stride) a.ev[i] = 0;
  if (gtid < 2) a.flags[gtid] = 0;
  grid.sync();

  const int32_t* cur = a.conflict0;
  int it = a.it0, parity = 0;  // round parity: buffer and flag slot
  while (it < a.cap) {
    int32_t* nxt = parity ? a.tmp : a.out;
    // Stage 1: the two trees from the committed writes.
    for (long long w = gtid; w < Wr; w += stride) {
      const int32_t v = wval(a, cur, (int)w);
      if (v == kInf) continue;
      long long l = (long long)__ldg(a.seg_lo + w) + L;
      long long r = (long long)__ldg(a.seg_hi + w) + L;
      for (int s = 0; s < levels && l < r; ++s) {
        if (l & 1) {
          if (l >= 0 && l < 2LL * L) min_at(a.tree_b + l, v);
          ++l;
        }
        if (r & 1) {
          --r;
          if (r >= 0 && r < 2LL * L) min_at(a.tree_b + r, v);
        }
        l >>= 1;
        r >>= 1;
      }
    }
    for (long long j = gtid; j < Wr; j += stride) {
      const int w = min(max(__ldg(a.perm + j), 0), Wr - 1);
      const int32_t v = wval(a, cur, w);
      long long node = Wr + j;
      a.tree_a[node] = v;
      if (v == kInf) continue;
      for (node >>= 1; node >= 1; node >>= 1) {
        if (ld(a.tree_a + node) <= v) break;
        atomicMin(a.tree_a + node, v);
      }
    }
    grid.sync();

    // Stage 2: per read, the least committed writer covering it.
    if (gtid == 0) a.flags[parity ^ 1] = 0;  // read by all before sync 1
    for (long long r = gtid; r < R; r += stride) {
      int32_t m = kInf;
      long long l = min(max(__ldg(a.lo + r), 0), Wr) + (long long)Wr;
      long long h = min(max(__ldg(a.hi + r), 0), Wr) + (long long)Wr;
      while (l < h) {
        if (l & 1) m = min(m, ld(a.tree_a + l++));
        if (h & 1) m = min(m, ld(a.tree_a + --h));
        l >>= 1;
        h >>= 1;
      }
      const int32_t x = __ldg(a.leaf + r);
      if (x >= 0) {
        const long long node = (long long)x + L;
        for (int k = 0; k < levels; ++k) {
          const long long n = node >> k;
          if (n < 2LL * L) m = min(m, ld(a.tree_b + n));
        }
      }
      const int32_t t = __ldg(a.rtxn + r);
      if (m < t && t >= 0 && t < T) a.ev[t] = 1;
    }
    grid.sync();

    // Stage 3: the new conflict vector; reset what stages 1-2 used.
    bool changed = false;
    for (long long t = gtid; t < T; t += stride) {
      const int32_t v = max(__ldg(a.base + t), ld(a.ev + t));
      changed |= v != ld(cur + t);
      nxt[t] = v;
      a.ev[t] = 0;
    }
    for (long long i = gtid + 1; i < Wr; i += stride) a.tree_a[i] = kInf;
    for (long long i = gtid; i < 2LL * L; i += stride) a.tree_b[i] = kInf;
    if (__syncthreads_or(changed) && threadIdx.x == 0) a.flags[parity] = 1;
    grid.sync();

    ++it;
    cur = nxt;
    const bool more = ld(a.flags + parity) != 0;
    parity ^= 1;
    if (!more) break;
  }
  // The last round wrote `cur` (out or tmp). With no round, conflict0.
  if (cur != a.out)
    for (long long t = gtid; t < T; t += stride) a.out[t] = ld(cur + t);
  if (gtid == 0) *a.it_out = it;
}

}  // namespace

// Threads of each block of the grid.
extern "C" int fdb_phase2_block_threads() { return kThreads; }

// int32 slots of the scratch buffer the launch takes.
extern "C" long long fdb_phase2_scratch_ints(int T, int Wr, int L) {
  return 2LL * T + 2LL * Wr + 2LL * L + 2;
}

extern "C" int fdb_phase2_rounds(
    const void* base, const void* conflict0, const void* perm,
    const void* lo, const void* hi, const void* seg_lo, const void* seg_hi,
    const void* leaf, const void* rtxn, const void* wtxn,
    const void* w_valid, void* out, void* it_out, void* scratch, int T,
    int R, int Wr, int L, int it0, int cap, void* stream,
    int* grid_blocks) {
  *grid_blocks = 0;
  if (T < 1 || R < 0 || Wr < 0 || L < 1) return (int)cudaErrorInvalidValue;
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
  a.out = (int32_t*)out;
  a.it_out = (int32_t*)it_out;
  auto* s = (int32_t*)scratch;
  a.tmp = s;
  a.ev = s + T;
  a.tree_a = s + 2LL * T;
  a.tree_b = s + 2LL * T + 2LL * Wr;
  a.flags = s + 2LL * T + 2LL * Wr + 2LL * L;
  a.T = T;
  a.R = R;
  a.Wr = Wr;
  a.L = L;
  a.it0 = it0;
  a.cap = cap;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phase2_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *grid_blocks = per_sm * sms;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)phase2_kernel,
                                  dim3(per_sm * sms), dim3(kThreads), params,
                                  0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
