// Two-level rank probe of the block-sparse conflict set, for Hopper (sm_90a).
//
// Replaces the TPU kernel foundationdb_tpu/resolver/pallas_probe.py
// `_probe_kernel` (driven by `probe_ranks`, pallas_call at :124). For every
// query column p of the (W1, P2) int32 key matrix it computes
//   bid[p] = index of the last fence <= key      (fence halving walk)
//   lb[p]  = the in-block halving walk's rank in block clip(bid)
//   eq[p]  = 1 iff the entry at that rank equals the key
// by lexicographic int32 compare over the W1 word rows, with the clamps of
// pallas_probe.py:82-96, bit for bit, for any input: queries in any order,
// blocks in any order (where the walk and a count of smaller slots differ).
// The plain torch version is foundationdb_tpu_torch/resolver/probe.py
// `probe_ranks_ref`.
//
// Bound on the card: bytes. Per call the function must read the fence
// directory once (4*W1*NB bytes), the slots of every block a query lands
// in once (4*W1*B bytes per touched block), the queries once (4*W1*P2) and
// write the three outputs once (12*P2); its ~W1*(log2 NB + log2 B + 2)
// int32 compares per query are far below the card's integer rate. A walk
// is a chain of dependent loads, each W1 words from rows NB or C ints
// apart, so what the card reaches is set by the rounds of loads a query
// waits for and by the load instructions the SMs must issue.
//
// The design, against the one-thread-per-query walk of the first port (23
// dependent steps at NB = 65,536, B = 32, each compare reading word after
// word until one differs, so two dependent loads per step for short keys
// whose first word is the same, and re-reading the query at every step):
// - One thread per query. A warp-per-query variant with a ballot over a
//   32-slot block measured slower than the first port, warm (1.4x on the
//   main path, 2.3x at the full shape; PERF.md): counted by hand from its source, its warp issues about 50 instructions
//   per query for the in-block step (key shuffles, W1 loads and compares,
//   two ballots, the replay, a shuffle back), where a thread walk's warp
//   issues about 4 per query (5 steps of ~22 for 32 queries at W1 = 4).
//   The query's words are loaded
//   once into registers, W1 <= 8 by a template per W1; wider keys stay in
//   global memory behind the read-only cache (the widest key, 10,001 bytes
//   = 2,503 words, fits no per-thread register or shared budget).
// - Every compare loads all W1 words at once (no early exit), so a step
//   costs one round trip, not one per equal leading word.
// - The fence walk's top L levels read only the columns j*g - 1 (g =
//   NB >> L, j = 1 .. 2^L - 1); each block stages them once in shared
//   memory, word-interleaved, and the step at (pos, s) reads staged slot
//   (pos + s)/g - 1: the same walk on the same columns. L = min(kLevels,
//   log2 NB - log2 kWin), less where the stage would pass kStageBytes; 0
//   where NB is not a power of two.
// - The last log2(kWin) steps of each walk and its equality step read one
//   aligned window of kWin = 4 columns with one 16-byte load per word row
//   (one round trip), build lt/eq bit masks and replay the halving walk on
//   them in registers (pos += s iff bit pos + s - 1 is set; eq is the bit
//   at the final rank). The walk reaches the window with pos a multiple of
//   kWin, so its steps and equality read exactly those columns: the same
//   result for any contents. A walk whose window cannot apply (W1 > 8, NB
//   or B below kWin, NB not a power of two, or an operand not 16-byte
//   aligned) takes the same steps one column at a time.
// - start + B - 1 <= C - 1 always holds (start = clip(bid) * B, C = NB*B),
//   so the walk's clamp at pallas_probe.py:90 never binds and no column
//   leaves the block.
// - A persistent grid (up to kBlocksPerSM blocks of kThreads per SM, as
//   many as the registers allow) loops over the queries, so the
//   stage is paid once per block. The walk is latency-bound: every thread
//   resident on an SM adds loads in flight.
// The constants below were chosen on an NVIDIA H100 80GB HBM3 at 700 W
// (probe_bench.py; PERF.md). Measured there (chip_smoke.py): ptxas gives
// 32 registers and no spills at W1 = 4 (26-38 for W1 = 1-8, 24 for wider keys); the stage takes
// 63 * W1 * 4 bytes of dynamic shared memory (1,008 at W1 = 4). At the
// main path's shape (W1 = 4, NB = 65,536, B = 32, P2 = 114,688) it runs
// in 0.0077 ms warm, 0.0158 ms cold, against a bound of 0.0049 ms; at
// P2 = 917,504 in 0.0365 / 0.0389 ms against 0.0155 ms. Still latency-
// bound there: about 12 dependent rounds of loads per query.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() of the
// launch. Offsets are int64(row) * stride + col: W1 * C can pass 2^31
// after the key width grows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 6;    // fence-directory levels staged in shared memory
constexpr int kWin = 4;       // columns of the closing window: one int4 a row
constexpr int kLogWin = 2;
constexpr int kThreads = 256;
constexpr int kStageBytes = 96 * 1024;  // the widest stage (wide keys)

// Blocks per SM the launch asks registers for: 8 blocks are 2,048 threads
// at most 32 registers each; keys of 5-8 words need more and take 6 (40).
template <int W1>
constexpr int kBlocksPerSM = W1 >= 5 ? 6 : 8;

__device__ __forceinline__ void lex_step(int32_t a, int32_t b, bool& lt,
                                         bool& eq) {
  lt |= eq & (a < b);
  eq &= a == b;
}

// The W1 words of one query, in registers. cmp gives (h < key, h == key)
// for the key whose words are h[0], h[ld], h[2*ld], ...: every word is
// loaded (no early exit), so the W1 loads are in flight together.
template <int W1>
struct Key {
  int32_t w[W1];

  __device__ __forceinline__ void load(const int32_t* __restrict__ q,
                                       long long ldq, long long p, int) {
#pragma unroll
    for (int i = 0; i < W1; ++i) w[i] = __ldg(q + i * ldq + p);
  }
  __device__ __forceinline__ void cmp(const int32_t* h, long long ld,
                                      bool& lt, bool& eq) const {
    lt = false;
    eq = true;
#pragma unroll
    for (int i = 0; i < W1; ++i) lex_step(h[i * ld], w[i], lt, eq);
  }
};

// Wider keys: the query's column stays in global memory (read-only cache);
// cmp stops at the first differing word, which gives the same lt/eq.
template <>
struct Key<0> {
  const int32_t* q;
  long long ldq, p;
  int n;

  __device__ __forceinline__ void load(const int32_t* __restrict__ q_,
                                       long long ldq_, long long p_, int n_) {
    q = q_;
    ldq = ldq_;
    p = p_;
    n = n_;
  }
  __device__ __forceinline__ void cmp(const int32_t* h, long long ld,
                                      bool& lt, bool& eq) const {
    lt = false;
    eq = true;
    for (int i = 0; i < n; ++i) {
      const int32_t a = h[i * ld];
      const int32_t b = __ldg(q + i * ldq + p);
      if (a != b) {
        lt = a < b;
        eq = false;
        return;
      }
    }
  }
};

// Halving steps s, s/2, ... while s >= until: pos += s wherever column
// pos + s - 1 of h (word rows ld apart) is < key.
template <class K>
__device__ __forceinline__ int steps(const int32_t* h, long long ld,
                                     const K& key, int pos, int& s,
                                     int until) {
  bool lt, eq;
  for (; s >= until; s >>= 1) {
    key.cmp(h + (pos + s - 1), ld, lt, eq);
    if (lt) pos += s;
  }
  return pos;
}

// The last log2(kWin) steps and the equality step of a walk whose pos is
// at column 0 of h (16-byte aligned): the walk's offset in the window, and
// eq at it.
template <int W1>
__device__ __forceinline__ int window(const int32_t* h, long long ld,
                                      const Key<W1>& key, bool& eq) {
  bool lt_j[kWin] = {false, false, false, false};
  bool eq_j[kWin] = {true, true, true, true};
#pragma unroll
  for (int i = 0; i < W1; ++i) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(h + i * ld));
    lex_step(v.x, key.w[i], lt_j[0], eq_j[0]);
    lex_step(v.y, key.w[i], lt_j[1], eq_j[1]);
    lex_step(v.z, key.w[i], lt_j[2], eq_j[2]);
    lex_step(v.w, key.w[i], lt_j[3], eq_j[3]);
  }
  unsigned ltm = 0, eqm = 0;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    ltm |= (unsigned)lt_j[j] << j;
    eqm |= (unsigned)eq_j[j] << j;
  }
  int b = 0;
#pragma unroll
  for (int s = kWin / 2; s >= 1; s >>= 1)
    if ((ltm >> (b + s - 1)) & 1u) b += s;
  eq = (eqm >> b) & 1u;
  return b;
}

template <int W1T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<W1T>)
    probe_kernel(const int32_t* __restrict__ hkeys,
                 const int32_t* __restrict__ fences,
                 const int32_t* __restrict__ q, int32_t* __restrict__ bid_out,
                 int32_t* __restrict__ lb_out, int32_t* __restrict__ eq_out,
                 int W1, long long C, int NB, int B, long long P2, int L,
                 int lg, bool win_f, bool win_b) {
  extern __shared__ int32_t staged[];  // (2^L - 1) fences x W1 words
  const int W = W1T ? W1T : W1;

  // Stage fence columns j*g - 1 (g = 2^lg) at slot j - 1, words adjacent.
  const int n_staged = ((1 << L) - 1) * W;
  for (int t = threadIdx.x; t < n_staged; t += blockDim.x) {
    const int slot = t / W, w = t - slot * W;
    staged[t] = fences[(long long)w * NB + ((long long)(slot + 1) << lg) - 1];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < P2; p += stride) {
    Key<W1T> key;
    key.load(q, P2, p, W1);
    bool lt, eq;

    // Fence rank: #fences < key (the top L steps from the stage), then the
    // last fence <= key.
    int pos = 0, s = NB >> 1;
    for (int k = 0; k < L; ++k, s >>= 1) {
      key.cmp(staged + (((pos + s) >> lg) - 1) * W, 1, lt, eq);
      if (lt) pos += s;
    }
    if constexpr (W1T > 0) {
      if (win_f) {
        pos = steps(fences, NB, key, pos, s, kWin);
        pos += window(fences + pos, NB, key, eq);
      }
    }
    if (W1T == 0 || !win_f) {
      pos = steps(fences, NB, key, pos, s, 1);
      key.cmp(fences + min(max(pos, 0), NB - 1), NB, lt, eq);
    }
    const int bid = pos + (eq ? 1 : 0) - 1;

    // In-block rank, confined to the B slots of block clip(bid).
    const int32_t* blk = hkeys + (long long)min(max(bid, 0), NB - 1) * B;
    int bpos = 0;
    s = B >> 1;
    if constexpr (W1T > 0) {
      if (win_b) {
        bpos = steps(blk, C, key, 0, s, kWin);
        bpos += window(blk + bpos, C, key, eq);
      }
    }
    if (W1T == 0 || !win_b) {
      bpos = steps(blk, C, key, 0, s, 1);
      key.cmp(blk + bpos, C, lt, eq);
    }

    bid_out[p] = bid;
    lb_out[p] = bpos;
    eq_out[p] = eq ? 1 : 0;
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

int log2_exact(long long x) {  // log2 of a power of two, else -1
  int k = 0;
  while ((1LL << k) < x) ++k;
  return (1LL << k) == x ? k : -1;
}

template <int W1T>
int launch(const int32_t* hkeys, const int32_t* fences, const int32_t* q,
           int32_t* bid, int32_t* lb, int32_t* eq, int W1, long long C,
           int NB, int B, long long P2, cudaStream_t stream) {
  const int log_nb = log2_exact(NB);
  const bool win_f = W1T > 0 && log_nb >= kLogWin &&
                     (uintptr_t)fences % 16 == 0;
  const bool win_b = W1T > 0 && B >= kWin && (uintptr_t)hkeys % 16 == 0;
  int L = 0;
  if (log_nb > 0) {
    L = log_nb - (win_f ? kLogWin : 0);
    if (L > kLevels) L = kLevels;
    while (L > 0 && (long long)((1 << L) - 1) * W1 * 4 > kStageBytes) --L;
  }
  const int smem = ((1 << L) - 1) * W1 * 4;
  if (smem > 48 * 1024) {  // set on every such launch: the attribute is
                           // the current device's
    const cudaError_t e = cudaFuncSetAttribute(
        probe_kernel<W1T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (P2 + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSM<W1T>;
  if (blocks > cap) blocks = cap;
  probe_kernel<W1T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      hkeys, fences, q, bid, lb, eq, W1, C, NB, B, P2, L,
      log_nb < 0 ? 0 : log_nb - L, win_f, win_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fdb_probe_ranks(const void* hkeys, const void* fences,
                               const void* q, void* bid, void* lb, void* eq,
                               int W1, long long C, int NB, int B,
                               long long P2, void* stream) {
  if (P2 <= 0) return 0;
  if (W1 < 1 || NB < 1 || log2_exact(B) < 0 || C != (long long)NB * B)
    return (int)cudaErrorInvalidValue;
  const auto* h = (const int32_t*)hkeys;
  const auto* f = (const int32_t*)fences;
  const auto* qq = (const int32_t*)q;
  auto* o0 = (int32_t*)bid;
  auto* o1 = (int32_t*)lb;
  auto* o2 = (int32_t*)eq;
  const auto s = (cudaStream_t)stream;
  switch (W1) {
#define PROBE_CASE(n) \
  case n:             \
    return launch<n>(h, f, qq, o0, o1, o2, W1, C, NB, B, P2, s);
    PROBE_CASE(1) PROBE_CASE(2) PROBE_CASE(3) PROBE_CASE(4)
    PROBE_CASE(5) PROBE_CASE(6) PROBE_CASE(7) PROBE_CASE(8)
#undef PROBE_CASE
    default:
      return launch<0>(h, f, qq, o0, o1, o2, W1, C, NB, B, P2, s);
  }
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
