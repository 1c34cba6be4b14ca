// The storage window's read gather, for Hopper (sm_90a).
//
// Replaces what follows the base probe in the JAX package's
// foundationdb_tpu/storage_engine/tpu_engine.py::_read_kernel_impl
// (:113-197, XLA-jitted; no pallas_call): the global rank by the
// uniform-fill arithmetic, the delta rank (resolver/tpu.py `_lower_rank`,
// the halving walk over the power-of-two, +inf padded delta), each point
// read's base and delta predecessor with its key-equality test, each range
// read's S-wide base and delta span with the local MVCC visibility test,
// and the aux vector they are concatenated into, in tpu_engine.py's order:
//   pt_found, pt_slot, pt_ver, pt_dfound, pt_dslot, pt_dver   (P each)
//   rb, re, drb, dre                                            (R each)
//   vis, sslot, sver, dvis, dsslot, dsver                       (R x S each)
// The probe (csrc/probe.cu) runs first and hands over bid and pos. The
// plain torch version is foundationdb_tpu_torch/storage_engine/read.py
// `read_gather_ref`; every output equals it bit for bit on every input.
//
// Bound on the card: bytes. Per call the kernel must read the probe's two
// rows and the queries once, the delta columns its walks touch, each
// point's two predecessor columns and each range's two spans (version,
// next flag and slot a slot), and write the aux vector once: well under a
// microsecond at the storage batches' shapes (P + 2R <= 264, S = 256).
// What bounds it is latency: a delta walk is log2(D) dependent column
// loads, then a predecessor or span gather.
//
// The design: one launch, no scratch and no grid barrier. Block r < R
// takes range r: four of its threads compute rb, re (the fill
// arithmetic) and drb, dre (two delta walks) into shared memory, then its
// threads take the S span slots; the blocks after take 256 point reads
// each, a thread a point (one delta walk, two predecessor gathers). Every
// compare is a generic loop over the W2 word rows (any key width), signed
// int32, decided at the first differing word; every gather clamps its
// index as tpu_engine.py's do (col_of clips onto the last column, which is
// padding because the fill F < B; the delta's onto [0, D)). Integer
// division and remainder floor, as jnp's do.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on
// the caller's stream, allocates nothing and returns cudaGetLastError()
// of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct ReadArgs {
  const int32_t* hmat;      // (W2, NB B) base window, version row last
  const int32_t* slots;     // (NB B,)
  const int32_t* nextsame;  // (NB B,)
  const int32_t* dmat;      // (W2, D) delta, version row last
  const int32_t* dslots;    // (D,)
  const int32_t* dnext;     // (D,)
  const int32_t* qall;      // (W2, P + 2R) point, range-begin, range-end keys
  const int32_t* rv;        // (R,) each range's read version
  const int32_t* bid;       // (P + 2R,) the probe's block ids
  const int32_t* pos;       // (P + 2R,) the probe's in-block ranks
  int32_t* aux;             // (6 P + 4 R + 6 R S,) out
  int W2, P, R, S, F, NB, B, D;
};

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);  // int32 wrap, as XLA's
}

// The uniform-fill column of a global rank, clipped into [0, NB B).
__device__ __forceinline__ long long col_of(const ReadArgs& a, int32_t r) {
  const int32_t q = floordiv(r, a.F);
  const int32_t m = r - q * a.F;
  const long long c =
      (long long)(int32_t)((uint32_t)q * (uint32_t)a.B + (uint32_t)m);
  const long long n = (long long)a.NB * a.B;
  return c < 0 ? 0 : (c > n - 1 ? n - 1 : c);
}

// Column x of the (rows, ld) matrix h against column y of the queries,
// over the first `rows` word rows: lexicographically smaller, or equal.
__device__ __forceinline__ bool lex_lt(const int32_t* h, long long ld,
                                       long long x, const ReadArgs& a,
                                       long long y, int rows) {
  const long long qld = (long long)a.P + 2LL * a.R;
  for (int r = 0; r < rows; ++r) {
    const int32_t u = __ldg(h + r * ld + x), v = __ldg(a.qall + r * qld + y);
    if (u != v) return u < v;
  }
  return false;
}

__device__ __forceinline__ bool lex_eq(const int32_t* h, long long ld,
                                       long long x, const ReadArgs& a,
                                       long long y, int rows) {
  const long long qld = (long long)a.P + 2LL * a.R;
  for (int r = 0; r < rows; ++r)
    if (__ldg(h + r * ld + x) != __ldg(a.qall + r * qld + y)) return false;
  return true;
}

// Query q's global rank in the base (the probe's block and in-block rank).
__device__ __forceinline__ int32_t base_rank(const ReadArgs& a, long long q) {
  int32_t b = __ldg(a.bid + q);
  b = b < 0 ? 0 : (b > a.NB - 1 ? a.NB - 1 : b);
  return add32((int32_t)((uint32_t)b * (uint32_t)a.F), __ldg(a.pos + q));
}

// Query q's rank in the delta: #columns strictly below it over all W2
// rows, by the halving walk (at most D - 1).
__device__ __forceinline__ int32_t delta_rank(const ReadArgs& a,
                                              long long q) {
  int32_t p = 0;
  for (int s = a.D / 2; s >= 1; s /= 2)
    if (lex_lt(a.dmat, a.D, p + s - 1, a, q, a.W2)) p += s;
  return p;
}

__global__ void __launch_bounds__(kThreads) read_kernel(ReadArgs a) {
  const long long P = a.P, R = a.R, S = a.S;
  const long long NBB = (long long)a.NB * a.B;
  const int32_t* vrow = a.hmat + (long long)(a.W2 - 1) * NBB;
  const int32_t* dvrow = a.dmat + (long long)(a.W2 - 1) * a.D;
  int32_t* ranges = a.aux + 6 * P;  // rb, re, drb, dre
  int32_t* spans = ranges + 4 * R;  // vis, sslot, sver, dvis, dsslot, dsver
  if (blockIdx.x < R) {
    const long long r = blockIdx.x;
    __shared__ int32_t rk[4];  // rb, re, drb, dre
    if (threadIdx.x < 4) {
      const long long q = P + (threadIdx.x & 1) * R + r;
      const int32_t v = threadIdx.x < 2 ? base_rank(a, q) : delta_rank(a, q);
      rk[threadIdx.x] = v;
      ranges[threadIdx.x * R + r] = v;
    }
    __syncthreads();
    const int32_t rb = rk[0], re = rk[1], drb = rk[2], dre = rk[3];
    const int32_t rv = __ldg(a.rv + r);
    const long long RS = R * S;
    for (long long k = threadIdx.x; k < S; k += blockDim.x) {
      const long long o = r * S + k;
      const int32_t idx = add32(rb, (int32_t)k);
      const long long sc = col_of(a, idx);
      const int32_t sver = __ldg(vrow + sc);
      const bool vis = idx < re && sver <= rv &&
                       (__ldg(a.nextsame + sc) == 0 ||
                        __ldg(vrow + col_of(a, add32(idx, 1))) > rv);
      spans[o] = vis;
      spans[RS + o] = __ldg(a.slots + sc);
      spans[2 * RS + o] = sver;
      const int32_t didx = add32(drb, (int32_t)k);
      const long long dc = didx < 0 ? 0 : (didx > a.D - 1 ? a.D - 1 : didx);
      const int32_t dn = add32(didx, 1);
      const long long dc1 = dn < 0 ? 0 : (dn > a.D - 1 ? a.D - 1 : dn);
      const int32_t dsver = __ldg(dvrow + dc);
      const bool dvis = didx < dre && dsver <= rv &&
                        (__ldg(a.dnext + dc) == 0 || __ldg(dvrow + dc1) > rv);
      spans[3 * RS + o] = dvis;
      spans[4 * RS + o] = __ldg(a.dslots + dc);
      spans[5 * RS + o] = dsver;
    }
    return;
  }
  const long long p = (long long)(blockIdx.x - R) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  // The base predecessor of lower_bound((key, len, v + 1)).
  const int32_t pred = add32(base_rank(a, p), -1);
  const long long pc = col_of(a, pred < 0 ? 0 : pred);
  const bool found = pred >= 0 && lex_eq(a.hmat, NBB, pc, a, p, a.W2 - 1);
  a.aux[p] = found;
  a.aux[P + p] = __ldg(a.slots + pc);
  a.aux[2 * P + p] = __ldg(vrow + pc);
  // The delta's.
  const int32_t dpred = add32(delta_rank(a, p), -1);
  const long long dc = dpred < 0 ? 0 : (dpred > a.D - 1 ? a.D - 1 : dpred);
  const bool dfound = dpred >= 0 && lex_eq(a.dmat, a.D, dc, a, p, a.W2 - 1);
  a.aux[3 * P + p] = dfound;
  a.aux[4 * P + p] = __ldg(a.dslots + dc);
  a.aux[5 * P + p] = __ldg(dvrow + dc);
}

}  // namespace

// ptrs, in order: hmat, slots, nextsame, dmat, dslots, dnext, qall, rv,
// bid, pos, aux. One block a range read, then one a 256 point reads.
extern "C" int fdb_read_gather(void* const* ptrs, int W2, int P, int R,
                               int S, int F, int NB, int B, int D,
                               void* stream) {
  if (W2 < 2 || P < 0 || R < 0 || S < 1 || F < 1 || NB < 1 || B < 1 ||
      D < 1 || (D & (D - 1)))
    return (int)cudaErrorInvalidValue;
  ReadArgs a;
  a.hmat = (const int32_t*)ptrs[0];
  a.slots = (const int32_t*)ptrs[1];
  a.nextsame = (const int32_t*)ptrs[2];
  a.dmat = (const int32_t*)ptrs[3];
  a.dslots = (const int32_t*)ptrs[4];
  a.dnext = (const int32_t*)ptrs[5];
  a.qall = (const int32_t*)ptrs[6];
  a.rv = (const int32_t*)ptrs[7];
  a.bid = (const int32_t*)ptrs[8];
  a.pos = (const int32_t*)ptrs[9];
  a.aux = (int32_t*)ptrs[10];
  a.W2 = W2;
  a.P = P;
  a.R = R;
  a.S = S;
  a.F = F;
  a.NB = NB;
  a.B = B;
  a.D = D;
  const long long blocks = (long long)R + (P + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  read_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
