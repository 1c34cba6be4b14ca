// Two-level rank probe of the block-sparse conflict set, for Hopper (sm_90a).
//
// Replaces the TPU kernel foundationdb_tpu/resolver/pallas_probe.py
// `_probe_kernel` (driven by `probe_ranks`, pallas_call at :124). For every
// sorted query column p of the (W1, P2) int32 key matrix it computes
//   bid[p] = index of the last fence <= key      (fence halving walk)
//   lb[p]  = #entries of block bid that are < key (in-block halving walk)
//   eq[p]  = 1 iff the entry at that rank equals the key
// by lexicographic int32 compare over the W1 word rows, with the clamps of
// pallas_probe.py:82-96, bit for bit. The plain torch version is
// foundationdb_tpu_torch/resolver/probe.py `probe_ranks_ref`.
//
// Bound on the card: bytes. Per call the function must read the fence
// directory once (4*W1*NB bytes), the slots of every block a query lands
// in once (4*W1*B bytes per touched block), the queries once (4*W1*P2) and
// write the three outputs once (12*P2); its operations are
// ~W1*(log2 NB + log2 B + 2) int32 compares per query, far below the
// card's integer rate. What this design does about that bound: nothing
// yet. One thread walks one query through global memory (the fence
// directory stays L2-resident at the resolver's sizes), so every halving
// step is a dependent load and the kernel is latency-bound. Later work: a
// warp per query over a B = 32 block with a ballot, the fence directory's
// top levels in shared memory.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() of the
// launch. Offsets are int64(row) * stride + col: W1 * C can pass 2^31
// after the key width grows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Lexicographic compare of column `col` of the row-major (W1, ld_h) matrix
// h with query column p of the (W1, ld_q) matrix q; stops at the first
// differing word, which gives the same lt/eq as comparing all words.
__device__ __forceinline__ void lex_cmp(const int32_t* __restrict__ h,
                                        long long ld_h, long long col,
                                        const int32_t* __restrict__ q,
                                        long long ld_q, long long p, int W1,
                                        bool& lt, bool& eq) {
  lt = false;
  eq = true;
  for (int w = 0; w < W1; ++w) {
    const int32_t a = h[(long long)w * ld_h + col];
    const int32_t b = q[(long long)w * ld_q + p];
    if (a != b) {
      lt = a < b;
      eq = false;
      return;
    }
  }
}

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void probe_kernel(const int32_t* __restrict__ hkeys,
                             const int32_t* __restrict__ fences,
                             const int32_t* __restrict__ q,
                             int32_t* __restrict__ bid_out,
                             int32_t* __restrict__ lb_out,
                             int32_t* __restrict__ eq_out, int W1,
                             long long C, int NB, int B, long long P2) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P2) return;
  bool lt, eq;

  // Fence rank: #fences < key, then the last fence <= key.
  int pos = 0;
  for (int s = NB / 2; s >= 1; s >>= 1) {
    lex_cmp(fences, NB, pos + (s - 1), q, P2, p, W1, lt, eq);
    if (lt) pos += s;
  }
  lex_cmp(fences, NB, clamp_ll(pos, 0, NB - 1), q, P2, p, W1, lt, eq);
  const int bid = pos + (eq ? 1 : 0) - 1;

  // In-block rank, confined to the B slots of block clip(bid).
  const long long start = clamp_ll(bid, 0, NB - 1) * (long long)B;
  int bpos = 0;
  for (int s = B / 2; s >= 1; s >>= 1) {
    lex_cmp(hkeys, C, clamp_ll(start + bpos + (s - 1), 0, C - 1), q, P2, p,
            W1, lt, eq);
    if (lt) bpos += s;
  }
  lex_cmp(hkeys, C, clamp_ll(start + bpos, 0, C - 1), q, P2, p, W1, lt, eq);

  bid_out[p] = bid;
  lb_out[p] = bpos;
  eq_out[p] = eq ? 1 : 0;
}

}  // namespace

extern "C" int fdb_probe_ranks(const void* hkeys, const void* fences,
                               const void* q, void* bid, void* lb, void* eq,
                               int W1, long long C, int NB, int B,
                               long long P2, void* stream) {
  if (P2 <= 0) return 0;
  const int threads = 256;
  const long long blocks = (P2 + threads - 1) / threads;
  probe_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hkeys, (const int32_t*)fences, (const int32_t*)q,
      (int32_t*)bid, (int32_t*)lb, (int32_t*)eq, W1, C, NB, B, P2);
  return (int)cudaGetLastError();
}

extern "C" const char* fdb_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
