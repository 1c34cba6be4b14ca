// Helpers that block.cu and compact.cu share: int32 arithmetic as XLA's,
// tpu.py's gather and scatter index rules, warp and block prefix sums, a
// grid-stride loop over a cooperative grid, and the launch of one
// cooperative grid on the caller's stream.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdb {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInf = INT32_MAX;      // pad key word, pad length
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);  // int32 wrap, as XLA's
}

// A gather index as tpu.py's gathers take it: a negative index wraps
// once, then the index clamps into [0, n).
__device__ __forceinline__ long long gat(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// A scatter index as tpu.py's scatters take it: a negative index wraps
// once; -1 where the update drops.
__device__ __forceinline__ long long sct(long long i, long long n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// A load of what another block of the grid may have written before the
// last grid barrier (past L1).
__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldcg(p); }

__device__ __forceinline__ int32_t warp_incl(int32_t v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = add32(v, t);
  }
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v = add32(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Exclusive prefixes of K values a thread over the block (every thread
// calls it): ex[c] gets value c's prefix, tot[c] its block sum. ws holds
// K * kWarps words of shared memory.
template <int K>
__device__ void block_excl_k(const int32_t* v, int32_t* ex, int32_t* tot,
                             int32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc[K];
  for (int c = 0; c < K; ++c) {
    inc[c] = warp_incl(v[c]);
    if (lane == 31) ws[c * kWarps + warp] = inc[c];
  }
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < K; ++c) {
      int32_t w = lane < kWarps ? ws[c * kWarps + lane] : 0;
      w = warp_incl(w);
      if (lane < kWarps) ws[c * kWarps + lane] = w;
    }
  }
  __syncthreads();
  for (int c = 0; c < K; ++c) {
    const int32_t before = warp ? ws[c * kWarps + warp - 1] : 0;
    tot[c] = ws[c * kWarps + kWarps - 1];
    ex[c] = add32(before, inc[c] - v[c]);
  }
  __syncthreads();  // ws is free for the next call
}

// Exclusive prefix of one value a thread over the block; ws holds kWarps
// words of shared memory; *total gets the sum.
__device__ __forceinline__ int32_t block_excl(int32_t v, int32_t* ws,
                                              int32_t* total) {
  int32_t ex;
  block_excl_k<1>(&v, &ex, total, ws);
  return ex;
}

struct Grid {
  long long first, stride;
  __device__ Grid()
      : first((long long)blockIdx.x * blockDim.x + threadIdx.x),
        stride((long long)gridDim.x * blockDim.x) {}
  template <class F> __device__ void each(long long n, F f) const {
    for (long long i = first; i < n; i += stride) f(i);
  }
  __device__ void sync() const { cg::this_grid().sync(); }
  __device__ bool leader() const { return first == 0; }
};

// One cooperative grid of `kernel` on `stream`: enough blocks for `work`
// threads, at most every block resident at once.
template <class A>
int launch(void (*kernel)(A), long long work, size_t smem, A* args,
           void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  const int blocks = (int)(want < 1 ? 1 : (want < most ? want : most));
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(kThreads), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace fdb
