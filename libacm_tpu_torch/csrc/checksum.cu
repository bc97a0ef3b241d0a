// Masked content digest for Hopper (sm_90a): DeviceCorpus.checksum()'s
// sum over the decoded PCM of one device, in one launch.
//
// Replaces the device work the JAX package compiles with XLA for its
// checksum (no Pallas kernel): libacm_tpu/parallel/corpus.py::_sum_all.
// The plain version it is held to is the port's ops/checksum_cuda.py::
// sum_all_plain (the masked int64 sum of the chunks, as torch ops).
//
// What it computes. A chunk's PCM is int16 [B, nb, L] (L = rows*cols,
// contiguous) and row j counts ng[j] = min(n_good_j, nb) good blocks: the
// digest sums the first ng[j]*L words of each row, over every chunk of the
// device, modulo 2^32. Those words are one contiguous span per row, so the
// host hands the kernel a table of spans (ops/checksum_cuda.py::plan),
// rows with ng = 0 left out. Each value is sign-extended and added in
// uint32 with wrap: the JAX package's wrapped int32 sum, and the port's
// int64 sum & 0xFFFFFFFF, modulo 2^32.
//
// Table (int64, copied to the device once a call): word 0 is the
// accumulator, 0 as copied, so the call needs no memset; then four words a
// span: address (bytes), words n, head words h, first tile. h < 8 words
// take the span to a 16-byte boundary (min(h, n)); the body is
// nvec = (n - h) >> 3 vectors of 8 words; the tail is the n - h - 8*nvec
// words after it. A span's body is cut into tiles of TILE_VECS vectors (at
// least one tile a span, so that a span of head and tail alone is seen);
// the first tile of a span also sums its head and the last its tail.
//
// Design: CTAs walk the tiles grid-strided, each thread keeps its sum in
// a register through all of them (UNROLL independent 16-byte loads in
// flight a step), then a warp-shuffle and shared-memory reduction and one
// atomic a CTA into word 0. A tile finds its span by a binary search of
// the table's first tiles. The launch asks for a few CTAs a SM, not one a
// tile, so the atomics stay few.
//
// Bound: every PCM word of the spans is read once (2 bytes) — bytes, over
// 3.35 TB/s; two integer additions a word are far below the ALU rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long TILE_VECS = 4096;  // 32,768 words, 64 KB a tile

__device__ __forceinline__ int sum2(uint32_t w) {
  return (int)(int16_t)(w & 0xFFFFu) + ((int)w >> 16);
}

__device__ __forceinline__ uint32_t sum8(uint4 x) {
  return (uint32_t)(sum2(x.x) + sum2(x.y) + sum2(x.z) + sum2(x.w));
}

__global__ void __launch_bounds__(THREADS)
checksum_kernel(long long* tab, int nspans, long long ntiles) {
  const int tid = threadIdx.x;
  uint32_t acc = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // the span of tile t: the last span whose first tile is <= t
    int lo = 0, hi = nspans - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab[1 + 4 * mid + 3] <= t) lo = mid; else hi = mid - 1;
    }
    const long long* sp = tab + 1 + 4 * lo;
    const int16_t* p = (const int16_t*)(uintptr_t)sp[0];
    const long long n = sp[1], head = sp[2], t0 = sp[3];
    const long long t_end = lo + 1 < nspans ? tab[1 + 4 * (lo + 1) + 3]
                                            : ntiles;
    const long long nvec = (n - head) >> 3;
    const long long v0 = (t - t0) * TILE_VECS;
    const long long v1 = v0 + TILE_VECS < nvec ? v0 + TILE_VECS : nvec;
    const uint4* body = (const uint4*)(p + head);
    for (long long v = v0 + tid; v < v1; v += THREADS * UNROLL) {
      uint4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = v + (long long)u * THREADS;
        x[u] = i < v1 ? __ldg(body + i) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc += sum8(x[u]);
    }
    if (t == t0 && tid < head) acc += (uint32_t)(int)p[tid];
    if (t == t_end - 1) {
      const long long tail0 = head + 8 * nvec;
      if (tid < n - tail0) acc += (uint32_t)(int)p[tail0 + tid];
    }
  }
  // the CTA's sum: across each warp, then across the warps, one atomic
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  __shared__ uint32_t warp_sum[THREADS / 32];
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    acc = tid < THREADS / 32 ? warp_sum[tid] : 0;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
    if (tid == 0) atomicAdd((unsigned int*)tab, acc);
  }
}

}  // namespace

extern "C" {

// `tab` is the table on the device (word 0 the accumulator, as above),
// `nspans` its spans, `ntiles` their tiles, `grid` the CTAs. Returns
// cudaGetLastError() after the launch (0 on success).
int acm_checksum(void* tab, int nspans, long long ntiles, int grid,
                 void* stream) {
  checksum_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (long long*)tab, nspans, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
