// Width-class block unpack for Hopper (sm_90a): the dense route's packed
// coefficients (ops/packing.py::pack_blocks) back to k int16
// [nb, rows, cols], in one launch for all three classes.
//
// Replaces the device work the JAX package compiles with XLA for
// libacm_tpu/ops/packing.py::unpack_blocks (no Pallas kernel): the nibble
// expansion and the three scatters. The plain version it is held to is the
// port's ops/packing.py::unpack_blocks_plain.
//
// What it computes. With n = rows*cols words a block: p4 int8
// [n4, ceil(n/2)] holds two sign-extended nibbles a byte (word 2i in the
// low nibble of byte i, word 2i+1 in the high one; the last high nibble of
// an odd n is dropped), p8 int8 [n8, n] and p16 int16 [n16, n] one value a
// word. Packed row i of a class is block idx[i] of the output. An idx
// outside [0, nb) names no block (pack_blocks pads with idx == nb) and is
// skipped; blocks no list names keep the zeros the wrapper fills the
// output with.
//
// Design: the packed rows of the three classes are numbered one after the
// other (4-bit, 8-bit, 16-bit) and each is cut into parts of `chunk`
// words (ops/unpack_blocks_cuda.py::CHUNK, 8,192: four groups of 8 words a
// thread); CTA c takes part c % splits of packed row c / splits, so a
// block of up to 524,288 words (15/16) is spread over many CTAs and a
// CTA's range never crosses a block. A thread makes 8 consecutive words
// and writes them as one 16-byte store; the up to 7 words before the first
// 16-byte boundary of the range and after the last are written one by
// one. Input words come as one 16-, 8- or 4-byte load where the input is
// aligned with the output, else one by one.
//
// Bound: the packed rows are read and the output (2 bytes a word) written
// once, the fill included — bytes, over 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// word w of a packed row of class c (0: nibbles, 1: int8, 2: int16)
__device__ __forceinline__ int value(int c, const void* row, long long w) {
  if (c == 2) return ((const int16_t*)row)[w];
  if (c == 1) return ((const int8_t*)row)[w];
  const int b = ((const int8_t*)row)[w >> 1];
  return (w & 1) ? (b >> 4) : ((int)((uint32_t)b << 28) >> 28);
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// words w..w+7 of a packed row, packed two a 32-bit word
__device__ __forceinline__ uint4 load8(int c, const void* row, long long w) {
  int v[8];
  if (c == 2) {
    const int16_t* p = (const int16_t*)row + w;
    if (((uintptr_t)p & 15) == 0) return __ldg((const uint4*)p);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[j];
  } else if (c == 1) {
    const int8_t* p = (const int8_t*)row + w;
    if (((uintptr_t)p & 7) == 0) {
      const uint2 x = __ldg((const uint2*)p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (int)(x.x << (24 - 8 * j)) >> 24;
        v[4 + j] = (int)(x.y << (24 - 8 * j)) >> 24;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = p[j];
    }
  } else {
    const int8_t* p = (const int8_t*)row + (w >> 1);
    if ((w & 1) == 0 && ((uintptr_t)p & 3) == 0) {
      const uint32_t x = __ldg((const uint32_t*)p);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (int)(x << (28 - 4 * j)) >> 28;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = value(0, row, w + j);
    }
  }
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__global__ void __launch_bounds__(THREADS)
unpack_blocks_kernel(const int8_t* p4, const int8_t* p8, const int16_t* p16,
                     const int32_t* idx4, const int32_t* idx8,
                     const int32_t* idx16, int16_t* out, long long n4,
                     long long n8, long long nb, long long n, long long chunk,
                     long long splits) {
  const int tid = threadIdx.x;
  const long long r = blockIdx.x / splits;
  const long long part = blockIdx.x - r * splits;
  int c;
  long long i;
  const void* row;
  int32_t idx;
  if (r < n4) {
    c = 0, i = r;
    idx = idx4[i];
    row = p4 + i * ((n + 1) >> 1);
  } else if (r < n4 + n8) {
    c = 1, i = r - n4;
    idx = idx8[i];
    row = p8 + i * n;
  } else {
    c = 2, i = r - n4 - n8;
    idx = idx16[i];
    row = p16 + i * n;
  }
  if (idx < 0 || idx >= nb) return;  // padding (idx == nb), or no block
  int16_t* orow = out + (long long)idx * n;
  const long long w0 = part * chunk;
  const long long w1 = w0 + chunk < n ? w0 + chunk : n;
  // [w0, wa) and [wb, w1) one word at a time; [wa, wb) in 16-byte stores
  long long wa = w0 + ((16 - ((uintptr_t)(orow + w0) & 15)) & 15) / 2;
  if (wa > w1) wa = w1;
  const long long groups = (w1 - wa) >> 3;
  const long long wb = wa + 8 * groups;
  if (tid < wa - w0) orow[w0 + tid] = (int16_t)value(c, row, w0 + tid);
  if (tid < w1 - wb) orow[wb + tid] = (int16_t)value(c, row, wb + tid);
  for (long long g = tid; g < groups; g += THREADS) {
    const long long w = wa + 8 * g;
    *(uint4*)(orow + w) = load8(c, row, w);
  }
}

}  // namespace

extern "C" {

// Pointers are device memory (a class with no rows may pass null);
// `splits` parts of `chunk` words a packed row (a multiple of 8), `grid` =
// (n4 + n8 + n16) * splits CTAs.
// Returns cudaGetLastError() after the launch (0 on success).
int acm_unpack_blocks(const void* p4, const void* p8, const void* p16,
                      const void* idx4, const void* idx8, const void* idx16,
                      void* out, long long n4, long long n8, long long nb,
                      long long n, long long chunk, long long splits,
                      long long grid, void* stream) {
  unpack_blocks_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)p4, (const int8_t*)p8, (const int16_t*)p16,
      (const int32_t*)idx4, (const int32_t*)idx8, (const int32_t*)idx16,
      (int16_t*)out, n4, n8, nb, n, chunk, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
