// Cols-wire unpack for Hopper (sm_90a): the coalesced wire blob of one
// chunk, window or segment (ops/synth_torch.py::cols_blob_layout) to the
// synthesis kernel's inputs: k int16 [B, nb, rows, cols] (rows-major,
// contiguous), vals int32 [B, nb] and, where the blob has its wrap
// section, wrap0 int32 [B, 2*cols-2].
//
// Replaces the device work the JAX package compiles with XLA around its
// synthesis (no Pallas kernel): libacm_tpu/ops/packing.py::unpack_columns,
// the 2-bit class-code expansion and transpose of
// libacm_tpu/ops/synth_jax.py::synth_pcm_cols and the little-endian
// reassembly of vals and wrap0 (synth_jax.py::_bytes_le). The plain
// version it is held to is the port's ops/synth_torch.py::
// unpack_cols_blob_plain (ops/packing.py::unpack_columns as tensor ops).
//
// What it computes. Columns are numbered in scan order (file, block,
// column), N = B*nb*cols. Column g has the class code c of its 2-bit field
// in the class map (ceil(cols/4) bytes a block; the codes past cols in a
// block's last byte are padding and belong to no column). For c in 1..3
// (family f = c-1) with a payload of at least 2 bytes and a non-empty
// width stream:
//   o   = number of earlier class-c columns (a prefix over the whole call)
//   w   = nib(o) + 1, nib(o) = nibble (o & 1) of wid_f[min(o >> 1, L-1)]
//   off = rows * sum_{o' < o} w(o') = rows * (o + NP(o)),
//         NP(o) = sum_{o' < o} nib(o')   (the clamp included: past the
//         stream's 2L nibbles nib alternates the last byte's two nibbles)
//   v_r = the w bits at bit off + r*w of the family's LSB-first stream,
//         read from the two little-endian uint16 words at bit >> 4 and
//         (bit >> 4) + 1, each index clamped to the last word, sign-extended.
// Every other column is zeros. Offsets are 64-bit: the plain version has no
// stream length limit.
//
// Three launches, each with a plain C entry below:
// * unpack_reduce_kernel — one CTA per tile of TC columns counts each
//   family's columns (tile totals); one CTA per tile of WT nibbles of a
//   width stream writes the nibbles' inclusive prefix inside the tile
//   (nploc) and the tile's total; a few CTAs turn vals and wrap0 from
//   bytes into int32 (the sections sit at any byte offset: byte loads).
// * unpack_scan_kernel — one CTA scans the tile totals of both kinds
//   (exclusive, in place): column-tile counts per family, width-tile sums
//   per family. So NP(o) = wsum[tile of o-1] + nploc[o-1] without a
//   global pass over the nibbles, and a column's ordinal is its tile's
//   prefix plus its rank inside the tile.
// * unpack_values_kernel — a CTA per (column tile, run of rows) ranks its
//   tile's columns again (a block scan of packed per-family counts),
//   computes o, w and off per column into shared memory, then writes its
//   values: one thread per value, consecutive threads on consecutive
//   columns of one row, so k's stores coalesce. Tiles of few columns
//   (level 0, short segments) are cut into runs of rows for enough CTAs.
//
// Bound: the wire is read and k (2 bytes a sample), vals and wrap0 are
// written once — bytes, about 2 B a sample over 3.35 TB/s. Each value
// costs four byte loads of the payload (L1 hits: a tile's columns lie in a
// few KB of stream) and a few 64-bit integer operations; the design keeps
// stores coalesced and every prefix out of device memory but the tile
// totals. Staging a tile's stream bytes in shared memory, or fusing the
// unpack into the synthesis kernel's staging so that k never reaches
// device memory, is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 1024;                // columns per tile
constexpr int THREADS = 256;            // threads of the reduce and value CTAs
constexpr int CPT = TC / THREADS;       // columns a thread ranks
constexpr int WT = 2048;                // nibbles per width tile
constexpr int NPT = WT / THREADS;       // nibbles a thread sums (4 bytes)
constexpr int SCAN_THREADS = 1024;
constexpr int FIELD = 21;               // bits per family in a packed count

// The blob's layout and the launch geometry (filled from the host's
// array of long longs; see geo_from).
struct Geo {
  long long off[9];  // section byte offsets: cls, pay4, pay8, pay16,
  long long len[9];  //   wid4, wid8, wid16, vals, wrap0; and sizes
  long long ncols;   // N = B*nb*cols
  int level, rows, stride;  // stride = ceil(cols/4)
  int nct;           // column tiles
  int present[3];    // family f has a payload of >= 2 bytes and widths
  int nwt[3];        // width tiles of family f (0 where absent)
  int wbase[3];      // family f's first width tile in wsum / nploc
  int nvals;         // B*nb
  int nwrap;         // B*(2*cols-2) where the blob has wrap0, else 0
  int nvw;           // CTAs of the vals / wrap0 conversion
  int rs;            // rows per value CTA
};

__device__ __forceinline__ int col_code(const uint8_t* __restrict__ blob,
                                        const Geo& g, long long col) {
  const long long blk = col >> g.level;
  const int c = (int)(col & ((1 << g.level) - 1));
  const uint8_t b = __ldg(blob + g.off[0] + blk * g.stride + (c >> 2));
  return (b >> ((c & 3) * 2)) & 3;
}

// Inclusive scan over the CTA (blockDim.x threads, a multiple of 32);
// `warp_tot` holds one entry per warp. Returns the thread's inclusive sum;
// *total gets the CTA's.
template <typename T>
__device__ T block_inclusive_scan(T x, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T t = lane < nwarps ? warp_tot[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x += warp_tot[warp - 1];
  *total = warp_tot[nwarps - 1];
  __syncthreads();  // warp_tot may be reused by the caller
  return x;
}

__device__ __forceinline__ int nib_at(const uint8_t* __restrict__ wid,
                                      long long L, long long o) {
  const long long byte = o >> 1 < L - 1 ? o >> 1 : L - 1;
  return (__ldg(wid + byte) >> ((o & 1) * 4)) & 15;
}

// NP(o): the sum of nib(o') over o' < o, the clamp past 2L included.
__device__ __forceinline__ long long nib_prefix(
    const Geo& g, int f, const uint8_t* __restrict__ wid,
    const long long* __restrict__ wsum, const int* __restrict__ nploc,
    long long o) {
  if (o == 0) return 0;
  const long long L = g.len[4 + f], nn = 2 * L;
  const long long j = (o <= nn ? o : nn) - 1;
  const long long base = (long long)g.wbase[f] * WT;
  long long np = wsum[g.wbase[f] + j / WT] + nploc[base + j];
  if (o > nn) {
    const int last = __ldg(wid + L - 1);
    const long long e = o - nn;
    np += (e >> 1) * ((last & 15) + (last >> 4)) + (e & 1) * (last & 15);
  }
  return np;
}

__global__ void __launch_bounds__(THREADS)
unpack_reduce_kernel(const uint8_t* __restrict__ blob, Geo g,
                     int* __restrict__ tcnt, long long* __restrict__ wsum,
                     int* __restrict__ nploc, int32_t* __restrict__ vals,
                     int32_t* __restrict__ wrap0) {
  __shared__ int warp_i[THREADS / 32];
  int b = blockIdx.x;
  if (b < g.nct) {
    // a column tile: class-c columns per family
    const long long c0 = (long long)b * TC;
    int n[3] = {0, 0, 0};
    for (int i = threadIdx.x; i < TC; i += THREADS) {
      if (c0 + i < g.ncols) {
        const int code = col_code(blob, g, c0 + i);
        n[0] += code == 1;
        n[1] += code == 2;
        n[2] += code == 3;
      }
    }
    for (int f = 0; f < 3; ++f) {
      int tot;
      block_inclusive_scan<int>(n[f], warp_i, &tot);
      if (threadIdx.x == 0) tcnt[f * g.nct + b] = tot;
    }
    return;
  }
  b -= g.nct;
  const int nwt_all = g.nwt[0] + g.nwt[1] + g.nwt[2];
  if (b < nwt_all) {
    // a width tile: in-tile inclusive prefix of the nibbles, and its total
    const int f = b < g.nwt[0] ? 0 : b < g.nwt[0] + g.nwt[1] ? 1 : 2;
    const int j = b - g.wbase[f];
    const uint8_t* wid = blob + g.off[4 + f];
    const long long L = g.len[4 + f];
    const long long byte0 = (long long)j * (WT / 2) + threadIdx.x * (NPT / 2);
    int nib[NPT];
    int s = 0;
#pragma unroll
    for (int q = 0; q < NPT / 2; ++q) {
      const int v = byte0 + q < L ? __ldg(wid + byte0 + q) : 0;
      nib[2 * q] = v & 15;
      nib[2 * q + 1] = v >> 4;
      s += (v & 15) + (v >> 4);
    }
    int tot;
    int run = block_inclusive_scan<int>(s, warp_i, &tot) - s;
    int* out = nploc + (long long)b * WT + threadIdx.x * NPT;
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      run += nib[q];
      out[q] = run;
    }
    if (threadIdx.x == 0) wsum[b] = tot;
    return;
  }
  b -= nwt_all;
  // vals (little-endian uint16) and wrap0 (little-endian int32)
  const uint8_t* pv = blob + g.off[7];
  const uint8_t* pw = blob + g.off[8];
  for (long long i = (long long)b * THREADS + threadIdx.x;
       i < (long long)g.nvals + g.nwrap; i += (long long)g.nvw * THREADS) {
    if (i < g.nvals) {
      vals[i] = (int32_t)(__ldg(pv + 2 * i) | (__ldg(pv + 2 * i + 1) << 8));
    } else {
      const long long w = i - g.nvals;
      const uint32_t u = (uint32_t)__ldg(pw + 4 * w)
                         | ((uint32_t)__ldg(pw + 4 * w + 1) << 8)
                         | ((uint32_t)__ldg(pw + 4 * w + 2) << 16)
                         | ((uint32_t)__ldg(pw + 4 * w + 3) << 24);
      wrap0[w] = (int32_t)u;
    }
  }
}

// Exclusive scan, in place, of n values of T with one CTA.
template <typename T>
__device__ void cta_exclusive_scan(T* a, int n, T* warp_tot) {
  T carry = 0;
  for (int s = 0; s < n; s += SCAN_THREADS) {
    const int i = s + threadIdx.x;
    const T x = i < n ? a[i] : T(0);
    T tot;
    const T inc = block_inclusive_scan<T>(x, warp_tot, &tot);
    if (i < n) a[i] = carry + inc - x;
    carry += tot;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
unpack_scan_kernel(Geo g, int* __restrict__ tcnt, long long* __restrict__ wsum) {
  __shared__ int warp_i[SCAN_THREADS / 32];
  __shared__ long long warp_l[SCAN_THREADS / 32];
  for (int f = 0; f < 3; ++f) {
    cta_exclusive_scan<int>(tcnt + f * g.nct, g.nct, warp_i);
    cta_exclusive_scan<long long>(wsum + g.wbase[f], g.nwt[f], warp_l);
  }
}

__global__ void __launch_bounds__(THREADS)
unpack_values_kernel(const uint8_t* __restrict__ blob, Geo g,
                     const int* __restrict__ tcnt,
                     const long long* __restrict__ wsum,
                     const int* __restrict__ nploc, int16_t* __restrict__ k) {
  __shared__ long long s_off[TC];
  __shared__ uint8_t s_w[TC];
  __shared__ uint8_t s_f[TC];
  __shared__ unsigned long long warp_u[THREADS / 32];
  const int t = blockIdx.x;
  const long long c0 = (long long)t * TC;
  const int ncol = (int)(g.ncols - c0 < TC ? g.ncols - c0 : TC);

  // rank this tile's columns per family: packed counts, FIELD bits each
  int code[CPT];
  unsigned long long mine = 0;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int lc = threadIdx.x * CPT + q;
    code[q] = lc < ncol ? col_code(blob, g, c0 + lc) : 0;
    if (code[q]) mine += 1ull << (FIELD * (code[q] - 1));
  }
  unsigned long long tot;
  unsigned long long rank =
      block_inclusive_scan<unsigned long long>(mine, warp_u, &tot) - mine;
  const unsigned long long fmask = (1ull << FIELD) - 1;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int lc = threadIdx.x * CPT + q;
    const int c = code[q];
    uint8_t w = 0;
    if (c && g.present[c - 1]) {
      const int f = c - 1;
      const long long o = (long long)tcnt[f * g.nct + t]
                          + (long long)((rank >> (FIELD * f)) & fmask);
      const uint8_t* wid = blob + g.off[4 + f];
      w = (uint8_t)(nib_at(wid, g.len[4 + f], o) + 1);
      s_off[lc] = (long long)g.rows * (o + nib_prefix(g, f, wid, wsum, nploc, o));
      s_f[lc] = (uint8_t)f;
    }
    if (lc < TC) s_w[lc] = w;
    if (c) rank += 1ull << (FIELD * (c - 1));
  }
  __syncthreads();

  // the values of rows [r0, r0 + nr): consecutive threads on consecutive
  // columns of one row of one block (cw columns a run)
  const int r0 = blockIdx.y * g.rs;
  const int nr = g.rows - r0 < g.rs ? g.rows - r0 : g.rs;
  const int lcw = g.level < 10 ? g.level : 10;  // log2(min(cols, TC))
  const int cw = 1 << lcw;
  const int cmask = (1 << g.level) - 1;
  const int total = ncol * nr;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int seg = idx >> lcw;
    const int blkl = seg / nr;
    const int r = r0 + (seg - blkl * nr);
    const int lc = (blkl << lcw) + (idx & (cw - 1));
    const long long col = c0 + lc;
    const long long out = ((((col >> g.level) * g.rows) + r) << g.level)
                          + (col & cmask);
    const int w = s_w[lc];
    int v = 0;
    if (w) {
      const int f = s_f[lc];
      const uint8_t* pay = blob + g.off[1 + f];
      const long long nh = g.len[1 + f] >> 1;
      const long long bit = s_off[lc] + (long long)r * w;
      const long long q = bit >> 4;
      const long long i0 = q < nh - 1 ? q : nh - 1;
      const long long i1 = q + 1 < nh - 1 ? q + 1 : nh - 1;
      const uint32_t h0 = __ldg(pay + 2 * i0) | (__ldg(pay + 2 * i0 + 1) << 8);
      const uint32_t h1 = __ldg(pay + 2 * i1) | (__ldg(pay + 2 * i1 + 1) << 8);
      const uint32_t win = h0 | (h1 << 16);
      const uint32_t u = (win >> (bit & 15)) & ((1u << w) - 1);
      const uint32_t sign = 1u << (w - 1);
      v = (int)(u ^ sign) - (int)sign;
    }
    k[out] = (int16_t)v;
  }
}

Geo geo_from(const long long* a) {
  Geo g;
  for (int i = 0; i < 9; ++i) g.off[i] = a[i];
  for (int i = 0; i < 9; ++i) g.len[i] = a[9 + i];
  g.ncols = a[18];
  g.level = (int)a[19];
  g.rows = (int)a[20];
  g.stride = (int)a[21];
  g.nct = (int)a[22];
  for (int f = 0; f < 3; ++f) {
    g.present[f] = (int)a[23 + f];
    g.nwt[f] = (int)a[26 + f];
    g.wbase[f] = (int)a[29 + f];
  }
  g.nvals = (int)a[32];
  g.nwrap = (int)a[33];
  g.nvw = (int)a[34];
  g.rs = (int)a[35];
  return g;
}

}  // namespace

extern "C" {

// The geometry array `geo` (36 long longs, host memory) is laid out as
// geo_from reads it; ops/unpack_cuda.py::geometry builds it. Each entry
// returns cudaGetLastError() after its launch (0 on success).

int acm_unpack_reduce(const void* blob, const long long* geo, void* tcnt,
                      void* wsum, void* nploc, void* vals, void* wrap0,
                      void* stream) {
  const Geo g = geo_from(geo);
  const int grid = g.nct + g.nwt[0] + g.nwt[1] + g.nwt[2] + g.nvw;
  unpack_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blob, g, (int*)tcnt, (long long*)wsum, (int*)nploc,
      (int32_t*)vals, (int32_t*)wrap0);
  return (int)cudaGetLastError();
}

int acm_unpack_scan(const long long* geo, void* tcnt, void* wsum,
                    void* stream) {
  const Geo g = geo_from(geo);
  unpack_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      g, (int*)tcnt, (long long*)wsum);
  return (int)cudaGetLastError();
}

int acm_unpack_values(const void* blob, const long long* geo,
                      const void* tcnt, const void* wsum, const void* nploc,
                      void* k, void* stream) {
  const Geo g = geo_from(geo);
  const dim3 grid(g.nct, (g.rows + g.rs - 1) / g.rs);
  unpack_values_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blob, g, (const int*)tcnt, (const long long*)wsum,
      (const int*)nploc, (int16_t*)k);
  return (int)cudaGetLastError();
}

}  // extern "C"
