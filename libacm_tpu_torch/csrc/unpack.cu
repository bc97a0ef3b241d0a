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
// Design: one launch a call (unpack_kernel), every CTA one tile.
// * Tickets. A CTA takes its tile from an atomic ticket, not blockIdx, so
//   it only ever waits on tiles whose CTAs are already running: forward
//   progress whatever the scheduler does. The lowest tickets are the width
//   tiles (WT nibbles of one family's width stream), then the column tiles,
//   then a few CTAs that turn vals and wrap0 from bytes into int32.
// * Decoupled look-back (Merrill & Garland, NVIDIA NVR-2016-002). A width
//   tile publishes its nibble sum, a column tile its count of class-f
//   columns per family, each as a status word (epoch, flag aggregate or
//   inclusive, value); one warp then sums its predecessors' words back to
//   the nearest inclusive one and publishes its own inclusive prefix.
//   Status words are single relaxed gpu-scope accesses (see ld_status).
//   They need no reset: each call on a stream gets a new
//   epoch (ops/unpack_cuda.py keeps one scratch buffer per device and
//   stream) and a word of another epoch reads as not ready, so a call is
//   one kernel and no memset. The ticket counter runs on across calls; the
//   host passes the count of tickets it has handed out before.
// * The width prefix. A column's width depends on its global ordinal, so a
//   column tile first resolves o0, its first ordinal per family, then NP(o0)
//   as the inclusive prefix of the width tile before the one that holds o0
//   plus the nibbles before o0 inside that tile (at most WT/2 bytes), plus
//   the clamp term past 2L. Its own columns get their offsets from a block
//   scan of their widths. Ranks and widths are scanned as three 21-bit
//   fields of one 64-bit word.
// * Staging. A tile's class-f columns occupy one contiguous bit span of
//   family f's stream. Each span is copied to shared memory with 16-byte
//   cp.async from a 16-byte-aligned address (rounded down; the bytes around
//   it are never used), issued before the per-column table is built so
//   that the two overlap. Stream bytes past the payload's end are filled
//   with its last word's bytes, which is what the clamped word reads give.
//   A value is read as two aligned 32-bit shared loads and a funnel shift.
// * Tiles are sized by values: tc = 2^ltc columns (ops/unpack_cuda.py::
//   tile_columns) of at most about TILE_VALUES values, so a worst-case span
//   (16 bits a value) fits the shared memory the launch asks for. Offsets
//   inside a tile are 32-bit; tile bases 64-bit.
// * Stores. Each thread makes 8 consecutive elements of the tile's flat k
//   run from the per-column table ((shared bit offset << 5) | width) and
//   stores them as one 16-byte vector. For cols >= 8 that is 8 columns of
//   one row; at cols < 8 it walks rows of one column or a few, with
//   scalar stores at the two ends of a tile that are not 16-byte aligned.
//
// Bound: the wire is read and k (2 bytes a sample), vals and wrap0 are
// written once — bytes, about 2 B a sample over 3.35 TB/s. The design cuts
// the per-value work to a handful of 32-bit operations and shared loads,
// keeps every prefix out of device memory but one status word a tile and
// family, and writes k in 16-byte stores. Fusing the unpack into the
// synthesis kernel's staging, so that k never reaches device memory, is
// later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;            // threads a CTA
constexpr int WT = 2048;                // nibbles per width tile
constexpr int NPT = WT / THREADS;       // nibbles a thread sums (4 bytes)
constexpr int TC_MAX = 2048;            // columns per tile, at most
constexpr int CPT = TC_MAX / THREADS;   // columns a thread ranks
constexpr int FIELD = 21;               // bits per family in a packed sum
constexpr int VBITS = 38;               // status word: value bits,
constexpr int EPOCH_SHIFT = 40;         //   flag bits 38-39, epoch 40-63
constexpr u64 VMASK = (1ull << VBITS) - 1;
constexpr int F_AGG = 1, F_INC = 2;     // aggregate, inclusive prefix

#ifdef UNPACK_PROFILE
// Opt-in phase trace (nvcc -DUNPACK_PROFILE; tools/torch_unpack_probe.py
// builds and reads it): thread 0 of each of the first 4096 column tiles
// writes the clock64() cycles of each step. Slots: 0 the ticket, 1 the
// class codes and their ranks, 2 the look-back, 3 the loads on o0 and
// their scans, 4 the spans, 5 the table, the copies and the clamp fill,
// 6 the values and stores; 7 the part of slot 3 spent waiting for family
// 0's width prefix.
__device__ long long unpack_prof[4096][8];
#define PROF_START() long long prof_t = clock64()
#define PROF(slot)                                        \
  do {                                                    \
    if (threadIdx.x == 0 && t < 4096) {                   \
      const long long now = clock64();                    \
      unpack_prof[t][slot] = now - prof_t;                \
      prof_t = now;                                       \
    }                                                     \
  } while (0)
#else
#define PROF_START()
#define PROF(slot)
#endif

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
  int wbase[3];      // family f's first width tile
  int nvals;         // B*nb
  int nwrap;         // B*(2*cols-2) where the blob has wrap0, else 0
  int nvw;           // CTAs of the vals / wrap0 conversion
  int ltc;           // log2 of the columns per tile
  int span;          // bytes of shared memory for the staged spans
  u64 magic;         // ceil(2^32 / rows): q / rows = (q * magic) >> 32
  u64 epoch;         // this call's status-word epoch (1 .. 2^24-1)
  unsigned ticket0;  // tickets handed out on this scratch before the call
};

// Status words are read and written as relaxed gpu-scope (strong, L2)
// operations: a word is the whole message (epoch, flag and value in one
// aligned 64-bit access), so no ordering with other data is needed, and
// no acquire invalidates the SM's L1 under the other tiles' loads.
__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

__device__ __forceinline__ u64 status(u64 epoch, int flag, u64 v) {
  return (epoch << EPOCH_SHIFT) | ((u64)flag << VBITS) | v;
}

// The word at p once it holds this epoch with a flag of at least `need`.
__device__ __forceinline__ u64 wait_status(const u64* p, u64 epoch,
                                           int need) {
  u64 w;
  do {
    w = ld_status(p);
  } while ((w >> EPOCH_SHIFT) != epoch || (int)((w >> VBITS) & 3) < need);
  return w;
}

// Exclusive prefix of chain entry idx over the status words [lo, idx): one
// warp reads 32 predecessors at a time, nearest first, and sums them back
// to the nearest inclusive word (its own value included). All lanes of the
// calling warp must call; every lane returns the sum.
__device__ long long lookback(const u64* st, long long lo, long long idx,
                              u64 epoch) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long end = idx; end > lo; end -= 32) {
    const long long p = end - 1 - lane;
    int flag = F_INC;
    long long v = 0;
    if (p >= lo) {
      const u64 w = wait_status(st + p, epoch, F_AGG);
      flag = (int)((w >> VBITS) & 3);
      v = (long long)(w & VMASK);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, flag == F_INC);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    if (lane > stop) v = 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (inc) break;
  }
  return excl;
}

// Inclusive scan over the CTA (THREADS threads); `warp_tot` holds one entry
// per warp. Returns the thread's inclusive sum; *total gets the CTA's.
template <typename T>
__device__ T block_inclusive_scan(T x, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = THREADS / 32;
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

// Two inclusive scans over the CTA at once (one set of barriers):
// `warp_tot` holds two entries per warp.
__device__ void block_inclusive_scan2(u64& x, u64& y, u64* warp_tot,
                                      u64* xtot, u64* ytot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = THREADS / 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 a = __shfl_up_sync(0xffffffffu, x, d);
    const u64 b = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) x += a, y += b;
  }
  if (lane == 31) warp_tot[warp] = x, warp_tot[nwarps + warp] = y;
  __syncthreads();
  if (warp == 0) {
    u64 a = lane < nwarps ? warp_tot[lane] : 0;
    u64 b = lane < nwarps ? warp_tot[nwarps + lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 a2 = __shfl_up_sync(0xffffffffu, a, d);
      const u64 b2 = __shfl_up_sync(0xffffffffu, b, d);
      if (lane >= d) a += a2, b += b2;
    }
    if (lane < nwarps) warp_tot[lane] = a, warp_tot[nwarps + lane] = b;
  }
  __syncthreads();
  if (warp > 0) x += warp_tot[warp - 1], y += warp_tot[nwarps + warp - 1];
  *xtot = warp_tot[nwarps - 1];
  *ytot = warp_tot[2 * nwarps - 1];
  __syncthreads();  // warp_tot may be reused by the caller
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// One value from the staged spans: table entry (shared bit << 5) | w, row r.
__device__ __forceinline__ int value_at(const uint32_t* __restrict__ s32,
                                        uint32_t ent, int r) {
  const uint32_t w = ent & 31;
  const uint32_t s = (ent >> 5) + (uint32_t)r * w;
  const uint32_t win = __funnelshift_r(s32[s >> 5], s32[(s >> 5) + 1], s);
  const uint32_t sh = (32 - w) & 31;
  const int v = (int)(win << sh) >> sh;
  return w ? v : 0;
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// A width tile: the sum of its nibbles, published and then resolved to
// the inclusive prefix of its family's width stream.
__device__ void width_tile(const uint8_t* __restrict__ blob, const Geo& g,
                           u64* __restrict__ st, int b, u64* warp_u) {
  const int f = b < g.nwt[0] ? 0 : b < g.nwt[0] + g.nwt[1] ? 1 : 2;
  const int j = b - g.wbase[f];
  const uint8_t* wid = blob + g.off[4 + f];
  const long long L = g.len[4 + f];
  const long long byte0 = (long long)j * (WT / 2) + threadIdx.x * (NPT / 2);
  u64 s = 0;
#pragma unroll
  for (int q = 0; q < NPT / 2; ++q) {
    const int v = byte0 + q < L ? __ldg(wid + byte0 + q) : 0;
    s += (v & 15) + (v >> 4);
  }
  u64 tot;
  block_inclusive_scan<u64>(s, warp_u, &tot);
  u64* mine = st + b;
  if (threadIdx.x == 0)
    st_status(mine, status(g.epoch, j ? F_AGG : F_INC, tot));
  if (j && threadIdx.x < 32) {
    const long long ex = lookback(st, g.wbase[f], b, g.epoch);
    if (threadIdx.x == 0)
      st_status(mine, status(g.epoch, F_INC, (u64)ex + tot));
  }
}

// A column tile: ranks, look-back, NP at o0, staging, table, values. The
// steps that wait on device memory are few and each issues its loads
// together: the ticket; the class codes; the look-back (one warp a
// family); the width nibbles of the tile's columns, the nibbles before o0
// in o0's width tile and that tile's predecessor's status; the staging.
__device__ void column_tile(const uint8_t* __restrict__ blob, const Geo& g,
                            u64* __restrict__ st, int t,
                            int16_t* __restrict__ k, uint8_t* smem,
                            u64* warp_u) {
  __shared__ long long s_o0[3], s_np[3], s_start[3], s_a[3];
  __shared__ int s_sbase[3], s_blen[3], s_nchunk[3], s_fill[3];
  __shared__ uint32_t s_hlast[3], s_wlast[3];
  const int nwt_all = g.nwt[0] + g.nwt[1] + g.nwt[2];
  u64* cst = st + nwt_all;  // column status words: [f * nct + t]
  uint32_t* tab = (uint32_t*)(smem + g.span);
  const uint32_t* s32 = (const uint32_t*)smem;
  const int tc = 1 << g.ltc;
  const long long c0 = (long long)t << g.ltc;
  const int ncol = (int)(g.ncols - c0 < tc ? g.ncols - c0 : tc);
  const u64 fmask = (1ull << FIELD) - 1;
  PROF_START();

  // 1. the class codes (2 bits a column, packed) and their packed ranks;
  // the payload's last word and the width stream's last byte on the side
  if (threadIdx.x < 3 && g.present[threadIdx.x]) {
    const int f = threadIdx.x;
    const uint8_t* pay = blob + g.off[1 + f] + g.len[1 + f];
    s_hlast[f] = __ldg(pay - 2) | (__ldg(pay - 1) << 8);
    s_wlast[f] = __ldg(blob + g.off[4 + f] + g.len[4 + f] - 1);
  }
  // (every load issued before any is used, so that they overlap)
  const int cmask = (1 << g.level) - 1;
  uint8_t cb[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int lc = threadIdx.x * CPT + q;
    const long long col = c0 + lc;
    cb[q] = lc < ncol ? __ldg(blob + g.off[0] + (col >> g.level) * g.stride
                             + ((col & cmask) >> 2))
                      : 0;
  }
  uint32_t codes = 0;
  u64 mine = 0;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int lc = threadIdx.x * CPT + q;
    const int c = lc < ncol ? (cb[q] >> ((((c0 + lc) & cmask) & 3) * 2)) & 3 : 0;
    codes |= (uint32_t)c << (2 * q);
    if (c) mine += 1ull << (FIELD * (c - 1));
  }
  u64 tot;
  u64 rank = block_inclusive_scan<u64>(mine, warp_u, &tot) - mine;

  PROF(1);

  // 2. publish the tile's counts; one warp a family looks back for o0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 3 && g.present[warp]) {
    const int f = warp;
    const long long lo = (long long)f * g.nct;
    const u64 n = (tot >> (FIELD * f)) & fmask;
    if (lane == 0)
      st_status(cst + lo + t, status(g.epoch, t ? F_AGG : F_INC, n));
    const long long o0 = t ? lookback(cst, lo, lo + t, g.epoch) : 0;
    if (lane == 0) {
      s_o0[f] = o0;
      if (t) st_status(cst + lo + t, status(g.epoch, F_INC, (u64)o0 + n));
    }
  }
  __syncthreads();
  PROF(2);

  // 3. loads that need o0 only, issued together: the widths of this
  // thread's columns, the nibbles before o0 inside o0's width tile, and
  // (threads 0-2) the inclusive prefix of the width tile before it
  // (per-family values by select, not by an index into the parameters)
  const uint8_t* wid0 = blob + g.off[4];
  const uint8_t* wid1 = blob + g.off[5];
  const uint8_t* wid2 = blob + g.off[6];
  const int pmask = g.present[0] | g.present[1] << 1 | g.present[2] << 2;
  uint8_t wb[CPT];
  uint32_t has = 0, odd = 0;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int c = (codes >> (2 * q)) & 3;
    wb[q] = 0;
    if (c && ((pmask >> (c - 1)) & 1)) {
      const int f = c - 1;
      const long long o = s_o0[f] + (long long)((rank >> (FIELD * f)) & fmask);
      const long long L = f == 0 ? g.len[4] : f == 1 ? g.len[5] : g.len[6];
      const uint8_t* wid = f == 0 ? wid0 : f == 1 ? wid1 : wid2;
      has |= 1u << q;
      odd |= (uint32_t)(o & 1) << q;
      wb[q] = __ldg(wid + (o >> 1 < L - 1 ? o >> 1 : L - 1));
    }
    if (c) rank += 1ull << (FIELD * (c - 1));
  }
  long long P[3];
  uint8_t pb[3][NPT / 2];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const long long nn = 2 * g.len[4 + f];
    P[f] = g.present[f] && ((tot >> (FIELD * f)) & fmask)
               ? (s_o0[f] < nn ? s_o0[f] : nn) : 0;
    const long long byte0 = P[f] / WT * (WT / 2) + threadIdx.x * (NPT / 2);
#pragma unroll
    for (int q = 0; q < NPT / 2; ++q)
      pb[f][q] = 2 * (byte0 + q) < P[f] ? __ldg(blob + g.off[4 + f] + byte0 + q)
                                       : 0;
  }
  long long excl = 0;
  if (threadIdx.x < 3) {  // the loads above fly while it waits
    const int f = threadIdx.x;
    const long long Pf = f == 0 ? P[0] : f == 1 ? P[1] : P[2];
#ifdef UNPACK_PROFILE
    const long long prof_w = clock64();
#endif
    if (Pf >= WT)
      excl = (long long)(wait_status(st + g.wbase[f] + Pf / WT - 1, g.epoch,
                                     F_INC) & VMASK);
#ifdef UNPACK_PROFILE
    if (f == 0 && t < 4096) unpack_prof[t][7] = clock64() - prof_w;
#endif
  }
  u64 wqs = 0, wmine = 0, part = 0;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    if (!((has >> q) & 1)) continue;
    const int f = ((codes >> (2 * q)) & 3) - 1;
    const u64 w = ((wb[q] >> (((odd >> q) & 1) * 4)) & 15) + 1;
    wqs |= w << (5 * q);
    wmine += w << (FIELD * f);
  }
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const long long byte0 = P[f] / WT * (WT / 2) + threadIdx.x * (NPT / 2);
    u64 sf = 0;
#pragma unroll
    for (int q = 0; q < NPT / 2; ++q) {
      const long long o = 2 * (byte0 + q);
      sf += (o < P[f] ? pb[f][q] & 15 : 0) + (o + 1 < P[f] ? pb[f][q] >> 4 : 0);
    }
    part += sf << (FIELD * f);
  }
  u64 ptot, wtot, wpre = wmine;
  block_inclusive_scan2(part, wpre, warp_u, &ptot, &wtot);
  wpre -= wmine;
  PROF(3);

  // 4. NP(o0) and each family's span: stream bytes [A, A + blen) to
  // shared memory
  if (threadIdx.x < 3) {
    const int f = threadIdx.x;
    if (g.present[f] && ((tot >> (FIELD * f)) & fmask)) {
      const long long e = s_o0[f] - 2 * g.len[4 + f];
      long long np = excl + (long long)((ptot >> (FIELD * f)) & fmask);
      if (e > 0) {
        const int last = s_wlast[f];
        np += (e >> 1) * ((last & 15) + (last >> 4)) + (e & 1) * (last & 15);
      }
      s_np[f] = np;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sbase = 0;
    for (int f = 0; f < 3; ++f) {
      s_nchunk[f] = 0;
      s_fill[f] = 0;
      s_blen[f] = 0;
      if (!g.present[f] || !((tot >> (FIELD * f)) & fmask)) continue;
      const long long start = (long long)g.rows * (s_o0[f] + s_np[f]);
      const long long end =
          start + (long long)g.rows * (long long)((wtot >> (FIELD * f)) & fmask);
      const uint8_t* pay = blob + g.off[1 + f];
      const long long len = g.len[1 + f];
      const long long need_lo = (start >> 4) * 2, need_hi = (end >> 3) + 8;
      const long long a =
          need_lo - (long long)(((uintptr_t)(pay + need_lo)) & 15);
      const int blen = (int)((need_hi - a + 15) & ~15ll);
      const long long copy_hi = need_hi < len ? need_hi : len;
      s_start[f] = start;
      s_a[f] = a;
      s_sbase[f] = sbase;
      s_blen[f] = blen;
      s_nchunk[f] = copy_hi > a ? (int)((copy_hi - a + 15) >> 4) : 0;
      s_fill[f] = need_hi > len;
      sbase += blen;
    }
  }
  __syncthreads();
  PROF(4);
  for (int f = 0; f < 3; ++f) {
    const uint8_t* src = blob + g.off[1 + f] + s_a[f];
    for (int i = threadIdx.x; i < s_nchunk[f]; i += THREADS)
      cp_async16(smem + s_sbase[f] + 16 * i, src + 16 * i);
  }

  // 5. the per-column table, while the copies fly
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int lc = threadIdx.x * CPT + q;
    if (lc >= ncol) break;
    uint32_t ent = 0;
    const uint32_t w = (uint32_t)(wqs >> (5 * q)) & 31;
    if (w) {
      const int f = ((codes >> (2 * q)) & 3) - 1;
      const long long bit =
          s_start[f] + (long long)g.rows * (long long)((wpre >> (FIELD * f)) & fmask);
      const uint32_t s = (uint32_t)(8 * s_sbase[f] + (bit - 8 * s_a[f]));
      ent = (s << 5) | w;
      wpre += (u64)w << (FIELD * f);
    }
    tab[lc] = ent;
  }
  cp_async_wait_all();
  __syncthreads();

  // 6. stream bytes past the payload read as its last word (the clamp)
  for (int f = 0; f < 3; ++f) {
    if (!s_fill[f]) continue;
    const long long len = g.len[1 + f];
    const long long lo = len > s_a[f] ? len - s_a[f] : 0;
    for (long long i = lo + threadIdx.x; i < s_blen[f]; i += THREADS) {
      const long long sb = s_a[f] + i;  // stream byte
      smem[s_sbase[f] + i] = (uint8_t)(s_hlast[f] >> ((sb & 1) * 8));
    }
  }
  __syncthreads();
  PROF(5);

  // 7. the values: 8 consecutive elements of the tile's flat k run a thread
  const int rows = g.rows, level = g.level;
  const int lsw = g.ltc < level ? g.ltc : level;  // log2 min(tc, cols)
  const int nel = ncol * rows;
  if (lsw >= 3) {
    // whole blocks (tc >= cols) or a run of tc columns of one block. Item
    // i is row r of the 8 columns c..c+7 of local block bl, rows fastest:
    // neighbouring lanes read neighbouring bits of the same columns, so
    // their shared loads fall on a few words (no bank conflicts), and
    // each stores 16 bytes of its own row
    const long long obase =
        (((c0 >> level) * rows) << level) + (c0 & ((1 << level) - 1));
    const int lg = lsw - 3;  // log2 of the 8-column groups a block row
    for (int i = threadIdx.x; i < nel >> 3; i += THREADS) {
      const int gi = (int)(((u64)i * g.magic) >> 32);  // i / rows
      const int r = i - gi * rows;
      const int bl = gi >> lg, c = (gi & ((1 << lg) - 1)) << 3;
      const int q = bl * rows + r;
      const int lc = (bl << lsw) + c;
      const uint4 t0 = *(const uint4*)(tab + lc);
      const uint4 t1 = *(const uint4*)(tab + lc + 4);
      uint4 out;
      out.x = pack2(value_at(s32, t0.x, r), value_at(s32, t0.y, r));
      out.y = pack2(value_at(s32, t0.z, r), value_at(s32, t0.w, r));
      out.z = pack2(value_at(s32, t1.x, r), value_at(s32, t1.y, r));
      out.w = pack2(value_at(s32, t1.z, r), value_at(s32, t1.w, r));
      *(uint4*)(k + obase + ((long long)q << level) + c) = out;
    }
  } else {
    // cols < 8, whole blocks: the tile's k is the flat run [E0, E0 + nel);
    // groups of 8 aligned in k, the two ends stored element by element
    const int cols = 1 << level;
    const long long E0 = c0 * rows;
    const long long g0 = E0 >> 3, g1 = (E0 + nel + 7) >> 3;
    for (long long gi = g0 + threadIdx.x; gi < g1; gi += THREADS) {
      const int e = (int)((gi << 3) - E0);  // from -7
      const int ef = e > 0 ? e : 0;
      const int q = ef >> level;
      int c = ef & (cols - 1);
      int bl = (int)(((u64)q * g.magic) >> 32);
      int r = q - bl * rows;
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = 0;
        if (e + j >= 0 && e + j < nel) {
          v[j] = value_at(s32, tab[(bl << level) + c], r);
          if (++c == cols) {
            c = 0;
            if (++r == rows) {
              r = 0;
              ++bl;
            }
          }
        }
      }
      if (e >= 0 && e + 8 <= nel) {
        *(uint4*)(k + (gi << 3)) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                             pack2(v[4], v[5]), pack2(v[6], v[7]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e + j >= 0 && e + j < nel) k[(gi << 3) + j] = (int16_t)v[j];
      }
    }
  }
#ifdef UNPACK_PROFILE
  __syncthreads();
  PROF(6);
#endif
}

__global__ void __launch_bounds__(THREADS)
unpack_kernel(const uint8_t* __restrict__ blob, Geo g, u64* __restrict__ st,
              int32_t* __restrict__ vals, int32_t* __restrict__ wrap0,
              int16_t* __restrict__ k) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ u64 warp_u[2 * THREADS / 32];
  __shared__ unsigned s_ticket;
  // st[0] is the ticket counter; the status words follow it
#ifdef UNPACK_PROFILE
  const long long prof_k = clock64();
#endif
  if (threadIdx.x == 0)
    s_ticket = atomicAdd((unsigned*)st, 1u) - g.ticket0;
  __syncthreads();
  int b = (int)s_ticket;
  const int nwt_all = g.nwt[0] + g.nwt[1] + g.nwt[2];
  if (b < nwt_all) {
    width_tile(blob, g, st + 1, b, warp_u);
    return;
  }
  b -= nwt_all;
  if (b < g.nct) {
#ifdef UNPACK_PROFILE
    if (threadIdx.x == 0 && b < 4096) unpack_prof[b][0] = clock64() - prof_k;
#endif
    column_tile(blob, g, st + 1, b, k, smem, warp_u);
    return;
  }
  b -= g.nct;
  // vals (little-endian uint16) and wrap0 (little-endian int32), at any
  // byte offset: byte loads
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
  g.ltc = (int)a[35];
  g.span = (int)a[36];
  g.magic = (u64)a[37];
  g.epoch = (u64)a[38];
  g.ticket0 = (unsigned)a[39];
  return g;
}

}  // namespace

extern "C" {

// The dynamic shared memory the kernel may take, the largest its wrapper
// asks (or what the device allows, where less), set on the current device
// once before its first launch
// (ops/unpack_cuda.py::_attributes): a launch never sets it, so launches
// from several threads cannot break one another's.
int acm_unpack_attributes(int smem) {
  cudaFuncAttributes a;
  int dev = 0, optin = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, unpack_kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int cap = optin - (int)a.sharedSizeBytes;
  return (int)cudaFuncSetAttribute(
      unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem < cap ? smem : cap);
}

// The geometry array `geo` (40 long longs, host memory) is laid out as
// geo_from reads it; ops/unpack_cuda.py::geometry builds it. `status` is
// the scratch of ops/unpack_cuda.py (ticket counter and status words),
// `grid` the CTAs, `smem` the dynamic shared memory of a CTA. Returns
// cudaGetLastError() after the launch (0 on success).
int acm_unpack(const void* blob, const long long* geo, void* status,
               void* vals, void* wrap0, void* k, int grid, int smem,
               void* stream) {
  const Geo g = geo_from(geo);
  unpack_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blob, g, (u64*)status, (int32_t*)vals, (int32_t*)wrap0,
      (int16_t*)k);
  return (int)cudaGetLastError();
}

#ifdef UNPACK_PROFILE
// Copies the phase trace (4096 x 8 int64) to `out` (host memory) and
// clears it; returns a cudaError.
int acm_unpack_prof_take(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, unpack_prof, sizeof(unpack_prof));
  if (e != cudaSuccess) return (int)e;
  static long long zeros[4096][8];
  return (int)cudaMemcpyToSymbol(unpack_prof, zeros, sizeof(unpack_prof));
}
#endif

}  // extern "C"
