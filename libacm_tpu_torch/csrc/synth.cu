// Synthesis filterbank for Hopper (sm_90a): dequantize k*val, `level`
// order-2 FIR passes (+1 rounding bias after pass 0), arithmetic >> level,
// truncation to int16, and the final per-file carry in the reference's
// wrapbuf layout [2*cols-2].
//
// Replaces the Pallas TPU kernel libacm_tpu/ops/synth_pallas.py::_kernel
// (launched by synth_pcm_pallas). Pass p on the flat block index f, with
// s = cols >> (p+1):
//
//     y[f] = sign(f/s) * (x[f] + x[f-2s]) + 2*x[f-s]     (+1 at f%s == 0, p == 0)
//
// where sign is +1 for even f/s; x[-2s..-1] is the previous block's tail
// (or the carry-in wrap0 at block 0). Since rows*cols is a multiple of 2s,
// the index may count from any block boundary.
//
// Three routes, chosen by geometry in the host wrapper (ops/synth_cuda.py):
//
// * synth_fused_kernel — level >= 1 and a tile of one block fits the
//   shared memory of one CTA. It replaces an earlier
//   one-tile-per-CTA design, which re-synthesized a predecessor block for
//   every tile of T blocks, loaded its whole tile before its passes and
//   stored it after (so memory and ALUs took turns), read and wrote shared
//   memory four times per element per pass, and fit one CTA per SM. Here:
//   - Each CTA takes a span of consecutive blocks of one file and walks it
//     in tiles of T blocks, in order: the loop inside the CTA takes the
//     place of the TPU's sequential grid. Between tiles it carries each
//     pass's last 2s inputs in shared memory, in the reference's wrap
//     layout (pass p at offset sum_{q<p} 2*s_q). A span starting at
//     block blk0 first synthesizes the `warm` blocks before it,
//     from first = max(blk0 - warm, 0), and discards their PCM: from
//     wrap0 where first == 0, else from a zero carry. The zero halo
//     pollutes at most the first 2*cols-2 outputs counted from block
//     first, and the carry is the last 2s inputs of each pass, so
//     warm = W = ceil((2*cols-2) / (rows*cols)) blocks leave the exact
//     carry (libacm_tpu_torch.ops.synth_torch.warmup_blocks: 1 for
//     rows >= 2, 2 for rows == 1 from level 2). That costs W blocks per
//     span, not per tile. The CTA whose span ends at block nb writes the
//     carry to wrap_f.
//   - The tile is sized for two resident CTAs per SM, or for one where a
//     block leaves no room for two (synth_cuda.fused_budget: 10/16, 11/8,
//     12/3, 12/4, 13/1, 13/2), and the spans for about one wave of them
//     (synth_cuda.fused_plan).
//   - The next tile's k and vals are copied into a second staging buffer
//     with cp.async (16 bytes a copy of k where n % 8 == 0 and k is
//     16-byte aligned, else 8, 4 or 2) while the current tile's passes
//     run. Pass 0 reads k from staging and multiplies by its block's val
//     (no dequantize sweep).
//   - Passes 0 .. level-4 (pass 0 alone below level 4) walk strips (see
//     Strips): a thread takes one residue r of the stride s and a run of
//     consecutive q of f = q*s + r, keeps x[q-2] and x[q-1] in registers,
//     and so reads and writes each element once per pass, in place, with
//     the sign fixed per unrolled step and the pass-0 bias per strip. Runs
//     have odd length, which keeps a warp's 32 lanes on 32 banks for every
//     s < 32 without padding.
//   - The last three passes (strides 4, 2, 1; fewer below level 4) run in
//     registers on 8
//     consecutive elements a thread, their halos shuffled from the lane
//     before (last_passes), and PCM leaves in 16-byte stores, so they cost
//     no shared-memory traffic, no barrier and no store sweep.
// * synth_level0_kernel — level 0 (no pass): k * val truncated, one
//   bytes-bound pass of 16-byte vectors.
// * blocks larger than one CTA's shared memory (227 KB: 11/16, 12/>=8,
//   13/>=3, 14/*, 15/*): synth_pass_kernel runs each pass wider than
//   synth_cuda.TAIL_STRIDE as one flat launch over the files in device
//   memory, and synth_tail_kernel the remaining passes in one launch over
//   flat tiles in shared memory that recompute their halo, rather than
//   carry it: a thread-block cluster sharing a block in distributed
//   shared memory (8 x 227 KB) would need whole blocks of up to 2 MB of
//   int32 (15/16) in one cluster and would leave most SMs idle when a
//   call has few blocks, while a tile needs only its halo of at most
//   4 * TAIL_STRIDE words and spreads any block over many CTAs.
//
// Arithmetic is uint32 (signed overflow is undefined in C++; the format
// wraps), converted to int32 only for the arithmetic >> level.
//
// Bound: k is read and PCM written once (4 bytes a sample) against about
// 2*level+2 int32 operations a sample (dequantize, two adds per pass, the
// shift). On an H100 (3.35 TB/s, 132 SMs x 64 int32 lanes x 1.98 GHz) the
// bytes bound is the larger at 7/16, 4/40 and level 0 and the operations
// bound at 10/4. Beyond either, the kernel pays a shared-memory load and store per
// element for each strip pass, with two barriers each, and the address
// arithmetic of the strips; PERF.md holds its measured share of the bound
// and the phase trace (SYNTH_PROFILE) of where a CTA's cycles go.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

#ifdef SYNTH_PROFILE
// Opt-in phase trace (nvcc -DSYNTH_PROFILE; tools/torch_synth_probe.py
// builds and reads it): each thread sums the clock64() cycles it spends in
// each phase of synth_fused_kernel in registers, and thread 0 writes its
// sums to its CTA's row at the end. Slots: 0 cp.async wait, 1 tile
// barrier, 2 pass 0, 3 its barrier, 4 halo loads of passes 1.., 5 their
// barriers, 6 walks of passes 1.., 7 their barriers, 8 last pass, 9 whole
// CTA, 10 tiles.
__device__ long long synth_prof[4096][16];
#define PROF_DECL long long prof[11] = {}
#define PROF_T(name) const long long name = clock64()
#define PROF_COUNT(slot) prof[slot] += 1
#define PROF_ADD(slot, from) prof[slot] += clock64() - (from)
#define PROF_WRITE                                                           \
  if (threadIdx.x == 0) {                                                    \
    for (int i = 0; i < 11; ++i)                                             \
      synth_prof[(blockIdx.y * gridDim.x + blockIdx.x) & 4095][i] = prof[i]; \
  }
#else
#define PROF_DECL
#define PROF_T(name)
#define PROF_COUNT(slot)
#define PROF_ADD(slot, from)
#define PROF_WRITE
#endif

__device__ __forceinline__ uint32_t fir(uint32_t a, uint32_t m, uint32_t c,
                                        int f, int sh, bool bias) {
  const uint32_t t = a + c;
  uint32_t y = 2u * m + (((f >> sh) & 1) ? 0u - t : t);
  if (bias && (f & ((1 << sh) - 1)) == 0) y += 1u;
  return y;
}

__device__ __forceinline__ int16_t to_pcm(uint32_t y, int level) {
  return (int16_t)(uint16_t)((int32_t)y >> level);
}

__device__ __forceinline__ int up(int x, int m) { return (x + m - 1) / m * m; }

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(W));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy Tt blocks of k (n int16 each) and their vals into staging, `width`
// bytes a copy of k. Widths 16, 8 and 4 are asynchronous; width 2 (k not
// 4-byte aligned) is a plain copy, complete at the next barrier. The vals
// are copied asynchronously too, so no thread waits on device memory.
__device__ __forceinline__ void stage_tile(const int16_t* __restrict__ src,
                                           const int32_t* __restrict__ vsrc,
                                           int16_t* dst, int32_t* vdst, int Tt,
                                           int n, int width) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bytes = 2 * Tt * n;
  const char* s = (const char*)src;
  char* d = (char*)dst;
  if (width == 16) {
    for (int i = 16 * tid; i < bytes; i += 16 * nt) cp_async<16>(d + i, s + i);
  } else if (width == 8) {
    for (int i = 8 * tid; i < bytes; i += 8 * nt) cp_async<8>(d + i, s + i);
  } else if (width == 4) {
    for (int i = 4 * tid; i < bytes; i += 4 * nt) cp_async<4>(d + i, s + i);
  } else {
    for (int i = tid; i < Tt * n; i += nt) dst[i] = src[i];
  }
  for (int i = tid; i < Tt; i += nt) cp_async<4>(vdst + i, vsrc + i);
  cp_async_commit();
}

// A cursor on one strip of a pass of stride s: ld(i) and st(i, y) read
// the input and write the output i steps (0 or 1) past the current one,
// next(k) moves k steps on. XStrip works in place on the pass buffer;
// KStrip reads staged k times its block's val and writes the buffer.
struct XStrip {
  uint32_t* p;
  int s;
  __device__ __forceinline__ uint32_t ld(int i) const { return p[i * s]; }
  __device__ __forceinline__ void st(int i, uint32_t y) const { p[i * s] = y; }
  __device__ __forceinline__ void next(int k) { p += k * s; }
};

struct KStrip {
  const int16_t* k;
  uint32_t* x;
  int s;
  uint32_t v;
  __device__ __forceinline__ uint32_t ld(int i) const {
    return (uint32_t)(int32_t)k[i * s] * v;
  }
  __device__ __forceinline__ void st(int i, uint32_t y) const { x[i * s] = y; }
  __device__ __forceinline__ void next(int n) {
    k += n * s;
    x += n * s;
  }
};

// Walk one strip of a pass, q ascending in [q, q1), the cursor c at step
// q: y[q] = +-(x[q] + x[q-2]) + 2*x[q-1] + bias, + for even q. x2, x1
// hold x[q-2], x[q-1] on entry and the strip's last two inputs on exit.
// Unrolled by two so that each step's sign is fixed.
template <class Strip>
__device__ __forceinline__ void walk(int q, int q1, uint32_t& x2, uint32_t& x1,
                                     uint32_t bias, Strip c) {
  if (q < q1 && (q & 1)) {
    const uint32_t a = c.ld(0);
    c.st(0, 2u * x1 - (a + x2) + bias);
    x2 = x1;
    x1 = a;
    ++q;
    c.next(1);
  }
  for (; q + 1 < q1; q += 2) {
    const uint32_t a0 = c.ld(0), a1 = c.ld(1);
    c.st(0, a0 + x2 + 2u * x1 + bias);
    c.st(1, 2u * a0 - (a1 + x1) + bias);
    x2 = a0;
    x1 = a1;
    c.next(2);
  }
  if (q < q1) {
    const uint32_t a = c.ld(0);
    c.st(0, a + x2 + 2u * x1 + bias);
    x2 = x1;
    x1 = a;
  }
}

// A pass of stride s = 1 << sh over N elements is cut into strips: item
// (r, c) takes residue r and the run q in [c*Q, min((c+1)*Q, N/s)). Where
// s < nt (nt = 1 << lg_nt threads) there are C = nt/s runs per residue and
// each thread has one item, r = tid % s and c = tid / s; Q is odd, so for
// s < 32 the lanes of a warp land on 32 different banks at every step, and
// at least 3, so that a run past q = 0 finds x[q0-2] in the pass's input.
// Where s >= nt each thread walks whole residues r = tid, tid + nt, ...
// (one run each).
struct Strips {
  int s, sh, Qtot, Q, C;
  __device__ Strips(int sh_, int N, int lg_nt) : s(1 << sh_), sh(sh_), Qtot(N >> sh_) {
    const int lg_c = max(lg_nt - sh, 0);
    C = 1 << lg_c;
    Q = max(((Qtot + C - 1) >> lg_c) | 1, 3);
  }
};

// One pass of stride S (4, 2 or 1) in registers over the 8 consecutive
// elements from 8g: t holds the pass's inputs there and receives its
// outputs, h holds its inputs x[8g-2S, 8g). 8g is a multiple of 2S, so
// each step's sign is fixed by i.
template <int S>
__device__ __forceinline__ void reg_pass(uint32_t (&t)[8], const uint32_t* h) {
  uint32_t y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = i >= S ? t[i - S] : h[i + S];
    const uint32_t c = i >= 2 * S ? t[i - 2 * S] : h[i];
    y[i] = ((i / S) & 1) ? 2u * m - (t[i] + c) : t[i] + c + 2u * m;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = y[i];
}

// The halos of the last K passes (strides 4, 2, 1 for K = 3) at position
// P, from the first one's inputs X[P-W, P) with W = 2*(2^K - 1): h4, h2,
// h1 receive the inputs of the passes of stride 4, 2, 1 on [P-2s, P).
template <int K>
__device__ __forceinline__ void halos_at(const uint32_t* X, int P, uint32_t* h4,
                                         uint32_t* h2, uint32_t* h1) {
  constexpr int W = 2 * ((1 << K) - 1);
  uint32_t u[16];
#pragma unroll
  for (int i = 16 - W; i < 16; ++i) u[i] = X[P - 16 + i];
  if constexpr (K >= 3) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h4[i] = u[8 + i];
#pragma unroll
    for (int i = 15; i >= 10; --i) u[i] = fir(u[i], u[i - 4], u[i - 8], P - 16 + i, 2, false);
  }
  if constexpr (K >= 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = u[12 + i];
#pragma unroll
    for (int i = 15; i >= 14; --i) u[i] = fir(u[i], u[i - 2], u[i - 4], P - 16 + i, 1, false);
  }
  h1[0] = u[14];
  h1[1] = u[15];
}

// The last K passes (K = min(3, level - 1): strides 4, 2, 1) in registers,
// then PCM. Each thread takes 8 consecutive elements g, reads them as two
// 16-byte loads (the half order swapped in every other group of 4 lanes,
// so a quarter warp covers all 32 banks), takes each pass's halo from the
// lane before it by shuffles (a warp's lane 0 from the carry at g = 0,
// else recomputed from X by halos_at), and writes 8 samples of PCM in one
// 16-byte store where the tile's PCM is 16-byte aligned. K = 0 (level 1:
// pass 0 already ran as the last pass) only stores. Thread 0 then writes
// the K new carries, after it read the old ones at g = 0.
template <int K>
__device__ __forceinline__ void last_passes(const uint32_t* X, uint32_t* carry,
                                            int16_t* __restrict__ pcm, int64_t e0,
                                            int N, int skip, int level, int wlen,
                                            bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int NG = (N + 7) >> 3;
  uint32_t l4[8] = {}, l2[4] = {}, l1[2] = {};  // lane 0's halos
  for (int g0 = tid - lane; g0 < NG; g0 += nt) {
    const int g = g0 + lane;
    uint32_t v[8];
    if (g < NG) {
      const uint4* p4 = (const uint4*)(X + 8 * g);
      const int sw = (lane >> 2) & 1;
      const uint4 u = p4[sw], w = p4[sw ^ 1];
      const uint4 lo = sw ? w : u, hi = sw ? u : w;
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0u;
    }
    if constexpr (K > 0) {
      if (lane == 0 && g < NG) {
        if (g == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) l4[i] = K >= 3 ? carry[wlen - 14 + i] : 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) l2[i] = K >= 2 ? carry[wlen - 6 + i] : 0u;
          l1[0] = carry[wlen - 2];
          l1[1] = carry[wlen - 1];
        } else {
          halos_at<K>(X, 8 * g, l4, l2, l1);
        }
      }
      if constexpr (K >= 3) {
        uint32_t h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          h[i] = __shfl_up_sync(0xffffffffu, v[i], 1);
          if (lane == 0) h[i] = l4[i];
        }
        reg_pass<4>(v, h);
      }
      if constexpr (K >= 2) {
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[i] = __shfl_up_sync(0xffffffffu, v[4 + i], 1);
          if (lane == 0) h[i] = l2[i];
        }
        reg_pass<2>(v, h);
      }
      uint32_t h[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        h[i] = __shfl_up_sync(0xffffffffu, v[6 + i], 1);
        if (lane == 0) h[i] = l1[i];
      }
      reg_pass<1>(v, h);
    }
    if (g >= NG) continue;
    const int e = 8 * g;
    if (vec && e >= skip && e + 8 <= N) {
      uint4 o;
      o.x = __byte_perm((int32_t)v[0] >> level, (int32_t)v[1] >> level, 0x5410);
      o.y = __byte_perm((int32_t)v[2] >> level, (int32_t)v[3] >> level, 0x5410);
      o.z = __byte_perm((int32_t)v[4] >> level, (int32_t)v[5] >> level, 0x5410);
      o.w = __byte_perm((int32_t)v[6] >> level, (int32_t)v[7] >> level, 0x5410);
      *(uint4*)(pcm + e0 + e) = o;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (e + i >= skip && e + i < N) pcm[e0 + e + i] = to_pcm(v[i], level);
      }
    }
  }
  if constexpr (K > 0) {
    if (tid == 0) {
      uint32_t c4[8], c2[4], c1[2];
      halos_at<K>(X, N, c4, c2, c1);
#pragma unroll
      for (int i = 0; i < 8; ++i) if (K >= 3) carry[wlen - 14 + i] = c4[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) if (K >= 2) carry[wlen - 6 + i] = c2[i];
      carry[wlen - 2] = c1[0];
      carry[wlen - 1] = c1[1];
    }
  }
}

// Shared memory (words): carry [up(2*cols-2, 4)], the vals of two tiles
// [up(2*T, 4)], the pass buffer X [up(T*n, 8)] (element e of the tile at
// X[e], passes 1.. in place), then two staging buffers of up(T*n, 8)
// int16. synth_cuda.fused_smem_bytes mirrors this.
__global__ void __launch_bounds__(256, 2)
synth_fused_kernel(const int16_t* __restrict__ k,
                   const int32_t* __restrict__ vals,
                   const int32_t* __restrict__ wrap0,
                   int16_t* __restrict__ pcm, int32_t* __restrict__ wrapf,
                   int nb, int level, int rows, int T, int span, int warm) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int cols = 1 << level;
  const int n = rows << level;
  const int wlen = 2 * cols - 2;
  const int SN = up(T * n, 8);
  uint32_t* carry = smem;
  int32_t* tv = (int32_t*)(carry + up(wlen, 4));
  uint32_t* X = (uint32_t*)(tv + up(2 * T, 4));
  int16_t* stg = (int16_t*)(X + SN);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // a power of two (synth_cuda._FUSED_THREADS)
  const int lg_nt = 31 - __clz(nt);
  const int b = blockIdx.y;
  const int blk0 = blockIdx.x * span;
  const int blk_end = min(nb, blk0 + span);
  const int first = max(blk0 - warm, 0);  // the first warm-up block
  const int ntiles = (blk_end - first + T - 1) / T;
  const int16_t* kf = k + (int64_t)b * nb * n;
  const int32_t* vf = vals + (int64_t)b * nb;
  const int R2 = 2 * rows;  // pass-0 steps per block (n = R2 * s0)
  // q / R2 as __umulhi(q, r2inv): exact for q < 2^16 and R2 < 2^16
  const uint32_t r2inv = 0xffffffffu / R2 + 1;

  const uintptr_t ka = (uintptr_t)k;
  const int width = (n % 8 == 0 && ka % 16 == 0) ? 16
                    : (n % 4 == 0 && ka % 8 == 0) ? 8
                    : (ka % 4 == 0) ? 4 : 2;  // n is even: level >= 1
  const bool pcm16 = ((uintptr_t)pcm % 16 == 0);

  PROF_DECL;
  PROF_T(t_cta);
  const int32_t* w0 = wrap0 + (int64_t)b * wlen;
  for (int i = tid; i < wlen; i += nt) carry[i] = first ? 0u : (uint32_t)w0[i];
  stage_tile(kf + (int64_t)first * n, vf + first, stg, tv, min(T, blk_end - first), n,
             width);
  __syncthreads();  // the carry

  for (int t = 0; t < ntiles; ++t) {
    const int tblk = first + t * T;
    const int Tt = min(T, blk_end - tblk);
    const int N = Tt * n;
    const int cur = t & 1;
    const int16_t* sk = stg + cur * SN;
    const int32_t* sv = tv + cur * T;

    // pass 0 reads k * val from staging and writes X; an item at q0 == 0
    // takes its halo from the carry, read here, before the barrier after
    // which the strip ending at N/s writes the new carry
    const Strips P0(level - 1, N, lg_nt);
    const int r0 = tid & (P0.s - 1);
    const int q00 = P0.C > 1 ? (tid >> P0.sh) * P0.Q : 0;
    uint32_t h2 = 0, h1 = 0;
    if (P0.C > 1 && q00 == 0) {
      h2 = carry[r0];
      h1 = carry[P0.s + r0];
    }
    PROF_T(t_wait);
    cp_async_wait_all();
    PROF_ADD(0, t_wait);
    PROF_T(t_top);
    __syncthreads();  // tile t staged; tile t-1 finished with X
    PROF_ADD(1, t_top);
    PROF_COUNT(10);
    PROF_T(t_p0);
    if (t + 1 < ntiles) {
      const int nblk = tblk + T;
      stage_tile(kf + (int64_t)nblk * n, vf + nblk, stg + (cur ^ 1) * SN,
                 tv + (cur ^ 1) * T, min(T, blk_end - nblk), n, width);
    }

    {
      const int s = P0.s;
      auto deq = [&](int q, int r) {  // a halo word, from staging
        return (uint32_t)(int32_t)sk[(q << P0.sh) + r] * (uint32_t)sv[__umulhi(q, r2inv)];
      };
      for (int it = tid; it < (P0.C > 1 ? nt : s); it += nt) {
        const int r = it & (s - 1);
        const int q0 = P0.C > 1 ? q00 : 0;
        const int q1 = min(q0 + (P0.C > 1 ? P0.Q : P0.Qtot), P0.Qtot);
        if (q0 >= q1) continue;
        uint32_t x2, x1;
        if (q0 == 0) {
          x2 = P0.C > 1 ? h2 : carry[r];
          x1 = P0.C > 1 ? h1 : carry[s + r];
        } else {
          x2 = deq(q0 - 2, r);
          x1 = deq(q0 - 1, r);
        }
        const uint32_t bias = r == 0;
        int q = q0, bi = __umulhi(q0, r2inv);
        while (q < q1) {  // one run of constant val per block
          const int qe = min(q1, (bi + 1) * R2);
          const int e = (q << P0.sh) + r;
          walk(q, qe, x2, x1, bias, KStrip{sk + e, X + e, s, (uint32_t)sv[bi]});
          q = qe;
          ++bi;
        }
        if (q1 == P0.Qtot) {
          carry[r] = x2;
          carry[s + r] = x1;
        }
      }
    }
    PROF_ADD(2, t_p0);
    PROF_T(t_p0bar);
    __syncthreads();
    PROF_ADD(3, t_p0bar);

    // passes 1 .. level-1-K, in place on X; the last K run in registers
    const int K = min(3, level - 1);
    int off = cols;  // pass 1's carry offset (pass 0's segment is cols long)
    for (int p = 1; p < level - K; ++p) {
      const Strips P(level - 1 - p, N, lg_nt);
      const int s = P.s;
      if (P.C > 1) {
        // one item per thread; its halo is read before anyone writes
        const int r = tid & (s - 1);
        const int q0 = (tid >> P.sh) * P.Q;
        const int q1 = min(q0 + P.Q, P.Qtot);
        uint32_t x2 = 0, x1 = 0;
        PROF_T(t_halo);
        if (q0 < q1) {
          x2 = q0 ? X[((q0 - 2) << P.sh) + r] : carry[off + r];
          x1 = q0 ? X[((q0 - 1) << P.sh) + r] : carry[off + s + r];
        }
        PROF_ADD(4, t_halo);
        PROF_T(t_halobar);
        __syncthreads();
        PROF_ADD(5, t_halobar);
        PROF_T(t_walk);
        if (q0 < q1) {
          walk(q0, q1, x2, x1, 0u, XStrip{X + (q0 << P.sh) + r, s});
          if (q1 == P.Qtot) {
            carry[off + r] = x2;
            carry[off + s + r] = x1;
          }
        }
        PROF_ADD(6, t_walk);
      } else {
        for (int r = tid; r < s; r += nt) {
          uint32_t x2 = carry[off + r], x1 = carry[off + s + r];
          walk(0, P.Qtot, x2, x1, 0u, XStrip{X + r, s});
          carry[off + r] = x2;
          carry[off + s + r] = x1;
        }
      }
      PROF_T(t_bar);
      __syncthreads();
      PROF_ADD(7, t_bar);
      off += 2 * s;
    }

    PROF_T(t_last);
    const int skip = min(max(blk0 - tblk, 0) * n, N);  // warm-up PCM
    const int64_t e0 = ((int64_t)b * nb + tblk) * n;  // PCM index of element 0
    const bool vec = pcm16 && (e0 & 7) == 0;
    switch (K) {
      case 0: last_passes<0>(X, carry, pcm, e0, N, skip, level, wlen, vec); break;
      case 1: last_passes<1>(X, carry, pcm, e0, N, skip, level, wlen, vec); break;
      case 2: last_passes<2>(X, carry, pcm, e0, N, skip, level, wlen, vec); break;
      default: last_passes<3>(X, carry, pcm, e0, N, skip, level, wlen, vec); break;
    }
    PROF_ADD(8, t_last);
  }

  __syncthreads();
  if (blk_end == nb) {
    int32_t* wf = wrapf + (int64_t)b * wlen;
    for (int i = tid; i < wlen; i += nt) wf[i] = (int32_t)carry[i];
  }
  PROF_ADD(9, t_cta);
  PROF_WRITE;
}

// Level 0: no pass, pcm = (int16)(k * val). Bytes-bound (4 bytes a
// sample). Each thread converts one vector of VEC samples (16, 8, 4 or 2
// bytes of k by alignment, synth_cuda.level0_plan), read and written in
// one access each. The CTA is a (tx, ty) patch: ty blocks of the flat
// [B*nb] axis by tx vectors of a block, so the block's val is one load a
// vector and no index is divided.
template <int VEC> struct Vec;
template <> struct Vec<8> { using T = uint4; };
template <> struct Vec<4> { using T = uint2; };
template <> struct Vec<2> { using T = uint32_t; };
template <> struct Vec<1> { using T = uint16_t; };

template <int VEC>
__global__ void __launch_bounds__(256)
synth_level0_kernel(const int16_t* __restrict__ k, const int32_t* __restrict__ vals,
                    int16_t* __restrict__ pcm, long long nblk, int n) {
  using T = typename Vec<VEC>::T;
  const long long blk = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (blk >= nblk || v >= n / VEC) return;
  const uint32_t val = (uint32_t)vals[blk];
  const long long e = blk * n + (long long)v * VEC;
  T raw = *(const T*)(k + e);
  int16_t x[VEC];
  memcpy(x, &raw, sizeof(T));
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = (int16_t)(uint16_t)((uint32_t)(int32_t)x[i] * val);
  memcpy(&raw, x, sizeof(T));
  *(T*)(pcm + e) = raw;
}

// One wide FIR pass (stride s > synth_cuda.TAIL_STRIDE, so s >= 2048)
// over each file's flat stream of L = nb*n words in device memory: the
// passes whose halo is too wide for a shared-memory tile. Each thread
// takes 4 consecutive outputs: f, f-s and f-2s are 16-byte aligned and
// share one sign, so the three inputs are 16-byte loads (8-byte loads of
// k for pass 0, which dequantizes with one val a vector) and the output
// one 16-byte store. The halo f < 0 comes from wrap0; the last 2s inputs
// are the pass's carry. Needs n % 4 == 0, which s >= 2048 gives.
__device__ __forceinline__ void load4(const int16_t* __restrict__ k,
                                      const uint32_t* __restrict__ xin,
                                      const int32_t* __restrict__ vf,
                                      const int32_t* __restrict__ w0, int64_t base,
                                      int g, int n, bool from_k, bool k8,
                                      uint32_t (&x)[4]) {
  if (g < 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (uint32_t)w0[g + i];
  } else if (from_k) {
    const uint32_t v = (uint32_t)vf[g / n];  // n % 4 == 0: one block
    int16_t h[4];
    if (k8) {
      const uint2 u = *(const uint2*)(k + base + g);
      memcpy(h, &u, 8);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = k[base + g + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (uint32_t)(int32_t)h[i] * v;
  } else {
    const uint4 u = *(const uint4*)(xin + base + g);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
}

__global__ void __launch_bounds__(256)
synth_pass_kernel(const int16_t* __restrict__ k, const uint32_t* __restrict__ xin,
                  const int32_t* __restrict__ vals, const int32_t* __restrict__ wrap0,
                  uint32_t* __restrict__ xout, int32_t* __restrict__ wrapf, int nb,
                  int level, int rows, int p, int k8) {
  const int n = rows << level;
  const int L = nb * n;
  const int cols = 1 << level, wlen = 2 * cols - 2;
  const int b = blockIdx.y;
  const int64_t base = (int64_t)b * L;
  const int sh = level - 1 - p, s = 1 << sh;
  const int off = 2 * cols - 4 * s;  // sum_{q<p} 2*s_q
  const int32_t* vf = vals + (int64_t)b * nb;
  const int32_t* w0 = wrap0 + (int64_t)b * wlen + off + 2 * s;  // w0[-2s .. -1]
  int32_t* wf = wrapf + (int64_t)b * wlen + off;
  for (int f = 4 * (blockIdx.x * blockDim.x + threadIdx.x); f < L;
       f += 4 * gridDim.x * blockDim.x) {
    uint32_t a[4], m[4], c[4];
    load4(k, xin, vf, w0, base, f, n, p == 0, k8, a);
    load4(k, xin, vf, w0, base, f - s, n, p == 0, k8, m);
    load4(k, xin, vf, w0, base, f - 2 * s, n, p == 0, k8, c);
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = fir(a[i], m[i], c[i], f + i, sh, p == 0);
    if (f >= L - 2 * s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) wf[f + i - (L - 2 * s)] = (int32_t)a[i];
    }
    *(uint4*)(xout + base + f) = make_uint4(y[0], y[1], y[2], y[3]);
  }
}

// The passes p0 .. level-1 (strides TAIL_STRIDE and below) in one launch,
// over flat tiles of TL outputs in shared memory. A CTA takes outputs
// [t0, t0+M) of one file and loads its input x (pass p0's: k * val where
// p0 == 0) on [t0-H, t0+M), H = 4*s_p0 >= sum_{q>=p0} 2*s_q + 2: the halo
// every fused pass needs, recomputed by the CTA rather than carried, so
// each pass is exact without any carry lemma. Pass p writes outputs j >=
// H - 2*s_p of the tile (index j is position t0 - H + j) into the other
// buffer, from inputs j - 2*s_p >= H - 4*s_p, which the pass before wrote.
// The file's first tile (t0 == 0) puts wrap0's segment of pass p at
// positions [-2s_p, 0) before the pass; its last tile writes the pass's
// carry (inputs [L-2s_p, L)) to wrapf. The last pass (s = 1) writes PCM,
// 8 samples a thread, in 16-byte stores. Bound: k or x read and PCM
// written once; each pass costs three shared-memory loads and a store an
// element, and the halo costs H/TL more work on the first tail pass.
__global__ void __launch_bounds__(512)
synth_tail_kernel(const int16_t* __restrict__ k, const uint32_t* __restrict__ xin,
                  const int32_t* __restrict__ vals, const int32_t* __restrict__ wrap0,
                  int16_t* __restrict__ pcm, int32_t* __restrict__ wrapf, int nb,
                  int level, int rows, int p0, int TL, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = rows << level;
  const int L = nb * n;
  const int cols = 1 << level, wlen = 2 * cols - 2;
  const int H = 4 << (level - 1 - p0);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TL;
  const int M = min(TL, L - t0);
  const int E = H + M;
  const int64_t base = (int64_t)b * L;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int32_t* vf = vals + (int64_t)b * nb;
  uint32_t* src = smem;
  uint32_t* dst = smem + H + TL;

  for (int j = 4 * tid; j < E; j += 4 * nt) {  // H, TL and t0 are multiples of 4
    const int pos = t0 - H + j;
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    if (pos >= 0 && p0 == 0) {  // pass 0's input: k * val
      const int blk = pos / n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pos + i < L) {
          const int bi = blk + (pos + i >= (blk + 1) * n);
          x[i] = (uint32_t)(int32_t)k[base + pos + i] * (uint32_t)vf[bi];
        }
      }
    } else if (pos >= 0) {  // L % 4 == 0 here (n % 4 == 0 when p0 > 0)
      const uint4 u = *(const uint4*)(xin + base + pos);
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    }
    *(uint4*)(src + j) = make_uint4(x[0], x[1], x[2], x[3]);
  }

  for (int p = p0; p < level; ++p) {
    const int sh = level - 1 - p, s = 1 << sh;
    const int off = 2 * cols - 4 * s;
    __syncthreads();  // src holds pass p's inputs
    if (t0 + M == L) {
      for (int i = tid; i < 2 * s; i += nt)
        wrapf[(int64_t)b * wlen + off + i] = (int32_t)src[E - 2 * s + i];
    }
    if (t0 == 0) {
      for (int i = tid; i < 2 * s; i += nt)
        src[H - 2 * s + i] = (uint32_t)wrap0[(int64_t)b * wlen + off + i];
      __syncthreads();
    }
    if (p + 1 < level) {
      for (int j = H - 2 * s + tid; j < E; j += nt)
        dst[j] = fir(src[j], src[j - s], src[j - 2 * s], t0 - H + j, sh, p == 0);
      uint32_t* t = src;
      src = dst;
      dst = t;
      continue;
    }
    for (int g = tid; 8 * g < M; g += nt) {  // the last pass: s = 1
      const int j = H + 8 * g;
      int16_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i] = 8 * g + i < M ? to_pcm(fir(src[j + i], src[j + i - 1], src[j + i - 2],
                                          t0 + 8 * g + i, 0, p == 0), level)
                             : (int16_t)0;
      }
      int16_t* out = pcm + base + t0 + 8 * g;
      if (vec && 8 * g + 8 <= M) {
        uint4 u;
        memcpy(&u, o, 16);
        *(uint4*)out = u;
      } else {
        for (int i = 0; i < 8 && 8 * g + i < M; ++i) out[i] = o[i];
      }
    }
  }
}

}  // namespace

// Sets a kernel's largest dynamic shared memory on the current device to
// `want`, or to what the device allows beside its static shared memory
// where that is less.
template <typename Kernel>
static cudaError_t set_max_dynamic_smem(Kernel kernel, long long want) {
  cudaFuncAttributes a;
  int dev = 0, optin = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  const long long cap = (long long)optin - (long long)a.sharedSizeBytes;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(want < cap ? want : cap));
}

extern "C" {

// The dynamic shared memory the fused and tail kernels may take (the
// largest their wrapper asks) and the fused kernel's carveout, set on the
// current device once, before its first launch or occupancy query
// (ops/synth_cuda.py::attributes). The launches never set them: a setting
// between another thread's set and launch broke that launch.
int acm_synth_attributes(long long fused_smem, long long tail_smem) {
  cudaError_t e = set_max_dynamic_smem(synth_fused_kernel, fused_smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(synth_fused_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) e = set_max_dynamic_smem(synth_tail_kernel, tail_smem);
  return (int)e;
}

// Returns cudaGetLastError() after the launch (0 on success).
int acm_synth_fused(const void* k, const void* vals, const void* wrap0,
                    void* pcm, void* wrapf, int B, int nb, int level, int rows,
                    int T, int span, int warm, int threads,
                    long long smem_bytes, void* stream) {
  dim3 grid((nb + span - 1) / span, B);
  synth_fused_kernel<<<grid, threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      (const int16_t*)k, (const int32_t*)vals, (const int32_t*)wrap0,
      (int16_t*)pcm, (int32_t*)wrapf, nb, level, rows, T, span, warm);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of a kernel (0: synth_fused_kernel at this shared
// memory, 1: synth_level0_kernel), or -cudaError on failure.
int acm_synth_occupancy(int route, int threads, long long smem_bytes) {
  cudaError_t e = cudaSuccess;
  int n = 0;
  if (route == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, synth_fused_kernel, threads,
                                                      (size_t)smem_bytes);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, synth_level0_kernel<8>, threads,
                                                      0);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// Level 0 over nblk = B*nb blocks of n samples, VEC samples a thread, CTAs
// of (tx, ty) threads on a grid of (gx, gy).
int acm_synth_level0(const void* k, const void* vals, void* pcm, long long nblk, int n,
                     int vec, int tx, int ty, int gx, int gy, void* stream) {
  const dim3 grid(gx, gy), block(tx, ty);
  const int16_t* kk = (const int16_t*)k;
  const int32_t* v = (const int32_t*)vals;
  int16_t* pc = (int16_t*)pcm;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 8: synth_level0_kernel<8><<<grid, block, 0, st>>>(kk, v, pc, nblk, n); break;
    case 4: synth_level0_kernel<4><<<grid, block, 0, st>>>(kk, v, pc, nblk, n); break;
    case 2: synth_level0_kernel<2><<<grid, block, 0, st>>>(kk, v, pc, nblk, n); break;
    case 1: synth_level0_kernel<1><<<grid, block, 0, st>>>(kk, v, pc, nblk, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One wide pass p over B files (xin unused for p == 0, which reads k).
int acm_synth_pass(const void* k, const void* xin, const void* vals,
                   const void* wrap0, void* xout, void* wrapf, int B, int nb,
                   int level, int rows, int p, int k8, int grid_x, int threads,
                   void* stream) {
  synth_pass_kernel<<<dim3(grid_x, B), threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)k, (const uint32_t*)xin, (const int32_t*)vals,
      (const int32_t*)wrap0, (uint32_t*)xout, (int32_t*)wrapf, nb, level, rows, p, k8);
  return (int)cudaGetLastError();
}

// The passes p0 .. level-1 over tiles of TL outputs, grid (ceil(L/TL), B).
int acm_synth_tail(const void* k, const void* xin, const void* vals,
                   const void* wrap0, void* pcm, void* wrapf, int B, int nb,
                   int level, int rows, int p0, int TL, int vec, int grid_x,
                   int threads, long long smem_bytes, void* stream) {
  synth_tail_kernel<<<dim3(grid_x, B), threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      (const int16_t*)k, (const uint32_t*)xin, (const int32_t*)vals,
      (const int32_t*)wrap0, (int16_t*)pcm, (int32_t*)wrapf, nb, level, rows, p0, TL, vec);
  return (int)cudaGetLastError();
}

#ifdef SYNTH_PROFILE
// Copies the phase trace (4096 x 16 int64) to `out` (host memory) and
// clears it; returns a cudaError.
int acm_synth_prof_take(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, synth_prof, sizeof(synth_prof));
  if (e != cudaSuccess) return (int)e;
  static long long zeros[4096][16];
  return (int)cudaMemcpyToSymbol(synth_prof, zeros, sizeof(synth_prof));
}
#endif

}  // extern "C"
