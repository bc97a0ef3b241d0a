// Width-class block unpack for Hopper (sm_90a): the dense route's packed
// coefficients (ops/packing.py::pack_blocks) back to k int16
// [nb, rows, cols], in one launch and no other device operation.
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
// word. Packed row i of a class names block idx[i] by the JAX package's
// index rules (a scatter into nb + 1 rows whose row nb is dropped): an
// idx below 0 names block idx + nb + 1, and an idx whose block lies
// outside [0, nb) names none (the padding of pack_blocks is idx == nb).
// Where rows of several classes name one block, the 16-bit class wins over
// the 8-bit and the 8-bit over the 4-bit (JAX scatters the classes in
// that order). Two rows of one class naming one block are outside the
// contract (JAX leaves their order open); here the later row wins. A block
// no row names is zeros.
//
// Design: one launch (unpack_blocks_kernel); a CTA takes its work from an
// atomic ticket, not blockIdx.
// * Ownership, not a zero fill. The packed rows are numbered one after the
//   other (4-bit, 8-bit, 16-bit), so a higher number is a later class. The
//   lowest tickets are stamp tickets: a thread a packed row resolves its
//   idx and does an atomicMax on its block's owner word with
//   (epoch << 40 | row number), so the winning row is the one the rules
//   name, whatever order the atomics land in. A stamp CTA then counts
//   itself done. The owner words and the counters live in the scratch of
//   ops/unpack_blocks_cuda.py, kept per device and stream: each call has a
//   new epoch, and an owner word of an earlier epoch is lower (atomicMax
//   overwrites it) and reads as "no row names this block". So no memset,
//   and the output is torch.empty: each word of k is written once.
// * Output tickets. The rest of the tickets each own a pass of PASS =
//   8,192 words of the flat output (a 15/16 block of 524,288 words is 64
//   of them, a 7/16 block a quarter of one). They wait until
//   every stamp CTA has counted itself done; that cannot deadlock, because
//   stamp tickets are lower, so the CTAs that hold them are already
//   running and wait on nothing. Then each thread takes G = 4 groups of 8
//   words a pass: it reads the G owner words, issues the G input loads
//   (one 16-, 8- or 4-byte load a group where the input is aligned), and
//   only then decodes and stores, so a thread has G loads in flight and
//   not one dependent chain. The owner words of a pass's blocks are read
//   once a CTA, into shared memory: at 15/16 every CTA of a block would
//   otherwise read one word, a queue on one L2 slice. Warp 0 takes the
//   ticket, waits and reads the pass's owner words, so a CTA crosses one
//   barrier before its loads. A group of a block no row names is 16 bytes
//   of zeros. Stores are 16 bytes (the output is 16-byte aligned and a
//   group starts at a multiple of 8 words); a group that crosses a block
//   (n not a multiple of 8), reads unaligned input or passes the end of
//   the output goes word by word.
// * Padding and unnamed rows are never read: only a block's owner row is.
//
// Bound: the owner rows' payload and the three index arrays are read and
// k (2 bytes a word) written once — bytes, over 3.35 TB/s. The design
// moves just those bytes (a zero fill before a scatter would write k
// twice), in 16-byte stores with several loads in flight a thread; what
// it adds is the stamp phase before the first store (one atomic a packed
// row and one wait a CTA).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int G = 4;                       // groups of 8 words a pass
constexpr int PASS = THREADS * 8 * G;      // words a CTA writes a pass
constexpr int EPOCH_SHIFT = 40;            // owner word: epoch 40-63,
constexpr u64 RMASK = (1ull << EPOCH_SHIFT) - 1;  // packed row 0-39
// scratch words: the ticket counter at 0, the stamp count at DONE and the
// owner words from OWNERS on, each counter in a 128-byte line of its own
constexpr int DONE = 16;
constexpr int OWNERS = 32;
// a pass that spans at most this many blocks reads their owner words once
// into shared memory (every real geometry); one that spans more reads them
// a group at a time
constexpr int OWN_CACHE = 64;

enum { M_NONE, M_ZERO, M_16, M_8, M_4, M_SLOW };

struct Args {
  const int8_t* p4;
  const int8_t* p8;
  const int16_t* p16;
  const int32_t* idx4;
  const int32_t* idx8;
  const int32_t* idx16;
  int16_t* out;
  u64* scratch;         // tickets, stamp CTAs done, owners (see OWNERS)
  long long n4, n8, n16, nb, n, total;  // total = nb * n words
  unsigned nstamp;      // stamp CTAs (THREADS packed rows each)
  unsigned ticket0;     // tickets handed out on the scratch before
  unsigned done0;       // stamp CTAs counted on the scratch before
  u64 epoch;            // this call's epoch (1 .. 2^24 - 1)
};

// Scratch words are read as relaxed gpu-scope (strong, L2) loads: the
// counters and owner words are written by other CTAs' atomics.
__device__ __forceinline__ u64 ld_u64(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned ld_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

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

// The packed row an owner word names: its class and its first byte.
__device__ __forceinline__ const void* source(const Args& a, u64 own,
                                              int& c) {
  const long long r = (long long)(own & RMASK);
  if (r < a.n4) {
    c = 0;
    return a.p4 + r * ((a.n + 1) >> 1);
  }
  if (r < a.n4 + a.n8) {
    c = 1;
    return a.p8 + (r - a.n4) * a.n;
  }
  c = 2;
  return a.p16 + (r - a.n4 - a.n8) * a.n;
}

// Word w of the flat output: its owner row's word, or 0.
__device__ __forceinline__ int16_t word_at(const Args& a, const u64* owner,
                                           long long w) {
  const long long b = (long long)((u64)w / (u64)a.n);
  const u64 own = ld_u64(owner + b);
  if ((own >> EPOCH_SHIFT) != a.epoch) return 0;
  int c;
  const void* row = source(a, own, c);
  return (int16_t)value(c, row, w - b * a.n);
}

__device__ void stamp(const Args& a, u64* owner, unsigned t) {
  const long long r = (long long)t * THREADS + threadIdx.x;
  if (r < a.n4 + a.n8 + a.n16) {
    const int32_t i = r < a.n4            ? __ldg(a.idx4 + r)
                      : r < a.n4 + a.n8 ? __ldg(a.idx8 + (r - a.n4))
                                        : __ldg(a.idx16 + (r - a.n4 - a.n8));
    const long long b = i < 0 ? (long long)i + a.nb + 1 : (long long)i;
    if (b >= 0 && b < a.nb)
      atomicMax(owner + b, (a.epoch << EPOCH_SHIFT) | (u64)r);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd((unsigned*)(a.scratch + DONE), 1u);
}

// Warp 0 reads the owner words of words [p, hi) into s_own,
// where the pass spans at most OWN_CACHE blocks: once a CTA, for the CTAs
// of a 15/16 block would all read one word, and queue on its L2 slice.
template <typename I>
__device__ __forceinline__ void load_owners(const u64* owner, u64* s_own,
                                            I p, I hi, I n) {
  const I b_lo = p / n;
  const I nbk = (hi - 1) / n - b_lo + 1;
  if (nbk <= OWN_CACHE)
    for (I i = threadIdx.x; i < nbk; i += 32)
      s_own[i] = ld_u64(owner + b_lo + i);
}

// Output ticket u: words [u * PASS, min((u + 1) * PASS, total)) of the
// flat output, the owner words of their blocks already in s_own.
template <typename I>
__device__ void write_pass(const Args& a, const u64* owner, I u,
                           const u64* s_own) {
  const int tid = threadIdx.x;
  const I n = (I)a.n, total = (I)a.total;
  const I p = u * PASS;
  const I hi = p + PASS < total ? p + PASS : total;
  const I b_lo = p / n;
  const bool cached = (hi - 1) / n - b_lo < OWN_CACHE;
  I w[G], b[G];
  u64 own[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    w[j] = p + ((I)j * THREADS + tid) * 8;
    b[j] = w[j] < hi ? w[j] / n : 0;
    own[j] = w[j] >= hi ? 0
             : cached  ? s_own[b[j] - b_lo]
                       : ld_u64(owner + b[j]);
  }
  // every load of the pass issued before any is used
  uint4 raw[G];
  int mode[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    raw[j] = make_uint4(0, 0, 0, 0);
    const I o = w[j] - b[j] * n;  // word within the block
    if (w[j] >= hi) {
      mode[j] = M_NONE;
    } else if (w[j] + 8 > hi || o + 8 > n) {
      mode[j] = M_SLOW;
    } else if ((own[j] >> EPOCH_SHIFT) != a.epoch) {
      mode[j] = M_ZERO;
    } else {
      int c;
      const void* row = source(a, own[j], c);
      mode[j] = M_SLOW;
      if (c == 2) {
        const int16_t* q = (const int16_t*)row + o;
        if (((uintptr_t)q & 15) == 0) {
          raw[j] = __ldg((const uint4*)q);
          mode[j] = M_16;
        }
      } else if (c == 1) {
        const int8_t* q = (const int8_t*)row + o;
        if (((uintptr_t)q & 7) == 0) {
          const uint2 x = __ldg((const uint2*)q);
          raw[j].x = x.x, raw[j].y = x.y;
          mode[j] = M_8;
        }
      } else {
        const int8_t* q = (const int8_t*)row + (o >> 1);
        if ((o & 1) == 0 && ((uintptr_t)q & 3) == 0) {
          raw[j].x = __ldg((const uint32_t*)q);
          mode[j] = M_4;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    int16_t* dst = a.out + w[j];
    uint4 v = raw[j];
    if (mode[j] == M_8) {
      int s[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] = (int)(raw[j].x << (24 - 8 * k)) >> 24;
        s[4 + k] = (int)(raw[j].y << (24 - 8 * k)) >> 24;
      }
      v = make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]),
                     pack2(s[4], s[5]), pack2(s[6], s[7]));
    } else if (mode[j] == M_4) {
      int s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = (int)(raw[j].x << (28 - 4 * k)) >> 28;
      v = make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]),
                     pack2(s[4], s[5]), pack2(s[6], s[7]));
    }
    if (mode[j] == M_SLOW) {
      for (int k = 0; k < 8 && w[j] + k < hi; ++k)
        dst[k] = word_at(a, owner, (long long)(w[j] + k));
    } else if (mode[j] != M_NONE) {
      *(uint4*)dst = v;  // M_ZERO: raw is zeros
    }
  }
}

// One CTA's ticket. Warp 0 takes it and, for an output ticket, waits for
// the stamps and reads the pass's owner words, so that the CTA crosses
// one barrier before its loads. I is the index type: 32-bit where
// every index of the call fits (all real chunks), else 64-bit.
template <typename I>
__device__ void run(const Args& a) {
  __shared__ unsigned s_ticket;
  __shared__ u64 s_own[OWN_CACHE];
  u64* owner = a.scratch + OWNERS;
  if (threadIdx.x < 32) {
    unsigned t = 0;
    if (threadIdx.x == 0) t = atomicAdd((unsigned*)a.scratch, 1u) - a.ticket0;
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= a.nstamp) {
      // every lane reads the one word: one request a poll
      const unsigned* done = (const unsigned*)(a.scratch + DONE);
      while (ld_u32(done) - a.done0 < a.nstamp) __nanosleep(32);
      __threadfence();
      const I p = (I)(t - a.nstamp) * PASS;
      const I hi = p + PASS < (I)a.total ? p + PASS : (I)a.total;
      load_owners(owner, s_own, p, hi, (I)a.n);
    }
    if (threadIdx.x == 0) s_ticket = t;
  }
  __syncthreads();
  const unsigned t = s_ticket;
  if (t < a.nstamp)
    stamp(a, owner, t);
  else
    write_pass<I>(a, owner, t - a.nstamp, s_own);
}

// Six CTAs an SM (at most 40 registers a thread): each holds its loads in
// flight, and five leave the memory system less to do.
__global__ void __launch_bounds__(THREADS, 6) unpack_blocks_kernel(Args a) {
  if (a.total + 2 * PASS <= 0xffffffffll)
    run<unsigned>(a);
  else
    run<u64>(a);
}

}  // namespace

extern "C" {

// Pointers are device memory (a class with no rows may pass null; `out`
// 16-byte aligned); `scratch` is ops/unpack_blocks_cuda.py's, of at least
// OWNERS + nb words. `grid` = nstamp + ceil(nb * n / PASS) CTAs. Returns
// cudaGetLastError() after the launch (0 on success).
int acm_unpack_blocks(const void* p4, const void* p8, const void* p16,
                      const void* idx4, const void* idx8, const void* idx16,
                      void* out, void* scratch, long long n4, long long n8,
                      long long n16, long long nb, long long n,
                      long long nstamp, long long grid,
                      long long epoch, long long ticket0, long long done0,
                      void* stream) {
  Args a;
  a.p4 = (const int8_t*)p4;
  a.p8 = (const int8_t*)p8;
  a.p16 = (const int16_t*)p16;
  a.idx4 = (const int32_t*)idx4;
  a.idx8 = (const int32_t*)idx8;
  a.idx16 = (const int32_t*)idx16;
  a.out = (int16_t*)out;
  a.scratch = (u64*)scratch;
  a.n4 = n4, a.n8 = n8, a.n16 = n16, a.nb = nb, a.n = n;
  a.total = nb * n;
  a.nstamp = (unsigned)nstamp;
  a.ticket0 = (unsigned)ticket0;
  a.done0 = (unsigned)done0;
  a.epoch = (u64)epoch;
  unpack_blocks_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
