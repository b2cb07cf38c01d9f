// Parquet page-decode kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/parquet_decode.py).
//
// K3 `plain_gather` replaces the TPU kernel
// spark_rapids_jni_tpu/ops/parquet_decode.py::_asm_kernel (four
// little-endian bytes -> one u32 word) together with the byte gather of
// ::_plain_gather around it.  On the TPU the gather and the assembly are
// two passes because the Pallas kernel wants a contiguous (blk, 512) byte
// block; on a GPU assembling a contiguous buffer is a free `view`, so the
// kernel is worth having only fused with the gather: one thread per output
// value reads its `size` (4 or 8) bytes at
//     clip(voff[r] + max(nn[r, v], 0) * size + k, 0, UB - 1)
// (each byte offset clipped on its own, in wrapping 32-bit arithmetic,
// exactly as the JAX package computes it) and writes one int32 or one
// int64.  Bound: bytes.  It reads R*V*size page bytes and R*V int32 slot
// ordinals and writes R*V*size bytes, so the least time is
// R*V*(4 + 2*size) / 3.35e12 s.  Values follow a def-level stream of any
// length, so they are not 4-byte aligned: the kernel loads bytes.
// Consecutive threads take consecutive slots, whose bytes are consecutive
// addresses, so the byte loads of a warp still coalesce into few sectors.
//
// W1 `snappy_walk` and W2 `hybrid_decode` replace the header walks that the
// JAX package writes as `jax.lax.while_loop`s vmapped over pages: W1
// ::_snappy_pass1 (:130), W2 ::_hybrid_pass1 (:247) together with the
// per-slot expansion of ::_rle_hybrid (:300).  Bound: bytes.  W1 reads the
// compressed bytes and writes 12 * R * tb table bytes; W2 reads the stream
// bytes [start, end) of each row and writes R * vb * 8 value bytes: a few
// microseconds at 3.35 TB/s.  What keeps a walk from that bound is its
// chain: each header's position depends on the one before it, so a walk
// costs its length times one dependent load.  A thread that reads each
// header from device memory pays a round trip (300-400 cycles) a step.
//
// The design: one block (4 warps) per page row.  The block loads a window
// of kWin stream bytes into shared memory, every byte as the clipped read
// row[clip(w + j, 0, UB - 1)] in wrapping 32-bit arithmetic, so the window
// holds exactly what the clipped reads of the JAX walk would see, torn or
// wrapped positions included.  The threads then decode a candidate header
// at every window offset in parallel ("each lane decodes a header ahead"),
// which gives one next-pointer per byte (and, where the last window's chain
// was long, the offsets 2, 3 and 4 hops on); thread 0 follows them (one
// shared-memory round trip per four hops) and lists the chain; the block
// decodes the listed headers in parallel, scans their value (or output
// byte) counts, applies the walk's stop conditions in order and writes the
// records.  A window costs one device-memory round trip, not one per run,
// and the window after it is prefetched into registers while the chain is
// chased.  A header whose next position leaves the window (a long literal,
// a long bit-packed run) is taken without the per-byte decode: thread 0
// follows it and every successor that also jumps past a window straight
// from device memory, one read a header and no block syncs between them
// (a chain of far jumps cannot do better: nothing can be read ahead of
// it) and stages up to kFar of them for one batch; the window at the first
// one's successor is prefetched meanwhile.  Both kinds of batch go through
// one call site (inlined twice, the batch slowed the walk of pages with
// many short tokens).
//
// W2 then expands the runs without any [R, vb] table.  The walk keeps a
// compact per-row table of runs (first slot, packed flag, payload), one
// entry per slot it writes, in walk order; while the first slots rise, the
// table is sorted and the last write to a slot (several runs past vb - 1
// all land on slot vb - 1) simply overwrites the table's last entry.  A
// second launch, over (slot tile, row), gives every slot the last table
// entry at or before it by binary search (what the JAX walk's mark plane
// and `cummax` give it) and extracts the value.  A torn stream whose value
// count wraps writes slots out of order (a wrapped negative count lands on
// slot 0); such a row, or one whose table would overflow, is walked again
// writing its entries straight into the row's output slots in walk order
// (last write wins), and the block resolves it with a prefix maximum over
// the slots.  Arithmetic is 32-bit with wrap-around (done in uint32_t and
// read back as int32_t) throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t wrap(uint32_t x) { return (int32_t)x; }
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return wrap((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return wrap((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return wrap((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t shl32(int32_t a, int s) {
  return wrap((uint32_t)a << s);
}
__device__ __forceinline__ int32_t clip32(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- K3 -------------------------------------------------------------------

template <int SIZE>
__global__ void __launch_bounds__(256)
plain_gather_kernel(const uint8_t* __restrict__ unc,
                    const int32_t* __restrict__ voff,
                    const int32_t* __restrict__ nn,
                    void* __restrict__ out, long long total, int V, int UB) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / V;
  const uint8_t* row = unc + r * (long long)UB;
  const int32_t n = nn[i];
  const int32_t base = add32(voff[r], mul32(n > 0 ? n : 0, SIZE));
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < SIZE; ++k) {
    const int32_t off = clip32(add32(base, k), 0, UB - 1);
    w |= (uint64_t)row[off] << (8 * k);
  }
  if (SIZE == 4) {
    reinterpret_cast<uint32_t*>(out)[i] = (uint32_t)w;
  } else {
    reinterpret_cast<uint64_t*>(out)[i] = w;
  }
}

// ---- the windowed walk, shared by W1 and W2 ----------------------------------

constexpr int kWalkThreads = 128;             // one block of 4 warps a row
constexpr int kWin = 2048;                    // window bytes
constexpr int kChain = 2048;                  // chain entries per batch
constexpr int kPre = kWin / kWalkThreads;     // prefetched bytes per thread
constexpr uint16_t kOut = 0xFFFF;             // a hop that leaves the window
constexpr int kMultiHop = 256;  // batch length worth the 2-4 hop tables
constexpr int kFar = 32;        // far headers thread 0 takes a batch

struct __align__(16) WalkShared {
  uint8_t buf[kWin];           // the window: buf[j] = row[clip(w + j)]
  int32_t step[kWin];          // next position - position, per offset
                               // (a far batch: the headers' positions)
  uint16_t hop[4][kWin];       // offset 1, 2, 3, 4 hops on, or kOut
  uint16_t chain[kChain + kChain / 32];  // this batch's header offsets
  int32_t acc[kChain + kChain / 32];     // per header: count, then total
  int32_t red[kWalkThreads / 32];
  int32_t ctl[4];
  int32_t carry[4];
};

// Batch record k lives at sk(k): thread t takes records [t*seg, (t+1)*seg)
// with seg a power of two, and the skew keeps a warp's accesses on
// distinct banks.
__device__ __forceinline__ int sk(int k) { return k + (k >> 5); }

__device__ __forceinline__ int seg_for(int K) {
  int seg = 1;
  while (seg * kWalkThreads < K) seg <<= 1;
  return seg;
}

__device__ __forceinline__ int32_t warp_incl_sum(int32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = add32(x, y);
  }
  return x;
}

// Exclusive prefix sum over the block in thread order (wrapping); *total
// receives the block's sum.  Every thread must call it.
__device__ int32_t block_excl_sum(int32_t x, int32_t* red, int32_t* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int32_t inc = warp_incl_sum(x);
  if (lane == 31) red[wid] = inc;
  __syncthreads();
  int32_t base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWalkThreads / 32; ++w) {
    if (w < wid) base = add32(base, red[w]);
    tot = add32(tot, red[w]);
  }
  __syncthreads();
  *total = tot;
  return add32(base, sub32(inc, x));
}

__device__ int32_t block_min(int32_t x, int32_t* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[wid] = x;
  __syncthreads();
  int32_t m = red[0];
#pragma unroll
  for (int w = 1; w < kWalkThreads / 32; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

// Inclusive prefix maximum over the block in thread order.
__device__ int32_t block_incl_max(int32_t x, int32_t* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) red[wid] = x;
  __syncthreads();
  for (int w = 0; w < wid; ++w) x = max(x, red[w]);
  __syncthreads();
  return x;
}

// One window's worth of clipped byte reads, kPre a thread, held in
// registers: issued before the chain is chased, stored when it is needed.
struct Prefetch {
  int32_t w;
  uint32_t b[kPre];
  __device__ __forceinline__ void issue(const uint8_t* row, int UB,
                                        int32_t at) {
    w = at;
#pragma unroll
    for (int q = 0; q < kPre; ++q)
      b[q] = row[clip32(add32(at, threadIdx.x + q * kWalkThreads), 0,
                        UB - 1)];
  }
  __device__ __forceinline__ void store(uint8_t* buf) const {
#pragma unroll
    for (int q = 0; q < kPre; ++q)
      buf[threadIdx.x + q * kWalkThreads] = (uint8_t)b[q];
  }
};

// Walks the chain s -> s + step_at(header at s) while s < send, window by
// window.  `step_at(p)` decodes the header whose bytes start at p (HDR
// bytes) and returns the wrapping distance to the next one.  `batch(K, w,
// pos)` consumes the headers at sm.buf + sm.chain[sk(k)], k < K, whose
// stream positions are w + sm.chain[sk(k)] (pos == nullptr) or pos[k], and
// returns false once the walk is over.  Called by the whole block.
template <int HDR, class StepAt, class Batch>
__device__ void walk_chain(WalkShared& sm, const uint8_t* row, int UB,
                           int32_t s, const int32_t send, StepAt step_at,
                           Batch batch) {
  constexpr uint32_t kLast = kWin - HDR;  // last offset a header fits at
  const int t = threadIdx.x;
  if (!(s < send)) return;
  Prefetch pf;
  pf.issue(row, UB, s);
  int32_t w = s;
  bool loaded = false;   // sm.buf holds the window at w
  bool stepped = false;  // sm.step and sm.hop hold this window's pointers
  bool multi = false;    // ... and the 2-4 hop ones
  int last_k = kChain;   // headers in the last batch
  while (s < send) {
    uint32_t off = (uint32_t)s - (uint32_t)w;
    if (!loaded || off > kLast) {  // (re)load the window at the chain
      __syncthreads();
      if ((uint32_t)s - (uint32_t)pf.w > kLast) pf.issue(row, UB, s);
      pf.store(sm.buf);
      w = pf.w;
      loaded = true;
      stepped = false;
      off = (uint32_t)s - (uint32_t)w;
      __syncthreads();
    }
    bool far = false;  // this batch: headers thread 0 follows alone
    if (!stepped) {
      if (t == 0) {
        const int32_t st = step_at(sm.buf + off);
        const int32_t s1 = add32(s, st);
        sm.ctl[0] = ((uint32_t)s1 - (uint32_t)w > kLast || !(s1 < send));
        sm.ctl[1] = st;
      }
      __syncthreads();
      far = sm.ctl[0];
      // prefetch the window that follows: at a far header's successor, or
      // right after this window
      pf.issue(row, UB, far ? add32(s, sm.ctl[1])
                            : add32(w, (int32_t)kLast + 1));
      if (!far) {
        // every offset's next header (kOut where it leaves the window or
        // reaches send); where the chains ran long, the offsets 2, 3 and 4
        // hops on as well
        for (int p = t; p <= (int)kLast; p += kWalkThreads) {
          const int32_t st = step_at(sm.buf + p);
          const uint32_t q = (uint32_t)p + (uint32_t)st;
          sm.step[p] = st;
          sm.hop[0][p] = q <= kLast && add32(w, (int32_t)q) < send
                             ? (uint16_t)q : kOut;
        }
        multi = last_k >= kMultiHop;
        if (multi) {
          __syncthreads();
          for (int p = t; p <= (int)kLast; p += kWalkThreads) {
            const uint16_t a = sm.hop[0][p];
            sm.hop[1][p] = a == kOut ? kOut : sm.hop[0][a];
          }
          __syncthreads();
          for (int p = t; p <= (int)kLast; p += kWalkThreads) {
            const uint16_t b = sm.hop[1][p];
            sm.hop[2][p] = b == kOut ? kOut : sm.hop[0][b];
            sm.hop[3][p] = b == kOut ? kOut : sm.hop[1][b];
          }
        }
        stepped = true;
        __syncthreads();
      }
    }
    if (t == 0 && far) {
      // the header's successor leaves the window: thread 0 takes it, and
      // every successor that is as far, one device-memory read a header
      // with no block syncs in between, staging each header's bytes in
      // sm.buf and its position in sm.step
      uint8_t h[HDR];
#pragma unroll
      for (int j = 0; j < HDR; ++j) h[j] = sm.buf[off + j];
      int k = 0;
      int32_t p = s, st = sm.ctl[1];
      while (true) {
#pragma unroll
        for (int j = 0; j < HDR; ++j) sm.buf[k * HDR + j] = h[j];
        sm.chain[sk(k)] = (uint16_t)(k * HDR);
        sm.step[k] = p;
        ++k;
        const bool jump = (uint32_t)st > kLast;
        p = add32(p, st);
        if (!jump || k == kFar || !(p < send)) break;
#pragma unroll
        for (int j = 0; j < HDR; ++j)
          h[j] = row[clip32(add32(p, j), 0, UB - 1)];
        st = step_at(h);
        // a near successor: the window loaded at p takes it
        if ((uint32_t)st <= kLast && add32(p, st) < send) break;
      }
      sm.ctl[2] = k;
      sm.ctl[3] = p;
    } else if (t == 0) {
      // kOut carries over, so a fourth hop in the window means all four
      // are: four hops a shared-memory round trip while they last, then
      // single hops to the window's end (or the batch's)
      int k = 0;
      uint32_t o = off;
      int32_t next;
      sm.chain[sk(k++)] = (uint16_t)o;
      if (multi) {
        while (k <= kChain - 4) {
          const uint16_t h0 = sm.hop[0][o], h1 = sm.hop[1][o],
                         h2 = sm.hop[2][o], h3 = sm.hop[3][o];
          if (h3 == kOut) break;
          sm.chain[sk(k)] = h0;
          sm.chain[sk(k + 1)] = h1;
          sm.chain[sk(k + 2)] = h2;
          sm.chain[sk(k + 3)] = h3;
          k += 4;
          o = h3;
        }
      }
      while (true) {
        const uint16_t h = sm.hop[0][o];
        if (h == kOut) {
          next = add32(add32(w, (int32_t)o), sm.step[o]);
          break;
        }
        if (k == kChain) {
          next = add32(w, (int32_t)h);
          break;
        }
        sm.chain[sk(k++)] = h;
        o = h;
      }
      sm.ctl[2] = k;
      sm.ctl[3] = next;
    }
    __syncthreads();
    const int K = sm.ctl[2];
    const int32_t next = sm.ctl[3];
    if (far) loaded = false;  // the staged headers overwrote the window
    if (!batch(K, w, far ? sm.step : nullptr)) return;
    last_k = K;
    s = next;
  }
}

// One thread follows `hops` next-pointers through a shared-memory table:
// one dependent shared-memory load a hop, the step that a walk taking one
// hop a load cannot go below.  Timed on the card only; no decode runs it.
__global__ void hop_probe_kernel(int hops, int32_t* __restrict__ out) {
  __shared__ uint16_t nxt[kWin];
  for (int p = threadIdx.x; p < kWin; p += blockDim.x)
    nxt[p] = (uint16_t)((p + 1) & (kWin - 1));
  __syncthreads();
  if (threadIdx.x) return;
  uint32_t o = 0;
#pragma unroll 8
  for (int i = 0; i < hops; ++i) o = nxt[o];
  out[0] = (int32_t)o;
}

// ---- W1 -------------------------------------------------------------------

struct Tok {
  int32_t step;  // bytes to the next token
  int32_t len;   // output bytes
  int32_t nlb;   // extra literal-length bytes
  int32_t off;   // copy offset, floored at 1
  bool lit;
};

__device__ __forceinline__ Tok snappy_token(const uint8_t* b) {
  const int32_t tag = b[0];
  const int32_t kind = tag & 3;
  const int32_t lcode = tag >> 2;
  const int32_t nlb = clip32(lcode - 59, 0, 4);
  const int32_t e0 = b[1], e1 = b[2], e2 = b[3], e3 = b[4];
  const int32_t extra = e0 | shl32(e1, 8) | shl32(e2, 16) | shl32(e3, 24);
  const int32_t emask = nlb >= 4 ? -1 : shl32(1, 8 * min(nlb, 3)) - 1;
  const int32_t lit_len = lcode < 60 ? lcode + 1 : add32(extra & emask, 1);
  const int32_t len1 = ((tag >> 2) & 7) + 4;
  const int32_t off1 = ((tag & 0xE0) << 3) | e0;
  const int32_t off2 = e0 | (e1 << 8);
  int32_t cp_off = kind == 1 ? off1 : (kind == 2 ? off2 : extra);
  cp_off = cp_off > 1 ? cp_off : 1;  // 0 is the literal marker
  const int32_t cp_len = kind == 1 ? len1 : lcode + 1;
  const int32_t cp_adv = kind == 1 ? 2 : (kind == 2 ? 3 : 5);
  Tok tk;
  tk.lit = kind == 0;
  tk.step = tk.lit ? add32(1 + nlb, lit_len) : cp_adv;
  tk.len = tk.lit ? lit_len : cp_len;
  tk.nlb = nlb;
  tk.off = cp_off;
  return tk;
}

__global__ void __launch_bounds__(kWalkThreads)
snappy_walk_kernel(const uint8_t* __restrict__ comp,
                   const int32_t* __restrict__ clen,
                   const int32_t* __restrict__ ulen, int CB, int tb, int ub,
                   int32_t* __restrict__ dk, int32_t* __restrict__ ls,
                   int32_t* __restrict__ co) {
  __shared__ WalkShared sm;
  const int r = blockIdx.x, t = threadIdx.x;
  const uint8_t* row = comp + (long long)r * CB;
  // uvarint preamble (the uncompressed length): skip 1-5 bytes
  int32_t c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = (int32_t)row[min(k, CB - 1)] >> 7;
  const int32_t s0 = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] +
                     c[0] * c[1] * c[2] * c[3];
  const int32_t ul = ulen[r];
  int32_t* dkr = dk + (long long)r * tb;
  int32_t* lsr = ls + (long long)r * tb;
  int32_t* cor = co + (long long)r * tb;
  int32_t d = 0, kk = 0;  // output bytes and tokens so far

  auto step_at = [](const uint8_t* b) { return snappy_token(b).step; };
  auto batch = [&](int K, int32_t w, const int32_t* pos) -> bool {
    const int seg = seg_for(K), k0 = t * seg;
    int32_t sum = 0;
    for (int j = 0; j < seg; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const int32_t len = snappy_token(sm.buf + sm.chain[sk(k)]).len;
        sm.acc[sk(k)] = len;
        sum = add32(sum, len);
      }
    }
    int32_t tot;
    int32_t dd = add32(d, block_excl_sum(sum, sm.red, &tot));
    const int32_t room = tb - kk;  // the `k < tb` bound
    int first = K;
    for (int j = 0; j < seg; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const int32_t len = sm.acc[sk(k)];
        sm.acc[sk(k)] = dd;
        if (first == K && !(dd < ul && k < room)) first = k;
        dd = add32(dd, len);
      }
    }
    const int kn = block_min(first, sm.red);
    for (int j = 0; j < seg; ++j) {
      const int k = k0 + j;
      if (k < kn) {
        const int o = sm.chain[sk(k)];
        const Tok tk = snappy_token(sm.buf + o);
        const int32_t at = pos ? pos[k] : add32(w, o);
        dkr[kk + k] = sm.acc[sk(k)];
        lsr[kk + k] = tk.lit ? add32(at, 1 + tk.nlb) : 0;
        cor[kk + k] = tk.lit ? 0 : tk.off;
      }
    }
    d = kn < K ? sm.acc[sk(kn)] : add32(d, tot);
    kk += kn;
    __syncthreads();
    return kn == K;
  };
  walk_chain<5>(sm, row, CB, s0, clen[r], step_at, batch);
  for (int k = kk + t; k < tb; k += kWalkThreads) {  // unused entries
    dkr[k] = ub;
    lsr[k] = 0;
    cor[k] = 0;
  }
}

// ---- W2 -------------------------------------------------------------------

struct Run {
  int32_t hlen;    // header bytes (a 1-5 byte uvarint)
  int32_t groups;  // header >> 1
  int32_t raw;     // the four bytes after the header, little-endian
  bool packed;
};

__device__ __forceinline__ Run hybrid_run(const uint8_t* b) {
  int32_t c[5], seg[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int32_t x = b[k];
    c[k] = x >> 7;
    seg[k] = x & 0x7F;
  }
  int32_t h = seg[0];
  h = add32(h, c[0] * (seg[1] << 7));
  h = add32(h, c[0] * c[1] * (seg[2] << 14));
  h = add32(h, c[0] * c[1] * c[2] * (seg[3] << 21));
  h = add32(h, c[0] * c[1] * c[2] * c[3] * shl32(seg[4], 28));
  Run run;
  run.hlen = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] +
             c[0] * c[1] * c[2] * c[3];
  const uint8_t* dp = b + run.hlen;
  run.raw = (int32_t)dp[0] | shl32(dp[1], 8) | shl32(dp[2], 16) |
            shl32(dp[3], 24);
  run.packed = (h & 1) == 1;
  run.groups = h >> 1;
  return run;
}

__device__ __forceinline__ int32_t run_count(const Run& run) {
  const int32_t cnt = run.packed ? mul32(run.groups, 8) : run.groups;
  return cnt > 1 ? cnt : 1;  // corrupt zero-count header: still advance
}

// A run's table entry: bit 32 packed, bits 0-31 the payload (the bit
// offset of a packed run's values, or an RLE run's value); the compact
// table keeps the run's first slot in bits 33-63, the per-slot form sets
// bit 33 to mark a written slot.
__device__ __forceinline__ uint64_t run_entry(const Run& run, int32_t at,
                                              int32_t vmask) {
  const uint32_t payload = run.packed
                               ? (uint32_t)mul32(add32(at, run.hlen), 8)
                               : (uint32_t)(run.raw & vmask);
  return ((uint64_t)run.packed << 32) | payload;
}

// Slot i's value from its run's entry (`first` = the run's first slot).
__device__ __forceinline__ uint32_t run_value(const uint8_t* row, int UB,
                                              int32_t bw, uint32_t bwm,
                                              uint64_t ent, int32_t first,
                                              int32_t i) {
  const uint32_t payload = (uint32_t)ent;
  if (!((ent >> 32) & 1)) return payload;
  const int32_t bit = add32((int32_t)payload, mul32(i - first, bw));
  const int32_t byte0 = bit >> 3;
  const uint32_t sh = (uint32_t)(bit & 7);
  uint32_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) b[k] = row[clip32(add32(byte0, k), 0, UB - 1)];
  const uint32_t lo = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  const uint32_t hi = sh ? (b[4] << (32 - sh)) : 0u;  // the straddle byte
  return ((lo >> sh) | hi) & bwm;
}

__device__ __forceinline__ uint32_t width_mask(int32_t bw) {
  return (bw >= 32 || bw < 0) ? 0xFFFFFFFFu : ((1u << bw) - 1u);
}

// Walks one row's runs.  kDense = false: into the compact table `trow`
// (returns false, with the table abandoned, as soon as a first slot falls
// or the table would pass `cap`); kDense = true: each run's entry straight
// into its slot of the zeroed output row, in walk order.
template <bool kDense>
__device__ bool hybrid_runs_row(WalkShared& sm, const uint8_t* row, int UB,
                                int32_t s0, int32_t e, int32_t bw, int32_t n,
                                int vb, int cap, uint64_t* trow,
                                int64_t* orow, int32_t* count) {
  const int t = threadIdx.x;
  const int32_t bwb = add32(bw, 7) >> 3;  // RLE value byte width
  const int32_t vmask = (bwb >= 4 || bwb < 0) ? -1 : shl32(1, 8 * bwb) - 1;
  int32_t v = 0, it = 0, last = -1, tcount = 0;
  bool ok = true;

  auto step_at = [&](const uint8_t* b) {
    const Run run = hybrid_run(b);
    return add32(run.hlen, run.packed ? mul32(run.groups, bw) : bwb);
  };
  auto batch = [&](int K, int32_t w, const int32_t* pos) -> bool {
    const int seg = seg_for(K), k0 = t * seg;
    int32_t sum = 0;
    for (int j = 0; j < seg; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const int32_t cnt = run_count(hybrid_run(sm.buf + sm.chain[sk(k)]));
        sm.acc[sk(k)] = cnt;
        sum = add32(sum, cnt);
      }
    }
    int32_t tot;
    int32_t vv = add32(v, block_excl_sum(sum, sm.red, &tot));
    // `it < n` never binds while v grows (v >= it); it only stops a walk
    // whose 32-bit value count wrapped, which could otherwise spin forever
    const int32_t room = n - it;
    int first = K;
    for (int j = 0; j < seg; ++j) {
      const int k = k0 + j;
      if (k < K) {
        const int32_t cnt = sm.acc[sk(k)];
        sm.acc[sk(k)] = vv;
        if (first == K && !(vv < n && k < room)) first = k;
        vv = add32(vv, cnt);
      }
    }
    const int kn = block_min(first, sm.red);
    auto slot = [&](int k) { return clip32(sm.acc[sk(k)], 0, vb - 1); };
    auto entry = [&](int k) {
      const int o = sm.chain[sk(k)];
      return run_entry(hybrid_run(sm.buf + o), pos ? pos[k] : add32(w, o),
                       vmask);
    };
    if constexpr (kDense) {
      if (t == 0) {
        for (int k = 0; k < kn; ++k)
          orow[slot(k)] = (int64_t)((1ull << 33) | entry(k));
      }
      __syncthreads();
    } else {
      // entry index of each run: one more per new first slot; a run whose
      // first slot repeats the one before it overwrites that entry
      int32_t nnew = 0, bad = 0;
      for (int j = 0; j < seg; ++j) {
        const int k = k0 + j;
        if (k < kn) {
          const int32_t vc = slot(k), prev = k ? slot(k - 1) : last;
          bad |= vc < prev;
          nnew += vc != prev;
        }
      }
      int32_t newtot;
      int32_t idx = tcount - 1 + block_excl_sum(nnew, sm.red, &newtot);
      for (int j = 0; j < seg; ++j) {
        const int k = k0 + j;
        if (k < kn) {
          const int32_t vc = slot(k), prev = k ? slot(k - 1) : last;
          idx += vc != prev;
          if (k == kn - 1 || slot(k + 1) != vc) {  // the slot's last run
            if (idx >= cap)
              bad = 1;
            else
              trow[idx] = ((uint64_t)vc << 33) | entry(k);
          }
        }
      }
      if (-block_min(-bad, sm.red)) {
        ok = false;
        return false;
      }
      tcount += newtot;
      if (kn > 0) last = slot(kn - 1);
    }
    v = kn < K ? sm.acc[sk(kn)] : add32(v, tot);
    it += kn;
    __syncthreads();
    return kn == K;
  };
  walk_chain<9>(sm, row, UB, s0, e, step_at, batch);
  *count = tcount;
  return ok;
}

// Resolves a row walked in the per-slot form: slot i takes the last written
// slot at or before it (slot 0 where there is none) and extracts its value.
__device__ void hybrid_resolve_row(WalkShared& sm, const uint8_t* row, int UB,
                                   int32_t bw, int32_t n, int vb,
                                   int64_t* orow) {
  const int t = threadIdx.x;
  const uint32_t bwm = width_mask(bw);
  uint64_t* ent = reinterpret_cast<uint64_t*>(sm.step);
  int32_t carry_at = -1;
  uint64_t carry_ent = 0;
  for (int base = 0; base < vb; base += kWalkThreads) {
    const int i = base + t;
    const uint64_t e = i < vb ? (uint64_t)orow[i] : 0ull;
    ent[t] = e;
    int32_t at = block_incl_max(i < vb && ((e >> 33) & 1) ? i : -1, sm.red);
    at = max(at, carry_at);
    const uint64_t mine =
        at < 0 ? 0ull : (at >= base ? ent[at - base] : carry_ent);
    if (i < vb)
      orow[i] = i < n ? (int64_t)run_value(row, UB, bw, bwm, mine,
                                           max(at, 0), i)
                      : 0;
    if (t == kWalkThreads - 1) {
      sm.carry[0] = at;
      reinterpret_cast<uint64_t*>(sm.carry)[1] = mine;
    }
    __syncthreads();
    carry_at = sm.carry[0];
    carry_ent = reinterpret_cast<uint64_t*>(sm.carry)[1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWalkThreads)
hybrid_runs_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ start,
                   const int32_t* __restrict__ end,
                   const int32_t* __restrict__ bw_,
                   const int32_t* __restrict__ n_, int UB, int vb, int cap,
                   uint64_t* __restrict__ tbl, int32_t* __restrict__ meta,
                   int64_t* __restrict__ out) {
  __shared__ WalkShared sm;
  const int r = blockIdx.x, t = threadIdx.x;
  const uint8_t* row = data + (long long)r * UB;
  const int32_t bw = bw_[r], n = n_[r];
  int64_t* orow = out + (long long)r * vb;
  int32_t count = 0;
  if (hybrid_runs_row<false>(sm, row, UB, start[r], end[r], bw, n, vb, cap,
                             tbl + (long long)r * cap, orow, &count)) {
    if (t == 0) {
      meta[2 * r] = count;
      meta[2 * r + 1] = 0;
    }
    return;
  }
  for (int i = t; i < vb; i += kWalkThreads) orow[i] = 0;
  __syncthreads();
  hybrid_runs_row<true>(sm, row, UB, start[r], end[r], bw, n, vb, cap,
                        nullptr, orow, &count);
  __syncthreads();
  hybrid_resolve_row(sm, row, UB, bw, n, vb, orow);
  if (t == 0) {
    meta[2 * r] = 0;
    meta[2 * r + 1] = 1;
  }
}

constexpr int kTile = 1024;       // slots per expansion block
constexpr int kExpandThreads = 256;

// The last entry of t[0, m) whose first slot is <= i, or -1.
__device__ __forceinline__ int last_at_or_before(const uint64_t* t, int m,
                                                 int32_t i) {
  int lo = 0, hi = m;  // answer + 1 lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int32_t)(t[mid] >> 33) <= i) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(kExpandThreads)
hybrid_expand_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ bw_,
                     const int32_t* __restrict__ n_, int UB, int vb, int cap,
                     const uint64_t* __restrict__ tbl,
                     const int32_t* __restrict__ meta,
                     int64_t* __restrict__ out) {
  __shared__ uint64_t st[kTile];
  __shared__ int range[2];
  const int r = blockIdx.y, t = threadIdx.x;
  if (meta[2 * r + 1]) return;  // resolved by the walk
  const int J = meta[2 * r];
  const uint64_t* trow = tbl + (long long)r * cap;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(t0 + kTile, vb);
  if (t < 2) range[t] = last_at_or_before(trow, J, t ? t1 - 1 : t0);
  __syncthreads();
  // first slots rise strictly, so at most kTile entries meet the tile
  const int klo = range[0];
  const int m = klo < 0 ? 0 : range[1] - klo + 1;
  for (int j = t; j < m; j += kExpandThreads) st[j] = trow[klo + j];
  __syncthreads();
  const uint8_t* row = data + (long long)r * UB;
  const int32_t bw = bw_[r], n = n_[r];
  const uint32_t bwm = width_mask(bw);
  for (int i = t0 + t; i < t1; i += kExpandThreads) {
    uint32_t val = 0;
    if (i < n) {
      const int k = m ? last_at_or_before(st, m, i) : -1;
      const uint64_t ent = k < 0 ? 0ull : st[k];
      val = run_value(row, UB, bw, bwm, ent, (int32_t)(ent >> 33), i);
    }
    out[(long long)r * vb + i] = (int64_t)val;
  }
}

}  // namespace

extern "C" {

int srjt_plain_gather(const void* unc, const void* voff, const void* nn,
                      void* out, long long total, int V, int UB, int size,
                      void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* u = (const uint8_t*)unc;
  const int32_t* vo = (const int32_t*)voff;
  const int32_t* n = (const int32_t*)nn;
  if (size == 4) {
    plain_gather_kernel<4><<<blocks, threads, 0, s>>>(u, vo, n, out, total,
                                                      V, UB);
  } else if (size == 8) {
    plain_gather_kernel<8><<<blocks, threads, 0, s>>>(u, vo, n, out, total,
                                                      V, UB);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int srjt_snappy_walk(const void* comp, const void* clen, const void* ulen,
                     int R, int CB, int tb, int ub, void* dk, void* ls,
                     void* co, void* stream) {
  if (R <= 0) return 0;
  snappy_walk_kernel<<<R, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clen, (const int32_t*)ulen, CB,
      tb, ub, (int32_t*)dk, (int32_t*)ls, (int32_t*)co);
  return (int)cudaGetLastError();
}

int srjt_hop_probe(int hops, void* out, void* stream) {
  hop_probe_kernel<<<1, kWalkThreads, 0, (cudaStream_t)stream>>>(
      hops, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Two launches: the walk (one block a row), then the expansion over
// (slot tile, row).
int srjt_hybrid_decode(const void* data, const void* start, const void* end,
                       const void* bw, const void* n, int R, int UB, int vb,
                       int cap, void* tbl, void* meta, void* out,
                       void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  hybrid_runs_kernel<<<R, kWalkThreads, 0, s>>>(
      (const uint8_t*)data, (const int32_t*)start, (const int32_t*)end,
      (const int32_t*)bw, (const int32_t*)n, UB, vb, cap, (uint64_t*)tbl,
      (int32_t*)meta, (int64_t*)out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((vb + kTile - 1) / kTile), (unsigned)R);
  hybrid_expand_kernel<<<grid, kExpandThreads, 0, s>>>(
      (const uint8_t*)data, (const int32_t*)bw, (const int32_t*)n, UB, vb,
      cap, (const uint64_t*)tbl, (const int32_t*)meta, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
