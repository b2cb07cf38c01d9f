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
// W1 `snappy_walk` and W2 `hybrid_walk` are not TPU kernels: in the JAX
// package they are `jax.lax.while_loop`s vmapped over pages
// (::_snappy_pass1 and ::_hybrid_pass1).  Each walks the headers of one
// page's stream (snappy tokens, or the runs of an RLE/bit-packed hybrid
// stream) and writes a compact per-token or per-run table; everything after
// that is parallel torch.  One thread per page row; the walk is serial by
// nature, so a walk's time is its number of tokens or runs times one
// dependent global load.  Arithmetic is 32-bit with wrap-around (done in
// uint32_t and read back as int32_t), and every read position is clipped
// to the row, so a torn page walks exactly as it does in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t wrap(uint32_t x) { return (int32_t)x; }
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return wrap((uint32_t)a + (uint32_t)b);
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

// ---- W1 -------------------------------------------------------------------

__global__ void snappy_walk_kernel(const uint8_t* __restrict__ comp,
                                   const int32_t* __restrict__ clen,
                                   const int32_t* __restrict__ ulen,
                                   int R, int CB, int tb,
                                   int32_t* __restrict__ dk,
                                   int32_t* __restrict__ ls,
                                   int32_t* __restrict__ co) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint8_t* row = comp + (long long)r * CB;
  auto rd = [&](int32_t pos) -> int32_t {
    return (int32_t)row[clip32(pos, 0, CB - 1)];
  };
  // uvarint preamble (the uncompressed length): skip 1-5 bytes
  int32_t c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = rd(k) >> 7;
  int32_t s = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] +
              c[0] * c[1] * c[2] * c[3];
  int32_t d = 0;
  const int32_t cl = clen[r], ul = ulen[r];
  int32_t* dkr = dk + (long long)r * tb;
  int32_t* lsr = ls + (long long)r * tb;
  int32_t* cor = co + (long long)r * tb;
  for (int32_t k = 0; s < cl && d < ul && k < tb; ++k) {
    const int32_t tag = rd(s);
    const int32_t kind = tag & 3;
    const int32_t lcode = tag >> 2;
    const int32_t nlb = clip32(lcode - 59, 0, 4);
    int32_t e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = rd(add32(s, 1 + j));
    const int32_t extra = e[0] | shl32(e[1], 8) | shl32(e[2], 16) |
                          shl32(e[3], 24);
    const int32_t emask = nlb >= 4 ? -1 : shl32(1, 8 * min(nlb, 3)) - 1;
    const int32_t lit_len = lcode < 60 ? lcode + 1 : add32(extra & emask, 1);
    const int32_t lit_start = add32(s, 1 + nlb);
    const int32_t len1 = ((tag >> 2) & 7) + 4;
    const int32_t off1 = ((tag & 0xE0) << 3) | e[0];
    const int32_t off2 = e[0] | (e[1] << 8);
    int32_t cp_off = kind == 1 ? off1 : (kind == 2 ? off2 : extra);
    cp_off = cp_off > 1 ? cp_off : 1;  // 0 is the literal marker
    const int32_t cp_len = kind == 1 ? len1 : lcode + 1;
    const int32_t cp_adv = kind == 1 ? 2 : (kind == 2 ? 3 : 5);
    const bool is_lit = kind == 0;
    dkr[k] = d;
    lsr[k] = is_lit ? lit_start : 0;
    cor[k] = is_lit ? 0 : cp_off;
    s = add32(s, is_lit ? add32(1 + nlb, lit_len) : cp_adv);
    d = add32(d, is_lit ? lit_len : cp_len);
  }
}

// ---- W2 -------------------------------------------------------------------

__global__ void hybrid_walk_kernel(const uint8_t* __restrict__ data,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ end,
                                   const int32_t* __restrict__ bw_,
                                   const int32_t* __restrict__ n_,
                                   int R, int UB, int vb,
                                   int32_t* __restrict__ mark,
                                   uint8_t* __restrict__ pk,
                                   int32_t* __restrict__ bb,
                                   int32_t* __restrict__ rv) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const uint8_t* row = data + (long long)r * UB;
  auto rd = [&](int32_t pos) -> int32_t {
    return (int32_t)row[clip32(pos, 0, UB - 1)];
  };
  const int32_t bw = bw_[r], n = n_[r], e = end[r];
  const int32_t bwb = add32(bw, 7) >> 3;  // RLE value byte width
  const int32_t vmask = bwb >= 4 ? -1 : shl32(1, 8 * min(bwb, 3)) - 1;
  const long long o = (long long)r * vb;
  int32_t s = start[r], v = 0;
  // `it < n` never binds while v grows (v >= it); it only stops a walk
  // whose 32-bit value count wrapped, which could otherwise spin forever
  for (int32_t it = 0; s < e && v < n && it < n; ++it) {
    int32_t b[5], c[5], seg[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      b[k] = rd(add32(s, k));
      c[k] = b[k] >> 7;
      seg[k] = b[k] & 0x7F;
    }
    int32_t h = seg[0];
    h = add32(h, c[0] * (seg[1] << 7));
    h = add32(h, c[0] * c[1] * (seg[2] << 14));
    h = add32(h, c[0] * c[1] * c[2] * (seg[3] << 21));
    h = add32(h, c[0] * c[1] * c[2] * c[3] * shl32(seg[4], 28));
    const int32_t hlen = 1 + c[0] + c[0] * c[1] + c[0] * c[1] * c[2] +
                         c[0] * c[1] * c[2] * c[3];
    const int32_t dp = add32(s, hlen);
    const bool packed = (h & 1) == 1;
    const int32_t groups = h >> 1;
    int32_t dd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dd[k] = rd(add32(dp, k));
    const int32_t raw = dd[0] | shl32(dd[1], 8) | shl32(dd[2], 16) |
                        shl32(dd[3], 24);
    int32_t cnt = packed ? mul32(groups, 8) : groups;
    cnt = cnt > 1 ? cnt : 1;  // corrupt zero-count header: still advance
    const int32_t adv = packed ? mul32(groups, bw) : bwb;
    const long long vc = o + clip32(v, 0, vb - 1);
    mark[vc] = v;
    pk[vc] = packed ? 1 : 0;
    bb[vc] = mul32(dp, 8);
    rv[vc] = raw & vmask;
    s = add32(dp, adv);
    v = add32(v, cnt);
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
                     int R, int CB, int tb, void* dk, void* ls, void* co,
                     void* stream) {
  if (R <= 0) return 0;
  const int threads = 32;
  snappy_walk_kernel<<<(R + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clen, (const int32_t*)ulen, R, CB,
      tb, (int32_t*)dk, (int32_t*)ls, (int32_t*)co);
  return (int)cudaGetLastError();
}

int srjt_hybrid_walk(const void* data, const void* start, const void* end,
                     const void* bw, const void* n, int R, int UB, int vb,
                     void* mark, void* pk, void* bb, void* rv, void* stream) {
  if (R <= 0) return 0;
  const int threads = 32;
  hybrid_walk_kernel<<<(R + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)start, (const int32_t*)end,
      (const int32_t*)bw, (const int32_t*)n, R, UB, vb, (int32_t*)mark,
      (uint8_t*)pk, (int32_t*)bb, (int32_t*)rv);
  return (int)cudaGetLastError();
}

}  // extern "C"
