// Row-wire interleave kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/row_wire.py).
//
// K1 `interleave_planes` replaces the TPU kernel
// spark_rapids_jni_tpu/ops/pallas_kernels.py::_interleave_kernel, and K2
// `deinterleave_wire` replaces ::_deinterleave_kernel.  Both move 32-bit
// words between the column-major word planes `u32[nwords, n]` that
// RowConversion builds from the columns and the row-major packed-row wire
// `u32[n, nwords]` (one row of `nwords` words per table row).  They are a
// transpose and its inverse.
//
// Bound: pure data movement.  Each kernel reads 4*n*nwords bytes and writes
// as many, so at the H100's 3.35 TB/s the least time is 8*n*nwords / 3.35e12
// seconds (about 0.48 ms for n = 2^24 rows of 12 words).
//
// Design: one block of 256 threads takes a tile of 256 rows and a chunk of
// up to 32 words (grid.y walks the word chunks, so any nwords works).  The
// plane side is read or written along rows, 256 consecutive words per plane,
// so those accesses are coalesced.  The wire side of the tile is walked in
// linear order (row-major over the chunk), so its accesses are coalesced as
// well; for nwords <= 32 the tile's wire span is one contiguous run.  The
// shared tile is padded to 33 words a row so the plane-side accesses of a
// warp (32 consecutive rows, one word) fall in 32 distinct banks.  The
// kernel masks the ragged last tile itself, so callers pad nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;   // rows per block, = threads per block
constexpr int kTileWords = 32;   // words per chunk
constexpr int kPitch = kTileWords + 1;

__global__ void __launch_bounds__(kTileRows)
interleave_kernel(const uint32_t* __restrict__ planes,
                  uint32_t* __restrict__ wire, long long n, int nwords) {
  __shared__ uint32_t tile[kTileRows * kPitch];
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int w0 = blockIdx.y * kTileWords;
  const int wc = min(kTileWords, nwords - w0);
  const int rc = (int)min((long long)kTileRows, n - r0);
  const int t = threadIdx.x;

  // planes -> tile: thread t owns row t, one coalesced plane read per word
  if (t < rc) {
    const uint32_t* src = planes + (long long)w0 * n + r0 + t;
    for (int w = 0; w < wc; ++w) {
      tile[t * kPitch + w] = src[(long long)w * n];
    }
  }
  __syncthreads();

  // tile -> wire: linear walk over the tile's (row, word) pairs
  uint32_t* dst = wire + r0 * nwords + w0;
  const int total = rc * wc;
  for (int i = t; i < total; i += kTileRows) {
    const int r = i / wc;
    const int w = i - r * wc;
    dst[(long long)r * nwords + w] = tile[r * kPitch + w];
  }
}

__global__ void __launch_bounds__(kTileRows)
deinterleave_kernel(const uint32_t* __restrict__ wire,
                    uint32_t* __restrict__ planes, long long n, int nwords) {
  __shared__ uint32_t tile[kTileRows * kPitch];
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int w0 = blockIdx.y * kTileWords;
  const int wc = min(kTileWords, nwords - w0);
  const int rc = (int)min((long long)kTileRows, n - r0);
  const int t = threadIdx.x;

  // wire -> tile: linear walk over the tile's (row, word) pairs
  const uint32_t* src = wire + r0 * nwords + w0;
  const int total = rc * wc;
  for (int i = t; i < total; i += kTileRows) {
    const int r = i / wc;
    const int w = i - r * wc;
    tile[r * kPitch + w] = src[(long long)r * nwords + w];
  }
  __syncthreads();

  // tile -> planes: thread t owns row t, one coalesced plane write per word
  if (t < rc) {
    uint32_t* dst = planes + (long long)w0 * n + r0 + t;
    for (int w = 0; w < wc; ++w) {
      dst[(long long)w * n] = tile[t * kPitch + w];
    }
  }
}

dim3 grid_for(long long n, int nwords) {
  return dim3((unsigned)((n + kTileRows - 1) / kTileRows),
              (unsigned)((nwords + kTileWords - 1) / kTileWords));
}

}  // namespace

// planes: u32[nwords, n] (plane-major), wire: u32[n * nwords] (row-major).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int srjt_interleave_planes(const void* planes, void* wire,
                                      long long n, int nwords, void* stream) {
  if (n <= 0 || nwords <= 0) return 0;
  interleave_kernel<<<grid_for(n, nwords), kTileRows, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (uint32_t*)wire, n, nwords);
  return (int)cudaGetLastError();
}

// wire: u32[n * nwords] (row-major), planes: u32[nwords, n] (plane-major).
extern "C" int srjt_deinterleave_wire(const void* wire, void* planes,
                                      long long n, int nwords, void* stream) {
  if (n <= 0 || nwords <= 0) return 0;
  deinterleave_kernel<<<grid_for(n, nwords), kTileRows, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)wire, (uint32_t*)planes, n, nwords);
  return (int)cudaGetLastError();
}
