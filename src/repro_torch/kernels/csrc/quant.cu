// Tile-wise int8 quantization of the statistics uplink, and its fused
// dequantize-accumulate, fp32 <-> int8 with one fp32 scale per tile.
//
// Replaces the TPU kernels `quantize_tiles_pallas` / `_quantize_kernel` and
// `dequant_acc_pallas` / `_dequant_acc_kernel` of src/repro/kernels/quant.py.
// A client ships its statistics (A_k, b_k) as int8 plus a grid of per-tile
// absmax scales (one fp32 per tile x tile block, ~4x fewer bytes than fp32);
// the server lands each payload in its fp32 accumulator as acc + q*s.
//
//   quantize_tiles:  s = max|x| * fl(1/127) over the tile (1 for an all-zero
//                    tile), q = clip(rne(x / s), -127, 127)
//   dequant_acc:     out = fma(q, s, acc), one rounding
//
// Every rounding is spelled out, because the reference is matched bitwise:
// __fmul_rn for the scale (the reference's XLA folds the division by 127
// into a product with its rounded reciprocal), __fdiv_rn and rintf (round
// half to even) for the payload, __fmaf_rn for the accumulate (the
// reference's XLA contracts acc + q*s into one FMA).  The _rn intrinsics are
// never contracted or approximated, whatever the compiler flags.
//
// What bounds them on an H100 SXM.  Bytes: quantize reads 4 and writes 1
// byte an element, dequantize reads 4 + 1 and writes 4, with a handful of
// operations each.  At the uplink's 1280 x 1280 that is 8.2 MB (2.4 us at
// 3.35 TB/s) and 14.7 MB (4.4 us), so a launch costs more than the work.
//
// What this design does about that: nothing yet, on purpose (a right kernel
// first).  One block of 256 threads per tile, grid (tiles across, tiles
// down), any tile >= 1.  quantize_tiles makes two passes over its tile: a
// block-wide max of |x| (out-of-range elements count as 0, as the
// reference's zero padding does), the scale from one thread into shared
// memory and the scale grid, then the int8 payload.  dequant_acc reads its
// tile's scale once, as a scalar, and writes a new fp32 output: no expanded
// scale array exists anywhere.  Consecutive threads take consecutive
// columns, so loads and stores coalesce for tiles of 32 and more.
//
// NaN is outside the contract: fmaxf skips it where the reference's max
// propagates it.  Statistics are finite.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so quant.cu
// The C interface below is loaded with ctypes (kernels/quant.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float QMAX = 127.0f;

__global__ void __launch_bounds__(THREADS)
quantize_tiles_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int M, int N, int tile) {
  __shared__ float warp_max[WARPS];
  __shared__ float scale_s;

  const int tj = blockIdx.x;  // tile column
  const int ti = blockIdx.y;  // tile row
  const int r0 = ti * tile;
  const int c0 = tj * tile;
  const int rows = min(tile, M - r0);
  const int cols = min(tile, N - c0);
  const long long count = (long long)rows * cols;

  // pass 1: the tile's absmax (the padding's zeros never raise it)
  float m = 0.0f;
  for (long long e = threadIdx.x; e < count; e += THREADS) {
    const int r = (int)(e / cols);
    const int c = (int)(e % cols);
    m = fmaxf(m, fabsf(x[(size_t)(r0 + r) * N + (c0 + c)]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float absmax = warp_max[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) absmax = fmaxf(absmax, warp_max[w]);
    const float s = absmax > 0.0f ? __fmul_rn(absmax, 1.0f / QMAX) : 1.0f;
    scale_s = s;
    scales[(size_t)ti * gridDim.x + tj] = s;
  }
  __syncthreads();

  // pass 2: the payload, round half to even, clipped to +-127
  const float s = scale_s;
  for (long long e = threadIdx.x; e < count; e += THREADS) {
    const int r = (int)(e / cols);
    const int c = (int)(e % cols);
    const size_t i = (size_t)(r0 + r) * N + (c0 + c);
    const float v = fminf(fmaxf(rintf(__fdiv_rn(x[i], s)), -QMAX), QMAX);
    q[i] = (int8_t)(int)v;
  }
}

__global__ void __launch_bounds__(THREADS)
dequant_acc_kernel(const float* __restrict__ acc, const int8_t* __restrict__ q,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int M, int N, int tile) {
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const int r0 = ti * tile;
  const int c0 = tj * tile;
  const int rows = min(tile, M - r0);
  const int cols = min(tile, N - c0);
  const long long count = (long long)rows * cols;
  const float s = scales[(size_t)ti * gridDim.x + tj];  // once per tile
  for (long long e = threadIdx.x; e < count; e += THREADS) {
    const int r = (int)(e / cols);
    const int c = (int)(e % cols);
    const size_t i = (size_t)(r0 + r) * N + (c0 + c);
    out[i] = __fmaf_rn((float)q[i], s, acc[i]);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  x is
// (M, N) row-major fp32; q (M, N) int8 and scales (ceil(M/tile),
// ceil(N/tile)) fp32 are written in full.  Returns the launch's cudaError_t
// (0 on success).
int quantize_tiles_launch(const float* x, int8_t* q, float* scales, int M, int N, int tile,
                          void* stream) {
  const dim3 grid((N + tile - 1) / tile, (M + tile - 1) / tile);
  quantize_tiles_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, M, N, tile);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) fp32 = fma(q, s, acc) tile by tile; acc and out row-major fp32,
// q row-major int8, scales the (ceil(M/tile), ceil(N/tile)) grid.  out may
// not alias acc.
int dequant_acc_launch(const float* acc, const int8_t* q, const float* scales, float* out,
                       int M, int N, int tile, void* stream) {
  const dim3 grid((N + tile - 1) / tile, (M + tile - 1) / tile);
  dequant_acc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, q, scales, out, M, N, tile);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
