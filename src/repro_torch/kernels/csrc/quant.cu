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
// 3.35 TB/s) and 14.7 MB (4.4 us); at 5000 x 5000, 125 MB (37 us) and 225
// MB (67 us).
//
// dequant_acc is a bandwidth kernel.  Each thread takes a run of W
// consecutive elements of one row: one 16- (W = 16) or 4-byte (W = 4) load
// of q, W / 4 float4 loads of acc and W / 4 float4 stores of out, so every
// access is as wide as the card takes and a warp's accesses are contiguous.
// The launch function takes W = 16 where N % 16 == 0 and the three
// pointers are 16-byte aligned, W = 4 where N % 4 == 0 (q then 4-byte
// aligned), else single elements: chosen from the pointers and N before the
// launch, never on a failure.  Where the tile is a multiple of W a run lies
// in one tile and reads one scale; else each of its elements reads its own.
// Rows and runs map straight to threads: a thread computes its (row, run)
// once and steps it by the grid's stride with no division, and a run's tile
// index is row / tile, col / tile in 32-bit integers.  The grid holds 8
// blocks of 256 threads an SM (fewer where there are fewer runs), whatever
// the tile count; the first design's one block a tile gave 100 blocks at
// 1280 x 1280 and 10 at 1280 x 100 for 132 SMs, with a 64-bit division
// and a 1-byte load an element.  The scales (one float a tile) stay in L1.
// No dense dequantized or expanded scale array exists anywhere.
//
// quantize_tiles keeps its first design: one block of 256 threads a tile,
// grid (tiles across, tiles down), any tile >= 1, two passes over its tile
// (a block-wide max of |x|, out-of-range elements counting as 0 as the
// reference's zero padding does; then the int8 payload from the scale,
// which one thread writes to shared memory and the scale grid).  No one
// PyTorch call quantizes per tile, so it has no library time to lose
// against, and among the port's kernels its launches x (time - bound) come
// after the others'; its redesign waits its turn.
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
constexpr int BLOCKS_PER_SM = 8;  // dequant_acc's grid: 8 x 256 threads fill an SM

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

// out = fma(q, s, acc) over runs of W consecutive elements of one row: one
// load of W int8 of q, W / 4 float4 loads of acc and float4 stores (W = 1:
// scalars).  RUN_SCALE: the tile is a multiple of W, so a run lies in one
// tile and reads one scale; else each element reads its own.  Each thread
// keeps its (row, run) pair and steps it by the grid's stride with no
// division; the tile index is one 32-bit division a run (or an element).
template <int W, bool RUN_SCALE>
__global__ void __launch_bounds__(THREADS)
dequant_acc_kernel(const float* __restrict__ acc, const int8_t* __restrict__ q,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int M, int N, int tile) {
  const unsigned runs = static_cast<unsigned>(N) / W;  // runs a row
  const unsigned Nt = (static_cast<unsigned>(N) + tile - 1) / tile;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  const unsigned stride = gridDim.x * THREADS;
  unsigned row = first / runs, run = first % runs;
  const unsigned row_step = stride / runs, run_step = stride % runs;
  for (; row < static_cast<unsigned>(M); row += row_step, run += run_step) {
    if (run >= runs) {
      run -= runs;
      ++row;
      if (row >= static_cast<unsigned>(M)) break;
    }
    const unsigned col = run * W;
    const size_t i = static_cast<size_t>(row) * N + col;
    const float* srow = scales + (row / tile) * Nt;
    if constexpr (W == 1) {
      out[i] = __fmaf_rn(static_cast<float>(q[i]), __ldg(srow + col / tile), acc[i]);
    } else {
      union {
        int4 v16;
        int v4;
        int8_t e[16];
      } qv;
      if constexpr (W == 16) {
        qv.v16 = __ldg(reinterpret_cast<const int4*>(q + i));
      } else {
        qv.v4 = __ldg(reinterpret_cast<const int*>(q + i));
      }
      const float s_run = RUN_SCALE ? __ldg(srow + col / tile) : 0.0f;
#pragma unroll
      for (int v = 0; v < W / 4; ++v) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(acc + i) + v);
        float s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] = RUN_SCALE ? s_run : __ldg(srow + (col + 4 * v + e) / tile);
        }
        float4 o;
        o.x = __fmaf_rn(static_cast<float>(qv.e[4 * v + 0]), s[0], a.x);
        o.y = __fmaf_rn(static_cast<float>(qv.e[4 * v + 1]), s[1], a.y);
        o.z = __fmaf_rn(static_cast<float>(qv.e[4 * v + 2]), s[2], a.z);
        o.w = __fmaf_rn(static_cast<float>(qv.e[4 * v + 3]), s[3], a.w);
        reinterpret_cast<float4*>(out + i)[v] = o;
      }
    }
  }
}

template <int W, bool RUN_SCALE>
int dequant_launch(const float* acc, const int8_t* q, const float* scales, float* out, int M,
                   int N, int tile, int sms, cudaStream_t stream) {
  // enough blocks to fill every SM BLOCKS_PER_SM times, fewer where there are fewer runs
  const long long runs = static_cast<long long>(M) * (N / W);
  const long long blocks = (runs + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  dequant_acc_kernel<W, RUN_SCALE><<<static_cast<unsigned>(blocks < cap ? blocks : cap), THREADS,
                                     0, stream>>>(acc, q, scales, out, M, N, tile);
  return static_cast<int>(cudaGetLastError());
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
// not alias acc.  Runs of 16 elements where N % 16 == 0 and q, acc and out
// are 16-byte aligned, else of 4 where N % 4 == 0, acc and out are 16-byte
// and q 4-byte aligned, else single elements.  `sms` is the card's SM count
// (the wrapper's, learned once a card), which sizes the grid.
int dequant_acc_launch(const float* acc, const int8_t* q, const float* scales, float* out,
                       int M, int N, int tile, int sms, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const bool f16 = (reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (f16 && N % 16 == 0 && qa % 16 == 0) {
    return tile % 16 == 0 ? dequant_launch<16, true>(acc, q, scales, out, M, N, tile, sms, s)
                          : dequant_launch<16, false>(acc, q, scales, out, M, N, tile, sms, s);
  }
  if (f16 && N % 4 == 0 && qa % 4 == 0) {
    return tile % 4 == 0 ? dequant_launch<4, true>(acc, q, scales, out, M, N, tile, sms, s)
                         : dequant_launch<4, false>(acc, q, scales, out, M, N, tile, sms, s);
  }
  return dequant_launch<1, true>(acc, q, scales, out, M, N, tile, sms, s);
}

const char* quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
