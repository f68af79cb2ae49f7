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
// into a product with its rounded reciprocal), rintf (round half to even)
// of the correctly rounded quotient x / s for the payload, __fmaf_rn for
// the accumulate (the reference's XLA contracts acc + q*s into one FMA).
// The _rn intrinsics are never contracted or approximated, whatever the
// compiler flags.
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
// quantize_tiles reads x once and fills the card with a thread-block
// cluster a tile.  A tile's rows go to the cluster's blocks (1, 2, 4 or 8,
// at most the portable size), each block taking a slab of consecutive rows.
// Each thread maps straight to (row, run of W columns) of its slab, stepping
// by the block's stride with no division, and keeps the runs it loads in
// registers: 16 floats a thread where the slab fits them (more blocks
// resident), else 64; a wider slab is read again for the payload.  Every
// load a thread keeps is issued before the first is used (a warp issues in
// order).  Each block reduces its slab's max |x| (elements outside x are in
// no slab, as the reference's zero padding never raises a max); the blocks
// exchange their maxima through distributed shared memory around one
// cluster barrier, so each block knows the tile's absmax and scale and
// quantizes its own slab.  The block of rank 0 writes the tile's scale.  A
// second, split arrival on the cluster barrier (waited for only before
// exit) keeps every block's shared memory alive until the others have read
// it, without holding up the payload.  The payload rounds x * fl(1/s) and
// divides (__fdiv_rn) only where that product lies within 2^-14 of a
// half-integer, where the two could round apart (quant1 gives the bound).
// x is read with float4 loads and q written with 16-byte stores where
// N % 16 == 0, the tile is a multiple of 16 and x and q are 16-byte aligned
// (W = 16); with float4 loads and 4-byte stores where N % 4 == 0, the tile
// is a multiple of 4, x is 16-byte and q 4-byte aligned (W = 4); else one
// element at a time (W = 1): chosen from the pointers and the shape before
// the launch, never on a failure.  The cluster size is chosen by the
// wrapper (kernels/quant.py::pick_cluster) from the tile count and the SM
// count: the smallest whose blocks fill the card four times over and whose
// slabs fit what the blocks hold, e.g. 8 (800 blocks) at 1280 x 1280, 8 (80)
// at 1280 x 100 and 2 (3200) at 5000 x 5000.  A max is exact in any order
// and the payload is the same integer, so q and the scales equal the plain
// version's, and the first, one-block-a-tile design's, bitwise.  What
// bounds it: at 1280 x 100 the launch and the chain of one block (load,
// cluster barrier, payload); at 5000 x 5000 the bytes, with each block's
// phases serialized (its loads, then the barrier, then its stores).
//
// NaN is outside the contract: fmaxf skips it where the reference's max
// propagates it.  Statistics are finite.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so quant.cu
// The C interface below is loaded with ctypes (kernels/quant.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr float QMAX = 127.0f;
constexpr int THREADS = 256;      // dequant_acc's block
constexpr int BLOCKS_PER_SM = 8;  // dequant_acc's grid: 8 x 256 threads fill an SM
constexpr int QTHREADS = 128;     // quantize_tiles' block
constexpr int QWARPS = QTHREADS / 32;
constexpr int HELD = 64;          // floats of x a thread keeps between the max and the payload

// q = clip(rne(x / s), -127, 127), as an int, x / s the correctly rounded
// quotient, given r = fl(1 / s).  t = fl(x * r) is within 3u|x/s| of
// fl(x / s) (u = 2^-24; r and the product round once each), and
// |x/s| <= 127(1 + 2u) since |x| <= absmax, so |t - fl(x / s)| < 2.3e-5:
// where t lies more than 2^-14 from every half-integer both round to the
// same integer.  Ties, near-ties and an r that overflows (a subnormal s)
// fail the test and take the division.
__device__ __forceinline__ int quant1(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  float k = rintf(t);
  if (!(fabsf(__fsub_rn(t, k)) < 0.5f - 0x1p-14f)) k = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(k, -QMAX), QMAX));
}

// four payload bytes, the first in the lowest byte (little-endian memory order)
__device__ __forceinline__ unsigned pack4(const float* v, float s, float r) {
  return (static_cast<unsigned>(quant1(v[0], s, r)) & 0xffu) |
         (static_cast<unsigned>(quant1(v[1], s, r)) & 0xffu) << 8 |
         (static_cast<unsigned>(quant1(v[2], s, r)) & 0xffu) << 16 |
         (static_cast<unsigned>(quant1(v[3], s, r)) & 0xffu) << 24;
}

template <int W>
__device__ __forceinline__ void load_run(float* v, const float* __restrict__ p) {
  if constexpr (W == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i + 0] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_run(int8_t* p, const float* v, float s, float r) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack4(v, s, r), pack4(v + 4, s, r),
                                              pack4(v + 8, s, r), pack4(v + 12, s, r));
  } else if constexpr (W == 4) {
    *reinterpret_cast<unsigned*>(p) = pack4(v, s, r);
  } else {
    *p = static_cast<int8_t>(quant1(v[0], s, r));
  }
}

// A thread's (row, run) cursor over its block's slab: rows of `rpr` runs,
// the block's threads side by side, stepped by the block's stride.
struct Cursor {
  unsigned row, run, row_step, run_step, rpr;
  __device__ __forceinline__ Cursor(unsigned t, unsigned rpr_)
      : row(t / rpr_), run(t % rpr_), row_step(QTHREADS / rpr_), run_step(QTHREADS % rpr_),
        rpr(rpr_) {}
  __device__ __forceinline__ void next() {
    row += row_step;
    run += run_step;
    if (run >= rpr) {
      run -= rpr;
      ++row;
    }
  }
};

// Grid (tiles across x cluster size, tiles down), clusters along x: the
// cluster's blocks share one tile.  HOLD: the floats of x a thread keeps
// (16 where its slab fits them, else 64).
template <int W, int HOLD>
__global__ void __launch_bounds__(QTHREADS)
quantize_tiles_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int M, int N, int tile) {
  constexpr int RUNS = HOLD / W;  // runs a thread keeps
  __shared__ float warp_max[QWARPS];
  __shared__ float block_max;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tj = blockIdx.x / csize;  // tile column
  const int ti = blockIdx.y;          // tile row
  const int r0 = ti * tile;
  const int c0 = tj * tile;
  const int rows = min(tile, M - r0);
  const unsigned rpr = static_cast<unsigned>(min(tile, N - c0)) / W;  // W divides it
  // this block's slab: rows [sr0, sr1) of the tile
  const int per = (rows + static_cast<int>(csize) - 1) / static_cast<int>(csize);
  const int sr0 = min(rows, static_cast<int>(rank) * per);
  const unsigned srows = static_cast<unsigned>(min(rows, sr0 + per) - sr0);
  const float* __restrict__ xs = x + (size_t)(r0 + sr0) * N + c0;
  int8_t* __restrict__ qs = q + (size_t)(r0 + sr0) * N + c0;

  // pass 1: every load of the held runs issued before any is used (a warp
  // issues in order: a max between two loads would wait out each load's
  // latency in turn), then the slab's max |x|
  float v[RUNS][W];
  Cursor cur(threadIdx.x, rpr);
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    if (cur.row < srows) {
      load_run<W>(v[i], xs + (size_t)cur.row * N + cur.run * W);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) v[i][e] = 0.0f;
    }
    cur.next();
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < RUNS; ++i)
#pragma unroll
    for (int e = 0; e < W; ++e) m = fmaxf(m, fabsf(v[i][e]));
  for (; cur.row < srows; cur.next()) {  // a slab wider than the registers
    float u[W];
    load_run<W>(u, xs + (size_t)cur.row * N + cur.run * W);
#pragma unroll
    for (int e = 0; e < W; ++e) m = fmaxf(m, fabsf(u[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = warp_max[0];
#pragma unroll
    for (int w = 1; w < QWARPS; ++w) bm = fmaxf(bm, warp_max[w]);
    block_max = bm;
  }

  // the tile's absmax: every block's maximum, through distributed shared
  // memory, the (at most 8) remote reads issued together
  cluster.sync();
  float absmax = 0.0f;
#pragma unroll
  for (unsigned r = 0; r < 8; ++r)
    if (r < csize) absmax = fmaxf(absmax, *cluster.map_shared_rank(&block_max, r));
  // done reading the others' shared memory; waited for before exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float s = absmax > 0.0f ? __fmul_rn(absmax, 1.0f / QMAX) : 1.0f;
  const float r = __frcp_rn(s);
  if (rank == 0 && threadIdx.x == 0) scales[(size_t)ti * (gridDim.x / csize) + tj] = s;

  // pass 2: the payload, round half to even, clipped to +-127
  Cursor out(threadIdx.x, rpr);
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    if (out.row < srows) store_run<W>(qs + (size_t)out.row * N + out.run * W, v[i], s, r);
    out.next();
  }
  for (; out.row < srows; out.next()) {
    float u[W];
    load_run<W>(u, xs + (size_t)out.row * N + out.run * W);
    store_run<W>(qs + (size_t)out.row * N + out.run * W, u, s, r);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int W, int HOLD>
int quantize_launch(const float* x, int8_t* q, float* scales, int M, int N, int tile,
                    int cluster, cudaStream_t stream) {
  const long long Mt = (static_cast<long long>(M) + tile - 1) / tile;
  const long long across = (static_cast<long long>(N) + tile - 1) / tile * cluster;
  if (Mt > 65535 || across >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(across), static_cast<unsigned>(Mt));
  cfg.blockDim = dim3(QTHREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, quantize_tiles_kernel<W, HOLD>, x, q, scales,
                                             M, N, tile);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// HOLD = 16 floats a thread where a block's slab (at most ceil(tile /
// cluster) rows of min(tile, N) columns) fits them, else 64: fewer
// registers, more blocks resident on an SM.  Single elements hold 16 (64
// scalar loads in flight took 255 registers).
template <int W>
int quantize_hold(const float* x, int8_t* q, float* scales, int M, int N, int tile, int cluster,
                  cudaStream_t stream) {
  if constexpr (W == 1) {
    return quantize_launch<1, 16>(x, q, scales, M, N, tile, cluster, stream);
  } else {
    const long long slab = (static_cast<long long>(tile) + cluster - 1) / cluster *
                           (tile < N ? tile : N);
    if (slab <= 16ll * QTHREADS) {
      return quantize_launch<W, 16>(x, q, scales, M, N, tile, cluster, stream);
    }
    return quantize_launch<W, HELD>(x, q, scales, M, N, tile, cluster, stream);
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
// ceil(N/tile)) fp32 are written in full.  `cluster` (1, 2, 4 or 8) is the
// number of blocks a tile.  Runs of 16 where N and the tile are multiples
// of 16 and x and q are 16-byte aligned, else of 4 where N and the tile
// are multiples of 4, x is 16-byte and q 4-byte aligned, else single
// elements.  Returns the launch's cudaError_t (0 on success).
int quantize_tiles_launch(const float* x, int8_t* q, float* scales, int M, int N, int tile,
                          int cluster, void* stream) {
  if (tile < 1 || !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), qa = reinterpret_cast<uintptr_t>(q);
  if (N % 16 == 0 && tile % 16 == 0 && xa % 16 == 0 && qa % 16 == 0) {
    return quantize_hold<16>(x, q, scales, M, N, tile, cluster, s);
  }
  if (N % 4 == 0 && tile % 4 == 0 && xa % 16 == 0 && qa % 4 == 0) {
    return quantize_hold<4>(x, q, scales, M, N, tile, cluster, s);
  }
  return quantize_hold<1>(x, q, scales, M, N, tile, cluster, s);
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
