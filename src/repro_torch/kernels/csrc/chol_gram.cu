// Fused rank-n Cholesky-Gram update G = L L^T + Z^T Z (d x d) and
// B = Z^T Y (d x C), fp32.
//
// Replaces the TPU kernel `chol_gram_pallas` / `_chol_gram_kernel` of
// src/repro/kernels/chol_update.py: the streaming engine refactors the
// carried Cholesky factor L of A + lambda*I once per arrival wave through
// L' = chol(L L^T + Z^T Z), and accumulates the class sums Z^T Y.  Both right-
// hand terms are contractions over "rows" (the d rows of L^T, then the n
// sample rows of [Z | Y]), so one accumulator per output element sweeps the
// factor rows first and the sample rows second; no stacked (d+n) x (d+C)
// operand is built in device memory.
//
// What bounds it on an H100 SXM.  L is lower-triangular, so G's reconstruction
// needs ~d^3/3 FLOPs (G symmetric, G[i][j] a sum over k <= min(i, j)), the
// samples n*d*(d+1) for the symmetric Z^T Z and n*d adds for a one-hot Y; the
// bytes are L, Z and Y read once and G and B written once.  At d = 1280 with a
// wave of ~3000 rows that is ~5.6 GFLOP against ~37 MB, and at d = 5000
// (FED3R-RF) the d^3/3 term alone is 41.7 GFLOP against 200 MB: bound by
// arithmetic, on the FMA units, because the refactorization needs IEEE fp32
// (no TF32, and wgmma has no IEEE fp32 mode).
//
// What this design does about that: the tile loop of chol_gram_tile.cuh
// (shared with batched_chol_gram.cu, design notes there): only L's lower
// triangle read, each tile's factor sweep stopped at min(i0, j0) + 64, the
// lower tiles of the symmetric G computed and mirrored, IEEE fp32 FMA, no
// atomics and no split-K (a launch is bitwise reproducible, which the
// streaming engine's bitwise invariance to the order of concurrent arrivals
// rests on), n = 0 legal with B exactly 0.
//
// Making it fast (larger register tiles, double-buffered staging, staging the
// mirrored tile through shared memory for coalesced stores, a split-precision
// tensor-core product) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so chol_gram.cu  (chol_gram_tile.cuh beside it)
// The C interface below is loaded with ctypes (kernels/chol_update.py).

#include <cuda_runtime.h>
#include <stddef.h>

#include "chol_gram_tile.cuh"

namespace {

using chol_gram_tile::BM;
using chol_gram_tile::BN;
using chol_gram_tile::THREADS;

__global__ void __launch_bounds__(THREADS)
chol_gram_kernel(const float* __restrict__ L, const float* __restrict__ Z,
                 const float* __restrict__ Y, float* __restrict__ G,
                 float* __restrict__ B, int d, int n, int C) {
  chol_gram_tile::tile(L, Z, Y, G, B, d, n, C, blockIdx.x, blockIdx.y);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  L is
// (d, d) lower-triangular (its upper triangle is not read), Z (n, d) and
// Y (n, C), all row-major fp32; n may be 0 (Z and Y are then not read).
// G (d, d) and B (d, C) are written in full.  Returns the launch's
// cudaError_t (0 on success).
int chol_gram_launch(const float* L, const float* Z, const float* Y, float* G,
                     float* B, int d, int n, int C, void* stream) {
  const dim3 grid((d + C + BN - 1) / BN, (d + BM - 1) / BM);
  chol_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, Z, Y, G, B, d, n, C);
  return static_cast<int>(cudaGetLastError());
}

const char* chol_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
