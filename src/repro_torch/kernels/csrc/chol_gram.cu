// Fused rank-n Cholesky-Gram update G = L L^T + Z^T Z (d x d) and
// B = Z^T Y (d x C), fp32.
//
// Replaces the TPU kernel `chol_gram_pallas` / `_chol_gram_kernel` of
// src/repro/kernels/chol_update.py: the streaming engine refactors the
// carried Cholesky factor L of A + lambda*I once per arrival wave through
// L' = chol(L L^T + Z^T Z), and accumulates the class sums Z^T Y.
//
// What bounds it on an H100 SXM.  L is lower-triangular, so G's
// reconstruction needs ~d^3/3 FLOPs (G symmetric, G[i][j] a sum over
// k <= min(i, j)); the samples need n*d*(d+1) for the symmetric Z^T Z of
// the live rows and about n*d for a one-hot Y; the bytes are L, Z and Y read
// once and G and B written once.  At d = 1280 with a stream wave of 1088
// rows, ~270 of them live, that is ~1.6 GFLOP against 18 MB; at d = 5000
// (FED3R-RF) the d^3/3 term alone is 41.7 GFLOP against 220 MB.  Bound by
// arithmetic, on the FMA units, because the refactorization needs IEEE
// fp32 (no TF32, wgmma has no IEEE fp32 mode, and a split-precision
// product would break the bitwise chain below).
//
// What this design does about that: the SGEMM tile loop of
// chol_gram_tile.cuh (design notes there), shared with batched_chol_gram.cu.
// * One block for each tile of G on or below the diagonal and each tile of
//   B, the G tiles with the longest factor sweeps first; the lower tiles of
//   the symmetric G are mirrored through shared memory, both stores
//   coalesced.
// * 8 x 8 accumulators a thread fed by 16-byte shared loads at BT = 128, or
//   4 x 4 at BT = 64: the wrapper picks the instance by how many blocks
//   fill the card (kernels/chol_update.py::pick_tile).
// * A cp.async ring of four 16-row panels, L's panels copied transposed
//   from its lower triangle, Z and Y read in place with zero-fill at the
//   ragged edges.
// * All-zero sample panels (a stream wave is mostly padding rows) are
//   skipped, which changes no bit.
// * No atomics and no split-K: each element is one fmaf chain (factor rows,
//   then sample rows, in order, from +0), so G and B are bitwise those of
//   the first design of this kernel, a launch is bitwise reproducible, and
//   the streaming engine's bitwise invariance to the order of concurrent
//   arrivals holds.  n = 0 is legal and gives B exactly 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so chol_gram.cu  (chol_gram_tile.cuh beside it)
// The C interface below is loaded with ctypes (kernels/chol_update.py).

#include <cuda_runtime.h>

#include "chol_gram_tile.cuh"

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  L is
// (d, d) lower-triangular (its upper triangle is not read), Z (n, d) and
// Y (n, C), all row-major fp32; n may be 0 (Z and Y are then not read).
// G (d, d) and B (d, C) are written in full.  `tile` picks the instance,
// 128 or 64.  Returns the launch's cudaError_t (0 on success).
int chol_gram_launch(const float* L, const float* Z, const float* Y, float* G, float* B, int d,
                     int n, int C, int tile, void* stream) {
  return chol_gram_tile::dispatch<false>(
      tile, chol_gram_tile::vector_copies(d, C, Z, Y, Z), L, Z, Y, G, B, d, n, C, 1, true,
      static_cast<cudaStream_t>(stream));
}

const char* chol_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
