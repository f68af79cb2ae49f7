// Batched fused Cholesky-Gram update over K heads sharing one factor L:
// G_k = L L^T + Z_k^T Z_k (d x d) and B_k = Z_k^T Y_k (d x C), fp32.
//
// Replaces the TPU kernel `batched_chol_gram_pallas` /
// `_batched_chol_gram_kernel` of src/repro/kernels/chol_update.py:189: the
// personalization engine's refit, which solves K per-tenant heads
// W_k = (A + alpha_k A_k + lambda I)^-1 (b + alpha_k b_k) against the carried
// factor L (L L^T = A + lambda I).  alpha_k is the caller's pre-scaling
// Z_k <- sqrt(alpha_k) Z_k, Y_k <- sqrt(alpha_k) Y_k, so the kernel is
// scale-free.  The TPU kernel's grid is (head, i, j, k) with the k-axis
// carrying one VMEM accumulator from the L^T rows into the head's sample
// rows; here that accumulator is split at the seam between the two.
//
// What bounds it on an H100 SXM.  L L^T is ~d^3/3 FLOPs once (0.70 GFLOP
// at d = 1280), each head's Z_k^T Z_k n*d*(d+1) for its live rows; the
// K*(d^2 + d*C) fp32 outputs written (226 MB at K = 32, d = 1280, C = 100:
// 0.067 ms at 3.35 TB/s) outweigh those few GFLOP, so the bound is the
// bytes, and coalesced stores matter more than the FMA rate.
//
// What this design does about that: two launches of the tile loop of
// chol_gram_tile.cuh (design notes there) on the caller's stream.
// * G0 = L L^T once, into the caller's (d, d) scratch: chol_gram's own code
//   at n = 0 over the G tiles only (no B tiles).
// * Then one block for each live tile of [G_k | B_k] and head (grid
//   (tiles, K)): each G accumulator starts from G0's tile, which holds
//   exactly the fmaf chain's value after the factor rows, and sweeps head
//   k's sample rows from a cp.async ring, skipping all-zero panels; the
//   lower tiles are mirrored through shared memory, both stores coalesced.
//   G0 (6.5 MB at d = 1280) stays in L2 while the K heads read it.
// * The same chain as chol_gram(L, Z_k, Y_k): every head of a launch is
//   bitwise equal to it.  No atomics and no split-K.  Ragged d, n and C are
//   masked in the tile; n = 0 is legal and then B_k is exactly 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so batched_chol_gram.cu
//        (chol_gram_tile.cuh beside it)
// The C interface below is loaded with ctypes (kernels/chol_update.py).

#include <cuda_runtime.h>

#include "chol_gram_tile.cuh"

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  L is
// (d, d) lower-triangular (its upper triangle is not read), Z (K, n, d) and
// Y (K, n, C), all row-major fp32; n may be 0 (Z and Y are then not read);
// 1 <= K <= 65535.  G0 (d, d) is scratch, written with L L^T; G (K, d, d)
// and B (K, d, C) are written in full.  `factor_tile` picks the instance
// of the L L^T sweep and `tile` that of the heads, each 128 or 64.
// Returns the first failing launch's cudaError_t (0 on success).
int batched_chol_gram_launch(const float* L, const float* Z, const float* Y, float* G, float* B,
                             float* G0, int K, int d, int n, int C, int factor_tile, int tile,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = chol_gram_tile::dispatch<false>(factor_tile, false, L, nullptr, nullptr, G0,
                                                  nullptr, d, 0, C, 1, false, s);
  if (err != 0) return err;
  return chol_gram_tile::dispatch<true>(tile, chol_gram_tile::vector_copies(d, C, Z, Y, G0), G0,
                                        Z, Y, G, B, d, n, C, K, true, s);
}

const char* batched_chol_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
