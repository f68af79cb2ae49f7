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
// carrying one VMEM accumulator from the L^T rows into the head's sample rows;
// here that sequential k-axis is a loop inside the block and the head is
// blockIdx.z.
//
// What bounds it on an H100 SXM.  As designed, arithmetic, on the FMA units
// in IEEE fp32 (lambda = 1e-2 needs fp32 accuracy; no TF32, and wgmma has no
// IEEE fp32 mode): each head's L L^T is ~d^3/3 FLOPs (L lower-triangular, G
// symmetric), at d = 1280 0.70 GFLOP a head against n*d*(d+1) = 0.22 GFLOP
// for a head's ~136 sample rows, and this design RECOMPUTES L L^T for every
// head, K*d^3/3 FLOPs.  The work the inputs need counts L L^T once; then the
// K*(d^2 + d*C) fp32 outputs written (226 MB at K = 32, d = 1280, C = 100)
// outweigh those few GFLOP, and the bound is the bytes.  Forming L L^T once
// and adding each head's Z_k^T Z_k to it is later work.
//
// What this design does about that: one block per 64x64 tile of [G_k | B_k]
// with the tile loop of chol_gram_tile.cuh, the same code as chol_gram.cu
// (design notes there): only L's lower triangle read, each tile's factor
// sweep stopped at min(i0, j0) + 64, the lower tiles of each symmetric G_k
// computed and mirrored, no atomics and no split-K.  Ragged d, n and C are
// masked in the tile; n = 0 is legal and then B_k is exactly 0.  Every head
// of a launch is bitwise equal to chol_gram(L, Z_k, Y_k): the same sums, in
// the same order, with fmaf.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so batched_chol_gram.cu
//        (chol_gram_tile.cuh beside it)
// The C interface below is loaded with ctypes (kernels/chol_update.py).

#include <cuda_runtime.h>
#include <stddef.h>

#include "chol_gram_tile.cuh"

namespace {

using chol_gram_tile::BM;
using chol_gram_tile::BN;
using chol_gram_tile::THREADS;

__global__ void __launch_bounds__(THREADS)
batched_chol_gram_kernel(const float* __restrict__ L, const float* __restrict__ Z,
                         const float* __restrict__ Y, float* __restrict__ G,
                         float* __restrict__ B, int d, int n, int C) {
  const size_t h = blockIdx.z;
  chol_gram_tile::tile(L, Z + h * n * d, Y + h * n * C, G + h * d * d, B + h * d * C, d, n,
                       C, blockIdx.x, blockIdx.y);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  L is
// (d, d) lower-triangular (its upper triangle is not read), Z (K, n, d) and
// Y (K, n, C), all row-major fp32; n may be 0 (Z and Y are then not read);
// 1 <= K <= 65535.  G (K, d, d) and B (K, d, C) are written in full.
// Returns the launch's cudaError_t (0 on success).
int batched_chol_gram_launch(const float* L, const float* Z, const float* Y, float* G,
                             float* B, int K, int d, int n, int C, void* stream) {
  const dim3 grid((d + C + BN - 1) / BN, (d + BM - 1) / BM, K);
  batched_chol_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, Z, Y, G, B, d, n, C);
  return static_cast<int>(cudaGetLastError());
}

const char* batched_chol_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
