// One 64x64 tile of the fused rank-n Cholesky-Gram update
// [G | B] = [L L^T + Z^T Z | Z^T Y], fp32, shared by chol_gram.cu (one update)
// and batched_chol_gram.cu (K updates against one L, the head as blockIdx.z).
//
// Both right-hand terms are contractions over "rows" (the d rows of L^T, then
// the n sample rows of [Z | Y]), so one accumulator per output element sweeps
// the factor rows first and the sample rows second; no stacked (d+n) x (d+C)
// operand is built in device memory.
//
//  * It reads only the lower triangle of L and skips the zero upper triangle:
//    a tile of G sums the factor rows only up to k < min(i0 + BM, j0 + BN).
//  * G is symmetric: blocks of the strictly upper tiles of G exit at once,
//    and each strictly lower tile also writes its transpose.  The two
//    would-be copies are the same sums in the same order, and fmaf(a, b, c)
//    == fmaf(b, a, c), so G is exactly symmetric either way.
//  * Each block owns one 64x64 tile of [G | B] and loops first over the
//    factor rows (only for columns < d: [L^T | 0] adds nothing to B), then
//    over the sample rows; each of its 256 threads keeps a 4x4 fp32 register
//    micro-tile fed from 16-deep shared-memory panels, as in fed3r_stats.cu.
//    Columns < d of the sample panel come from Z and columns >= d from Y,
//    read in place, and every ragged edge is masked here.
//  * n = 0 is legal: the sample loop does not run and B is exactly 0.
//
// Determinism.  No atomics and no split-K: each output element is summed by
// one thread, factor rows then sample rows, in order, with fmaf.  A launch is
// bitwise reproducible, and the same tile of the same (L, Z, Y) gives the same
// bits in either kernel.

#pragma once

#include <stddef.h>

namespace chol_gram_tile {

constexpr int BM = 64;                   // rows of the output tile (i of G)
constexpr int BN = 64;                   // cols of the output tile (j of [G | B])
constexpr int BK = 16;                   // factor or sample rows staged per step
constexpr int TM = 4;                    // micro-tile rows per thread
constexpr int TN = 4;                    // micro-tile cols per thread
constexpr int TY = BM / TM;              // 16 thread rows
constexpr int TX = BN / TN;              // 16 thread cols
constexpr int THREADS = TY * TX;         // 256
static_assert(BM == BN, "the mirror of a tile of G is a tile of the same grid");

// Tile (by, bx) of [G | B] for L (d, d) lower-triangular, Z (n, d), Y (n, C),
// G (d, d), B (d, C), all row-major fp32.  Called by all THREADS threads of a
// block with block-uniform arguments (the early return is block-uniform).
__device__ __forceinline__ void tile(const float* __restrict__ L, const float* __restrict__ Z,
                                     const float* __restrict__ Y, float* __restrict__ G,
                                     float* __restrict__ B, int d, int n, int C, int bx,
                                     int by) {
  // +1 column: the factor panels are written with kk fastest (coalesced reads
  // along a row of L), which would put a warp's stores in one bank otherwise
  __shared__ float as[BK][BM + 1];  // rows i of the tile: L[i, k] or Z[k, i]
  __shared__ float ws[BK][BN + 1];  // cols j of the tile: L[j, k] or [Z | Y][k, j]

  const int i0 = by * BM;
  const int j0 = bx * BN;
  // the G columns of this tile lie strictly above the diagonal
  const bool upper = bx > by;
  if (upper && j0 + BN <= d) return;  // only G columns: the mirror writes them
  const bool mirror = bx < by;        // strictly lower: write the transpose too
  const int e_total = d + C;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  // Phase 1: G += L L^T over the factor rows k.  L[i, k] = 0 for k > i, so
  // no element of the tile needs k >= min(i0 + BM, j0 + BN).
  if (j0 < d && !upper) {
    int k_end = min(i0 + BM, j0 + BN);
    if (k_end > d) k_end = d;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
      for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
        const int kk = e % BK;
        const int r = e / BK;
        const int k = k0 + kk;
        const int i = i0 + r;
        const int j = j0 + r;
        // lower triangle only (k <= row); the upper triangle is never read
        as[kk][r] = (k < k_end && i < d && k <= i) ? L[(size_t)i * d + k] : 0.0f;
        ws[kk][r] = (k < k_end && j < d && k <= j) ? L[(size_t)j * d + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
        float w[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = as[kk][ty + r * TY];
#pragma unroll
        for (int c = 0; c < TN; ++c) w[c] = ws[kk][tx + c * TX];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

  // Phase 2: [G | B] += Z^T [Z | Y] over the sample rows (none when n = 0).
  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
      const int kk = e / BM;
      const int c = e % BM;
      const int k = k0 + kk;
      const int i = i0 + c;
      const int j = j0 + c;
      as[kk][c] = (k < n && i < d) ? Z[(size_t)k * d + i] : 0.0f;
      float v = 0.0f;
      if (k < n) {
        if (j < d) {
          v = Z[(size_t)k * d + j];
        } else if (j < e_total) {
          v = Y[(size_t)k * C + (j - d)];
        }
      }
      ws[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float w[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = as[kk][ty + r * TY];
#pragma unroll
      for (int c = 0; c < TN; ++c) w[c] = ws[kk][tx + c * TX];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + r * TY;
    if (i >= d) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + tx + c * TX;
      if (j < d) {
        if (upper) continue;  // written by the mirror of tile (by, bx)
        G[(size_t)i * d + j] = acc[r][c];
        if (mirror) G[(size_t)j * d + i] = acc[r][c];
      } else if (j < e_total) {
        B[(size_t)i * C + (j - d)] = acc[r][c];
      }
    }
  }
}

}  // namespace chol_gram_tile
