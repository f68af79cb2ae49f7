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
// What this design does about that.
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
// bitwise reproducible, which the streaming engine's bitwise invariance to
// the order of concurrent arrivals rests on.
//
// Making it fast (larger register tiles, double-buffered staging, staging the
// mirrored tile through shared memory for coalesced stores, a split-precision
// tensor-core product) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so chol_gram.cu
// The C interface below is loaded with ctypes (kernels/chol_update.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;                   // rows of the output tile (i of G)
constexpr int BN = 64;                   // cols of the output tile (j of [G | B])
constexpr int BK = 16;                   // factor or sample rows staged per step
constexpr int TM = 4;                    // micro-tile rows per thread
constexpr int TN = 4;                    // micro-tile cols per thread
constexpr int TY = BM / TM;              // 16 thread rows
constexpr int TX = BN / TN;              // 16 thread cols
constexpr int THREADS = TY * TX;         // 256
static_assert(BM == BN, "the mirror of a tile of G is a tile of the same grid");

__global__ void __launch_bounds__(THREADS)
chol_gram_kernel(const float* __restrict__ L, const float* __restrict__ Z,
                 const float* __restrict__ Y, float* __restrict__ G,
                 float* __restrict__ B, int d, int n, int C) {
  // +1 column: the factor panels are written with kk fastest (coalesced reads
  // along a row of L), which would put a warp's stores in one bank otherwise
  __shared__ float as[BK][BM + 1];  // rows i of the tile: L[i, k] or Z[k, i]
  __shared__ float ws[BK][BN + 1];  // cols j of the tile: L[j, k] or [Z | Y][k, j]

  const int bx = blockIdx.x;
  const int by = blockIdx.y;
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
