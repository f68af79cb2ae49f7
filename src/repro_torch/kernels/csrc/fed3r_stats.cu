// Fused FED3R statistics A = Z^T Z (d x d) and b = Z^T Y (d x C), fp32.
//
// Replaces the TPU kernel `fed3r_stats_pallas` / `_stats_kernel` of
// src/repro/kernels/fed3r_stats.py: one blocked GEMM M = Z^T [Z | Y] with
// A = M[:, :d] and b = M[:, d:].
//
// What bounds it on an H100 SXM.  The engine feeds fp32 designs and the
// ridge solve at lambda = 1e-2 needs full fp32, so the products run in IEEE
// fp32 on the FMA units: 67 TFLOP/s, with no tensor cores (TF32 keeps ~3
// digits and is not used).  At d = 1280, C = 100, n = 256 one client needs
// n*d*(d+1) FLOPs for the symmetric A plus n*d adds for b from a one-hot Y,
// 0.42 GFLOP, over ~8.5 MB (Z and Y read once, A and b written once): 6.3 us
// of FMA against 2.5 us of HBM, so it is bound by arithmetic.  This design
// computes all of A and a dense Z^T Y, 2*n*d*(d+C) = 0.9 GFLOP, 2.15x that.
//
// What this design does about that.  It keeps every operand of the FMAs in
// registers or shared memory: each block owns one 64x64 tile of [A | b],
// stages a 16-sample panel of Z (its rows of A) and of [Z | Y] (its columns)
// in shared memory per step, and each of its 256 threads keeps a 4x4 fp32
// register micro-tile, so one shared-memory read feeds two FMAs.  The loop
// over samples inside the block stands in for the TPU's sequential k grid
// axis.  Columns < d come from Z and columns >= d from Y, read in place, and
// the ragged edges (n, d, d+C not multiples of the tile) are masked to zero
// here: no concatenated or padded copy is built in device memory.
//
// Determinism.  No atomics and no split-K: each output element is summed by
// one thread, in sample order, with fmaf.  A launch is therefore bitwise
// reproducible, A is exactly symmetric (fmaf(a, b, c) == fmaf(b, a, c)), and
// the engine's left fold over clients keeps A and b bitwise invariant under
// client permutation and re-sharding.
//
// Making it fast (wgmma is not open to IEEE fp32; skipping the tiles below
// the diagonal of A; TMA staging; folding the client sum into the epilogue)
// is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so fed3r_stats.cu
// The C interface below is loaded with ctypes (kernels/fed3r_stats.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;                   // rows of the output tile (i of A)
constexpr int BN = 64;                   // cols of the output tile (j of [A | b])
constexpr int BK = 16;                   // samples staged per step
constexpr int TM = 4;                    // micro-tile rows per thread
constexpr int TN = 4;                    // micro-tile cols per thread
constexpr int TY = BM / TM;              // 16 thread rows
constexpr int TX = BN / TN;              // 16 thread cols
constexpr int THREADS = TY * TX;         // 256

__global__ void __launch_bounds__(THREADS)
fed3r_stats_kernel(const float* __restrict__ Z, const float* __restrict__ Y,
                   float* __restrict__ A, float* __restrict__ b,
                   int n, int d, int C) {
  __shared__ float zs[BK][BM];  // Z[k0 + kk, i0 + r]
  __shared__ float ws[BK][BN];  // [Z | Y][k0 + kk, j0 + c]

  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int e_total = d + C;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    // Stage both panels; neighbouring threads read neighbouring columns of
    // one sample row, so every global load is coalesced.
    for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
      const int kk = e / BM;
      const int c = e % BM;
      const int k = k0 + kk;
      const int i = i0 + c;
      zs[kk][c] = (k < n && i < d) ? Z[(size_t)k * d + i] : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int c = e % BN;
      const int k = k0 + kk;
      const int j = j0 + c;
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
      for (int r = 0; r < TM; ++r) a[r] = zs[kk][ty + r * TY];
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
        A[(size_t)i * d + j] = acc[r][c];
      } else if (j < e_total) {
        b[(size_t)i * C + (j - d)] = acc[r][c];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  Z is
// (n, d) and Y is (n, C), both row-major fp32; A (d, d) and b (d, C) are
// written in full.  Returns the launch's cudaError_t (0 on success).
int fed3r_stats_launch(const float* Z, const float* Y, float* A, float* b,
                       int n, int d, int C, void* stream) {
  const dim3 grid((d + C + BN - 1) / BN, (d + BM - 1) / BM);
  fed3r_stats_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Z, Y, A, b, n, d, C);
  return static_cast<int>(cudaGetLastError());
}

const char* fed3r_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
