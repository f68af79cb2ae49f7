// Fused random-features map psi = sqrt(2/D) * cos(Z Omega + beta), fp32.
//
// Replaces the TPU kernel `rff_pallas` / `_rff_kernel` of
// src/repro/kernels/rff.py: FED3R-RF (paper Sec. 4.2) maps every client's
// features Z (n x d) through D random Fourier features before the statistics
// pass.  Unfused, the (n x D) pre-activation Z Omega makes a round trip
// through device memory between the GEMM and the cos; here it stays in
// registers and the epilogue (bias, cos, scale) runs before the one write of
// psi.
//
// What bounds it on an H100 SXM.  2*n*d*D FLOPs over (n*d + d*D + D + n*D)*4
// bytes: at the FED3R-RF shard shape n = 5120, d = 1280, D = 5000 that is
// 65.5 GFLOP against 154 MB, 0.98 ms of fp32 FMA at 67 TFLOP/s against
// 0.05 ms of HBM, so it is bound by arithmetic.  The products run in IEEE
// fp32 on the FMA units (no TF32): cos of an argument near 2*pi amplifies
// the product's absolute error, and psi feeds a ridge solve at lambda = 1e-2.
//
// What this design does about that.  Each block owns one 64x64 tile of psi
// (64 samples x 64 features) and loops over d inside the block, staging a
// 16-deep panel of Z and of Omega in shared memory per step; each of its 256
// threads keeps a 4x4 fp32 register micro-tile, so one shared-memory read
// feeds two FMAs.  The ragged edges of n, d and D are masked here: no padded
// copy is built in device memory.  The epilogue uses the accurate cosf (not
// __cosf, and no --use_fast_math): its argument runs over [0, 2*pi) + Z Omega,
// where __cosf's error grows.
//
// Making it fast (larger register tiles, double-buffered staging with
// cp.async or TMA, a split-precision tensor-core product that keeps fp32
// accuracy) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so rff.cu
// The C interface below is loaded with ctypes (kernels/rff.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;                   // samples per output tile
constexpr int BN = 64;                   // random features per output tile
constexpr int BK = 16;                   // input features staged per step
constexpr int TM = 4;                    // micro-tile rows per thread
constexpr int TN = 4;                    // micro-tile cols per thread
constexpr int TY = BM / TM;              // 16 thread rows
constexpr int TX = BN / TN;              // 16 thread cols
constexpr int THREADS = TY * TX;         // 256

__global__ void __launch_bounds__(THREADS)
rff_kernel(const float* __restrict__ Z, const float* __restrict__ omega,
           const float* __restrict__ beta, float* __restrict__ out,
           int n, int d, int D, float scale) {
  // +1 column: the Z panel is written with kk fastest (coalesced reads of a
  // sample row), which would put a warp's stores in one bank otherwise
  __shared__ float zs[BK][BM + 1];  // Z[s0 + r, k0 + kk]
  __shared__ float ws[BK][BN];      // Omega[k0 + kk, j0 + c]

  const int s0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
      const int kk = e % BK;
      const int r = e / BK;
      const int k = k0 + kk;
      const int s = s0 + r;
      zs[kk][r] = (k < d && s < n) ? Z[(size_t)s * d + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int c = e % BN;
      const int k = k0 + kk;
      const int j = j0 + c;
      ws[kk][c] = (k < d && j < D) ? omega[(size_t)k * D + j] : 0.0f;
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
  for (int c = 0; c < TN; ++c) {
    const int j = j0 + tx + c * TX;
    if (j >= D) continue;
    const float b = beta[j];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int s = s0 + ty + r * TY;
      if (s < n) out[(size_t)s * D + j] = scale * cosf(acc[r][c] + b);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  Z is
// (n, d), omega (d, D) and beta (D,), all row-major fp32; out (n, D) is
// written in full with sqrt(2/D) * cos(Z omega + beta).  Returns the launch's
// cudaError_t (0 on success).
int rff_launch(const float* Z, const float* omega, const float* beta, float* out,
               int n, int d, int D, float scale, void* stream) {
  const dim3 grid((D + BN - 1) / BN, (n + BM - 1) / BM);
  rff_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Z, omega, beta, out, n, d, D, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* rff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
