// Fused random-features map psi = sqrt(2/D) * cos(Z Omega + beta), fp32.
//
// Replaces the TPU kernel `rff_pallas` / `_rff_kernel` of
// src/repro/kernels/rff.py: FED3R-RF (paper Sec. 4.2) maps every client's
// features Z (n x d) through D random Fourier features before the statistics
// pass, and the streaming engine maps every wave.  Unfused, the (n x D)
// pre-activation Z Omega makes a round trip through device memory between
// the GEMM and the cos; here it stays in registers and the epilogue (bias,
// cos, scale) runs before the one write of psi.
//
// What bounds it on an H100 SXM.  2*n*d*D FLOPs over (n*d + d*D + D + n*D)*4
// bytes: at the FED3R-RF shard shape n = 5120, d = 1280, D = 5000 that is
// 65.5 GFLOP against 154 MB, 0.98 ms of fp32 FMA at 67 TFLOP/s against
// 0.05 ms of HBM, so it is bound by arithmetic.  The products run in IEEE
// fp32 on the FMA units: cos of an argument near 2*pi amplifies the
// product's absolute error, psi feeds a ridge solve at lambda = 1e-2, and
// the chain below rules out tensor cores (wgmma has no IEEE fp32 mode; a
// split-precision scheme would round differently).
//
// The design: an NN SGEMM (Z by rows, Omega by columns) that feeds the FMA
// pipes, with the cos in its epilogue.
// * Register tiles: each of 256 threads keeps TM x TM accumulators, 8 x 8 in
//   the 128 x 128 instance, 4 x 4 in the 64 x 64 one, in float4 groups.
// * Omega's panel (BK rows of k x BT features) is already in the FMA loop's
//   [k][feature] layout: one 16-byte shared load gives a thread four
//   features at one k.  Z's panel is stored as it is read, [sample][k] with
//   a row pitch of BK + 4 floats: one 16-byte shared load gives a thread one
//   sample at four k, so 8 (4) loads of Z and 8 (4) of Omega feed 256 (64)
//   FMAs over four k steps.  The pitch puts the two sample rows a warp
//   reads 4 rows apart on disjoint banks.
// * Loads that overlap the FMAs: a ring of STAGES panels of BK = 16 k steps
//   in dynamic shared memory, filled with cp.async, the next STAGES - 1
//   panels in flight while one is multiplied, one __syncthreads a panel.
//   Copies are 16 bytes wide where the row widths are multiples of 4 and
//   the pointers 16-byte aligned (Z and Omega apart), else 4.  The masked
//   copies zero-fill samples past n, k past d and features past D, so the
//   ragged edges need no padded copy in device memory.
// * The epilogue reads each thread's beta once and writes psi with 16-byte
//   stores where D % 4 == 0 (a warp's stores are two runs of 256 bytes).
//   It uses the accurate cosf (not __cosf, and no --use_fast_math): the
//   argument runs over [0, 2*pi) + Z Omega, where __cosf's error grows.
// * Two instances: 128 x 128 tiles (two blocks an SM) where their blocks
//   fill the card at least twice over, else 64 x 64 (four blocks an SM).
//   The wrapper picks the instance (kernels/rff.py::pick_tile).
//
// Determinism, and the bitwise contract.  No atomics and no split-K: each
// element of psi is one fmaf chain over k = 0 .. d-1 in ascending order,
// from +0, in one thread, then __fmul_rn(scale, cosf(__fadd_rn(acc,
// beta_j))), spelled out so that nothing is contracted.  The masked k steps
// past d add fmaf(+0, +0, acc), and no instance differs from another in
// anything but which thread runs a chain.  So psi equals the first, 64 x 64
// design of this kernel bitwise; both instances give the same bits; and a
// sample row's psi is the same bits wherever it sits in Z and whatever n is,
// which is what keeps the rf and streaming engines bitwise invariant to the
// order of clients and arrivals once psi is on their paths.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so rff.cu
// The C interface below is loaded with ctypes (kernels/rff.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;       // k steps a panel
constexpr int STAGES = 4;    // panels in the ring
constexpr int ZP = BK + 4;   // the pitch of a row of Z's panel, floats

template <int BT, int TM>
struct Tiling {
  static constexpr int TPR = BT / TM;                // threads along each side: 16
  static constexpr int THREADS = TPR * TPR;          // 256
  static constexpr int G = TM / 4;                   // float4 groups a thread owns a side
  static constexpr int GSTRIDE = BT / G;             // rows (features) between its groups
  static constexpr int ZPANEL = BT * ZP;             // Z's panel, [sample][k]
  static constexpr int WPANEL = BK * BT;             // Omega's panel, [k][feature]
  static constexpr int STAGE = ZPANEL + WPANEL;      // floats
  static constexpr int SMEM_BYTES = 4 * STAGES * STAGE;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Z's panel: samples [s0, s0 + BT) x k [k0, k0 + BK) of the row-major
// (n, d) Z into dst[sample][k] (pitch ZP); out-of-range entries are zero.
template <int BT, int THREADS, bool VEC>
__device__ __forceinline__ void load_z(float* dst, const float* __restrict__ Z, int n, int d,
                                       int s0, int k0) {
  if constexpr (VEC) {
    constexpr int CPR = BK / 4;  // 16-byte chunks a row
    static_assert(BT * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < BT * CPR / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int r = e / CPR;
      const int c = (e % CPR) * 4;
      const int s = s0 + r;
      const int k = k0 + c;
      const bool ok = s < n && k < d;  // d % 4 == 0: a chunk is all in or all out
      cp_async16(dst + r * ZP + c, ok ? Z + (size_t)s * d + k : Z, ok);
    }
  } else {
    static_assert(BT * BK % THREADS == 0, "whole elements a thread");
#pragma unroll
    for (int it = 0; it < BT * BK / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int r = e / BK;
      const int c = e % BK;
      const int s = s0 + r;
      const int k = k0 + c;
      const bool ok = s < n && k < d;
      cp_async4(dst + r * ZP + c, ok ? Z + (size_t)s * d + k : Z, ok);
    }
  }
}

// Omega's panel: k [k0, k0 + BK) x features [j0, j0 + BT) of the row-major
// (d, D) Omega into dst[k][feature] (pitch BT); out-of-range entries are zero.
template <int BT, int THREADS, bool VEC>
__device__ __forceinline__ void load_w(float* dst, const float* __restrict__ W, int d, int D,
                                       int j0, int k0) {
  if constexpr (VEC) {
    constexpr int CPR = BT / 4;
    static_assert(BK * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int kk = e / CPR;
      const int c = (e % CPR) * 4;
      const int k = k0 + kk;
      const int j = j0 + c;
      const bool ok = k < d && j < D;  // D % 4 == 0: a chunk is all in or all out
      cp_async16(dst + kk * BT + c, ok ? W + (size_t)k * D + j : W, ok);
    }
  } else {
    static_assert(BK * BT % THREADS == 0, "whole elements a thread");
#pragma unroll
    for (int it = 0; it < BK * BT / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int kk = e / BT;
      const int c = e % BT;
      const int k = k0 + kk;
      const int j = j0 + c;
      const bool ok = k < d && j < D;
      cp_async4(dst + kk * BT + c, ok ? W + (size_t)k * D + j : W, ok);
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float feature(float acc, float b, float scale) {
  return __fmul_rn(scale, cosf(__fadd_rn(acc, b)));
}

// VZ: Z's copies 16 bytes wide; VW: Omega's copies and psi's stores 16 bytes wide.
template <int BT, int TM, int MIN_BLOCKS, bool VZ, bool VW>
__global__ void __launch_bounds__(Tiling<BT, TM>::THREADS, MIN_BLOCKS)
rff_kernel(const float* __restrict__ Z, const float* __restrict__ omega,
           const float* __restrict__ beta, float* __restrict__ out, int n, int d, int D,
           float scale) {
  using T_ = Tiling<BT, TM>;
  constexpr int THREADS = T_::THREADS;
  constexpr int G = T_::G;
  constexpr int GS = T_::GSTRIDE;
  extern __shared__ __align__(16) float smem[];

  const int j0 = blockIdx.x * BT;
  const int s0 = blockIdx.y * BT;
  const int tx = threadIdx.x % T_::TPR;
  const int ty = threadIdx.x / T_::TPR;

  // accumulator (r, c) is psi's element
  // (s0 + (r / 4) * GS + ty * 4 + r % 4, j0 + (c / 4) * GS + tx * 4 + c % 4)
  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.0f;

  const int panels = (d + BK - 1) / BK;
  auto issue = [&](int p) {
    float* st = smem + (p % STAGES) * T_::STAGE;
    load_z<BT, THREADS, VZ>(st, Z, n, d, s0, p * BK);
    load_w<BT, THREADS, VW>(st + T_::ZPANEL, omega, d, D, j0, p * BK);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < panels) issue(s);
    cp_async_commit();
  }

  for (int p = 0; p < panels; ++p) {
    cp_async_wait<STAGES - 2>();  // panel p has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and panel p - 1 is free again
    if (p + STAGES - 1 < panels) issue(p + STAGES - 1);
    cp_async_commit();

    const float* Zs = smem + (p % STAGES) * T_::STAGE;
    const float* Ws = Zs + T_::ZPANEL;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 za[TM];  // the thread's samples at k4 .. k4 + 3
#pragma unroll
      for (int r = 0; r < TM; ++r)
        za[r] = *reinterpret_cast<const float4*>(Zs + ((r / 4) * GS + ty * 4 + r % 4) * ZP + k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {  // k ascending: the chain's order
        float w[TM];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vw = *reinterpret_cast<const float4*>(Ws + (k4 + kq) * BT + g * GS + tx * 4);
          w[g * 4 + 0] = vw.x; w[g * 4 + 1] = vw.y; w[g * 4 + 2] = vw.z; w[g * 4 + 3] = vw.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float a = lane(za[r], kq);
#pragma unroll
          for (int c = 0; c < TM; ++c) acc[r][c] = fmaf(a, w[c], acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can be left; nothing lands after exit

  float b[TM];  // the thread's features' beta
#pragma unroll
  for (int c = 0; c < TM; ++c) {
    const int j = j0 + (c / 4) * GS + tx * 4 + c % 4;
    b[c] = j < D ? __ldg(beta + j) : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int s = s0 + (r / 4) * GS + ty * 4 + r % 4;
    if (s >= n) continue;
    float* __restrict__ orow = out + (size_t)s * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + g * GS + tx * 4;
      const int c = g * 4;
      if constexpr (VW) {  // D % 4 == 0: four features all in or all out
        if (j < D) {
          float4 o;
          o.x = feature(acc[r][c + 0], b[c + 0], scale);
          o.y = feature(acc[r][c + 1], b[c + 1], scale);
          o.z = feature(acc[r][c + 2], b[c + 2], scale);
          o.w = feature(acc[r][c + 3], b[c + 3], scale);
          *reinterpret_cast<float4*>(orow + j) = o;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < D) orow[j + q] = feature(acc[r][c + q], b[c + q], scale);
      }
    }
  }
}

template <int BT, int TM, int MIN_BLOCKS, bool VZ, bool VW>
int launch(const float* Z, const float* omega, const float* beta, float* out, int n, int d,
           int D, float scale, cudaStream_t stream) {
  using T_ = Tiling<BT, TM>;
  auto kernel = rff_kernel<BT, TM, MIN_BLOCKS, VZ, VW>;
  // above 48 KB of dynamic shared memory needs the opt-in, once a device
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T_::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in |= 1ull << dev;
  }
  const long long tiles_n = (n + BT - 1) / BT;
  if (tiles_n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + BT - 1) / BT, static_cast<unsigned>(tiles_n));
  kernel<<<grid, T_::THREADS, T_::SMEM_BYTES, stream>>>(Z, omega, beta, out, n, d, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int BT, int TM, int MIN_BLOCKS>
int dispatch(bool vz, bool vw, const float* Z, const float* omega, const float* beta, float* out,
             int n, int d, int D, float scale, cudaStream_t s) {
  if (vz) {
    return vw ? launch<BT, TM, MIN_BLOCKS, true, true>(Z, omega, beta, out, n, d, D, scale, s)
              : launch<BT, TM, MIN_BLOCKS, true, false>(Z, omega, beta, out, n, d, D, scale, s);
  }
  return vw ? launch<BT, TM, MIN_BLOCKS, false, true>(Z, omega, beta, out, n, d, D, scale, s)
            : launch<BT, TM, MIN_BLOCKS, false, false>(Z, omega, beta, out, n, d, D, scale, s);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  Z is
// (n, d), omega (d, D) and beta (D,), all row-major fp32; out (n, D) is
// written in full with sqrt(2/D) * cos(Z omega + beta).  `tile` picks the
// instance, 128 or 64.  Z's copies are 16 bytes wide where d % 4 == 0 and Z
// is 16-byte aligned; Omega's copies and out's stores where D % 4 == 0 and
// both are 16-byte aligned.  Returns the launch's cudaError_t (0 on success).
int rff_launch(const float* Z, const float* omega, const float* beta, float* out, int n, int d,
               int D, float scale, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vz = d % 4 == 0 && reinterpret_cast<uintptr_t>(Z) % 16 == 0;
  const bool vw = D % 4 == 0 && reinterpret_cast<uintptr_t>(omega) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (tile == 128) return dispatch<128, 8, 2>(vz, vw, Z, omega, beta, out, n, d, D, scale, s);
  if (tile == 64) return dispatch<64, 4, 4>(vz, vw, Z, omega, beta, out, n, d, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
