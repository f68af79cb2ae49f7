// Fused FED3R statistics A = Z^T Z (d x d) and b = Z^T Y (d x C), fp32.
//
// Replaces the TPU kernel `fed3r_stats_pallas` / `_stats_kernel` of
// src/repro/kernels/fed3r_stats.py: one blocked product Z^T [Z | Y] with
// A = its first d columns and b = its last C.
//
// What bounds it on an H100 SXM.  The engine feeds fp32 designs and the
// ridge solve at lambda = 1e-2 needs full fp32, so the products run in IEEE
// fp32 on the FMA units: 67 TFLOP/s, no tensor cores (wgmma has no IEEE
// fp32 mode, TF32 keeps ~3 digits, and a split-precision scheme would break
// the bitwise chain below).  A client of n samples needs n*d*(d+1) FLOPs
// for the symmetric A and about n*d more for b from a one-hot Y, over
// 4*(n*(d+C) + d*(d+C)) bytes: at d = 5000, n = 512 that is 12.8 GFLOP
// (0.19 ms) against 104 MB (0.03 ms), so it is bound by arithmetic, and
// the design is an SGEMM that feeds the FMA pipes and skips work A does
// not need.
//
// The design.
// * Only the tiles of A on or above the diagonal, plus the b tiles: with
//   T = ceil(d / BT) and Tc = ceil(C / BT) one block for each of the
//   T(T+1)/2 + T*Tc output tiles (820 + 40 at d = 5000, BT = 128).  The
//   epilogue stages the tile in shared memory and writes it row by row at
//   (i, j) and, off the diagonal, column by column at (j, i), so both
//   stores coalesce.  A diagonal tile is computed whole.
// * Register tiles: each of 256 threads keeps TM x TM accumulators (8 x 8
//   at BT = 128), two float4 groups a side, so four 16-byte shared loads
//   feed 64 FMAs.  The panels are stored [sample][column]: a warp's loads
//   touch at most 16 distinct float4, free of bank conflicts.
// * Loads that overlap the FMAs: a ring of STAGES panels of BK samples of
//   both operands in dynamic shared memory, filled with cp.async (16 bytes
//   a copy where d and C are multiples of 4 and the inputs 16-byte aligned,
//   else 4), the next STAGES - 1 panels in flight while one is multiplied,
//   one __syncthreads a panel.  Z and Y are read in place: the masked
//   copies zero-fill rows past n and columns past d or C, so the ragged
//   edges need no padded copy in device memory.
// * Two instances: BT = 128 (8 x 8 a thread) where the tiles fill the card
//   at least twice over, else BT = 64 (4 x 4 a thread), e.g. at d = 1280
//   where 128-wide tiles give 65 blocks for 132 SMs and 64-wide ones 230.
//   The wrapper picks the instance (kernels/fed3r_stats.py::pick_tile).
//
// Determinism, and the bitwise contract.  No atomics and no split-K: each
// output element is one fmaf chain over the samples in order, starting
// from +0, in one thread (the zero-filled samples past n add fmaf(0, 0,
// acc) = acc).  That is the chain of the first, 64 x 64 design of this
// kernel, so A and b equal its results bitwise; a launch is bitwise
// repeatable; A is exactly symmetric (fmaf(a, b, c) == fmaf(b, a, c), and
// the mirrored tile is a copy); and the engine's left fold over clients
// keeps A and b bitwise invariant under client permutation and
// re-sharding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so fed3r_stats.cu
// The C interface below is loaded with ctypes (kernels/fed3r_stats.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;     // samples a panel
constexpr int STAGES = 4;  // panels in the ring

template <int BT, int TM>
struct Tiling {
  static constexpr int TPR = BT / TM;              // threads along each side: 16
  static constexpr int THREADS = TPR * TPR;        // 256
  static constexpr int G = TM / 4;                 // float4 groups a thread owns a side
  static constexpr int GSTRIDE = BT / G;           // columns between its groups
  static constexpr int PANEL = BK * BT;            // floats of one operand a panel
  static constexpr int RING = STAGES * 2 * PANEL;  // floats
  static constexpr int EPI = BT * (BT + 1);        // the staged output tile, padded
  static constexpr int SMEM_BYTES = 4 * (RING > EPI ? RING : EPI);
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

// One panel of one operand: samples [k0, k0 + BK) x columns [c0, c0 + BT)
// of the row-major (n, width) matrix src of row pitch `pitch`, into
// dst[sample][column]; out-of-range entries are zero-filled.
template <int BT, int THREADS, bool VEC>
__device__ __forceinline__ void load_panel(float* dst, const float* __restrict__ src, int pitch,
                                           int width, int c0, int k0, int n) {
  if constexpr (VEC) {
    constexpr int CPR = BT / 4;  // 16-byte chunks a row
    static_assert(BK * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int kk = e / CPR;
      const int c = (e % CPR) * 4;
      const int k = k0 + kk;
      const int col = c0 + c;
      const bool ok = k < n && col < width;  // width % 4 == 0: a chunk is all in or all out
      cp_async16(dst + kk * BT + c, ok ? src + (size_t)k * pitch + col : src, ok);
    }
  } else {
    static_assert(BK * BT % THREADS == 0, "whole elements a thread");
#pragma unroll
    for (int it = 0; it < BK * BT / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int kk = e / BT;
      const int c = e % BT;
      const int k = k0 + kk;
      const int col = c0 + c;
      const bool ok = k < n && col < width;
      cp_async4(dst + kk * BT + c, ok ? src + (size_t)k * pitch + col : src, ok);
    }
  }
}

template <int BT, int TM, int MIN_BLOCKS, bool VEC>
__global__ void __launch_bounds__(Tiling<BT, TM>::THREADS, MIN_BLOCKS)
fed3r_stats_kernel(const float* __restrict__ Z, const float* __restrict__ Y,
                   float* __restrict__ A, float* __restrict__ b, int n, int d, int C) {
  using T_ = Tiling<BT, TM>;
  constexpr int THREADS = T_::THREADS;
  constexpr int G = T_::G;
  constexpr int GS = T_::GSTRIDE;
  constexpr int PANEL = T_::PANEL;
  extern __shared__ __align__(16) float smem[];

  // this block's output tile: the upper triangle of A row by row, then b
  const int T = (d + BT - 1) / BT;
  const int tri = T * (T + 1) / 2;
  int t = blockIdx.x;
  int ti = 0, tj = 0;
  const bool is_b = t >= tri;
  if (!is_b) {
    while (t >= T - ti) {
      t -= T - ti;
      ++ti;
    }
    tj = ti + t;
  } else {
    const int Tc = (C + BT - 1) / BT;
    ti = (t - tri) / Tc;
    tj = (t - tri) % Tc;
  }
  const int i0 = ti * BT;
  const int j0 = tj * BT;
  // the column operand: Z (pitch d) for A, Y (pitch C) for b
  const float* __restrict__ S = is_b ? Y : Z;
  const int s_pitch = is_b ? C : d;

  const int tx = threadIdx.x % T_::TPR;
  const int ty = threadIdx.x / T_::TPR;

  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.0f;

  const int panels = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < panels) {
      float* st = smem + s * 2 * PANEL;
      load_panel<BT, THREADS, VEC>(st, Z, d, d, i0, s * BK, n);
      load_panel<BT, THREADS, VEC>(st + PANEL, S, s_pitch, s_pitch, j0, s * BK, n);
    }
    cp_async_commit();
  }

  for (int p = 0; p < panels; ++p) {
    cp_async_wait<STAGES - 2>();  // panel p has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and panel p - 1 is free again
    const int pf = p + STAGES - 1;
    if (pf < panels) {
      float* st = smem + (pf % STAGES) * 2 * PANEL;
      load_panel<BT, THREADS, VEC>(st, Z, d, d, i0, pf * BK, n);
      load_panel<BT, THREADS, VEC>(st + PANEL, S, s_pitch, s_pitch, j0, pf * BK, n);
    }
    cp_async_commit();

    const float* Rs = smem + (p % STAGES) * 2 * PANEL;
    const float* Ss = Rs + PANEL;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TM];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(Rs + kk * BT + g * GS + ty * 4);
        const float4 vw = *reinterpret_cast<const float4*>(Ss + kk * BT + g * GS + tx * 4);
        a[g * 4 + 0] = va.x; a[g * 4 + 1] = va.y; a[g * 4 + 2] = va.z; a[g * 4 + 3] = va.w;
        w[g * 4 + 0] = vw.x; w[g * 4 + 1] = vw.y; w[g * 4 + 2] = vw.z; w[g * 4 + 3] = vw.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is now the staging tile

  float* Cs = smem;
  constexpr int P = BT + 1;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c)
      Cs[((r / 4) * GS + ty * 4 + r % 4) * P + (c / 4) * GS + tx * 4 + c % 4] = acc[r][c];
  __syncthreads();

  float* __restrict__ out = is_b ? b : A;
  const int o_pitch = is_b ? C : d;
#pragma unroll 4
  for (int e = threadIdx.x; e < BT * BT; e += THREADS) {  // (i, j): rows of the tile
    const int r = e / BT;
    const int c = e % BT;
    if (i0 + r < d && j0 + c < o_pitch) out[(size_t)(i0 + r) * o_pitch + j0 + c] = Cs[r * P + c];
  }
  if (!is_b && ti != tj) {
#pragma unroll 4
    for (int e = threadIdx.x; e < BT * BT; e += THREADS) {  // (j, i): columns of the tile
      const int c = e / BT;
      const int r = e % BT;
      if (j0 + c < d && i0 + r < d) A[(size_t)(j0 + c) * d + i0 + r] = Cs[r * P + c];
    }
  }
}

template <int BT, int TM, int MIN_BLOCKS, bool VEC>
int launch(const float* Z, const float* Y, float* A, float* b, int n, int d, int C,
           cudaStream_t stream) {
  using T_ = Tiling<BT, TM>;
  auto kernel = fed3r_stats_kernel<BT, TM, MIN_BLOCKS, VEC>;
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
  const long long T = (d + BT - 1) / BT;
  const long long Tc = (C + BT - 1) / BT;
  const long long blocks = T * (T + 1) / 2 + T * Tc;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), T_::THREADS, T_::SMEM_BYTES, stream>>>(
      Z, Y, A, b, n, d, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as an opaque pointer).  Z is
// (n, d) and Y is (n, C), both row-major fp32; A (d, d) and b (d, C) are
// written in full.  `tile` picks the instance, 128 or 64.  Returns the
// launch's cudaError_t (0 on success).
int fed3r_stats_launch(const float* Z, const float* Y, float* A, float* b, int n, int d, int C,
                       int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(Z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  if (tile == 128) {
    return vec ? launch<128, 8, 2, true>(Z, Y, A, b, n, d, C, s)
               : launch<128, 8, 2, false>(Z, Y, A, b, n, d, C, s);
  }
  if (tile == 64) {
    return vec ? launch<64, 4, 4, true>(Z, Y, A, b, n, d, C, s)
               : launch<64, 4, 4, false>(Z, Y, A, b, n, d, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fed3r_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
