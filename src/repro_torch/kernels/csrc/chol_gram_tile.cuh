// The Gram tile loop shared by chol_gram.cu and batched_chol_gram.cu: an
// IEEE-fp32 SGEMM of the fused rank-n Cholesky-Gram update
// [G | B] = [L L^T + Z^T Z | Z^T Y] on Hopper's FMA units.
//
// Both right-hand terms are contractions over "rows" (the d rows of L^T,
// then the n sample rows of [Z | Y]), so one accumulator per output element
// sweeps the factor rows first and the sample rows second.  No stacked
// (d+n) x (d+C) operand, no L^T and no padded copy is built in device
// memory: every operand is read in place.
//
// The design.
// * Blocks for live tiles only.  With T = ceil(d / BT) and Tc = ceil(C / BT)
//   a launch has one block for each of the T(T+1)/2 tiles of G on or below
//   its diagonal and each of the T*Tc tiles of B (in a batched launch, that
//   grid for each head, blockIdx.y).  A tile (ti >= tj) of G sweeps the
//   factor rows k < min(i0, j0) + BT = j0 + BT only (L is lower-triangular),
//   so the G tiles go in order of tj descending: the longest sweeps start
//   first and the triangle's short tiles fill the last wave.  The B tiles,
//   which have no factor sweep, go last.
// * Register tiles: each of 256 threads keeps TM x TM accumulators (8 x 8
//   at BT = 128, 4 x 4 at BT = 64) in float4 groups, so four (two) 16-byte
//   shared loads feed 64 (16) FMAs.  A panel is stored [row of the sum]
//   [column of the tile] with a row pitch of BT + 4 floats; a warp's loads
//   at one k touch at most 16 distinct float4, free of bank conflicts.
// * A cp.async ring of STAGES panels of BK rows of both operands, the next
//   STAGES - 1 in flight while one is multiplied, one barrier a panel.
//   Sample panels are copied 16 bytes at a time where d and C are multiples
//   of 4 and the inputs 16-byte aligned, else 4; zero-fill masks the ragged
//   n, d and C.  Factor panels need L[i0 + r, k0 + kk] at [kk][r], a
//   transposed read of the row-major L: each warp's 4-byte copies walk two
//   rows of L in order (two 64-byte runs) and land each element transposed;
//   the pitch of BT + 4 keeps those stores at two-way bank conflicts and the
//   reads conflict-free.  Only L's lower triangle is read (k <= row).
// * All-zero sample panels are skipped, exactly.  When a sample panel has
//   landed, each thread tests the elements it copied (`!= 0.0f`, so the
//   -0.0 that masking leaves in padding rows counts as zero) and
//   __syncthreads_or, the ring's one barrier, tells the block whether any
//   element of the two panels is nonzero.  If none is, every step of the
//   panel would be fmaf(+-0, +-0, acc) = acc: an accumulator chain that
//   starts at +0 never holds -0, and adding +-0 to a value other than -0
//   returns it.  So the skip changes no bit, whatever the padding.
// * The epilogue stages the tile in shared memory (the ring's space) and
//   writes it row by row at (i, j) and, off the diagonal, the mirror row by
//   row at (j, i), so both stores coalesce.
// * Two modes.  The plain mode (chol_gram, and the batched refit's first
//   launch with n = 0 and no B tiles) sweeps L then the samples.  The heads
//   mode (batched_chol_gram's second launch) starts each accumulator of a G
//   tile from G0 = L L^T, the plain mode's result at n = 0, which holds
//   exactly the chain's value after the factor rows, and sweeps head
//   blockIdx.y's samples: the same chain as chol_gram(L, Z_k, Y_k).
//
// Determinism, and the bitwise contract.  No atomics and no split-K: each
// output element is one fmaf chain, from +0, over the factor rows in
// ascending k and then the sample rows in ascending order, in one thread.
// Only steps with a zero product (masked or skipped) differ from the chain
// of the first, 64 x 64 design of this loop, so G and B equal its results
// bitwise; both instances give the same bits; a launch is bitwise
// repeatable; G is exactly symmetric (fmaf(a, b, c) == fmaf(b, a, c), and
// the mirror is a copy); n = 0 gives B exactly 0; and the streaming
// engine's invariance to the order of concurrent arrivals holds bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Everything here has internal linkage (the unnamed namespace): both
// libraries include this header, and a template's static local with
// external linkage (launch's opt-in mask) is one symbol for every library a
// process loads, so one library's opt-in would stand for the other's kernel.
namespace chol_gram_tile {
namespace {

constexpr int BK = 16;     // rows of the sum a panel
constexpr int STAGES = 4;  // panels in the ring

template <int BT, int TM>
struct Tiling {
  static constexpr int TPR = BT / TM;              // threads along each side: 16
  static constexpr int THREADS = TPR * TPR;        // 256
  static constexpr int G = TM / 4;                 // float4 groups a thread owns a side
  static constexpr int GSTRIDE = BT / G;           // columns between its groups
  static constexpr int S = BT + 4;                 // the pitch of a panel row, floats
  static constexpr int PANEL = BK * S;             // floats of one operand a panel
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

// One sample panel of one operand: rows [k0, k0 + BK) x columns
// [c0, c0 + BT) of the row-major (n, width) matrix src, into dst[row][col]
// (pitch S); out-of-range entries are zero-filled.
template <int BT, int THREADS, bool VEC>
__device__ __forceinline__ void load_samples(float* dst, const float* __restrict__ src,
                                             int width, int c0, int k0, int n) {
  constexpr int S = BT + 4;
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
      cp_async16(dst + kk * S + c, ok ? src + (size_t)k * width + col : src, ok);
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
      cp_async4(dst + kk * S + c, ok ? src + (size_t)k * width + col : src, ok);
    }
  }
}

// Whether any element this thread copied into a sample panel by
// load_samples is nonzero (-0.0 is zero).  Read after this thread's copies
// have landed (cp.async.wait_group makes them visible to it).
template <int BT, int THREADS, bool VEC>
__device__ __forceinline__ bool copied_nonzero(const float* p) {
  constexpr int S = BT + 4;
  bool nz = false;
  if constexpr (VEC) {
    constexpr int CPR = BT / 4;
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const float4 v = *reinterpret_cast<const float4*>(p + (e / CPR) * S + (e % CPR) * 4);
      nz |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BK * BT / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      nz |= p[(e / BT) * S + e % BT] != 0.0f;
    }
  }
  return nz;
}

// One factor panel of one side: dst[kk][r] = L[r0 + r, k0 + kk] for the
// tile's BT rows and the panel's BK columns of the row-major (d, d) L, where
// k < k_end and k <= r0 + r (the lower triangle); else zero.  A warp's 32
// copies read two rows of L, 16 consecutive k each.
template <int BT, int THREADS>
__device__ __forceinline__ void load_factor(float* dst, const float* __restrict__ L, int d,
                                            int r0, int k0, int k_end) {
  constexpr int S = BT + 4;
  static_assert(BK * BT % THREADS == 0, "whole elements a thread");
#pragma unroll
  for (int it = 0; it < BK * BT / THREADS; ++it) {
    const int e = it * THREADS + threadIdx.x;
    const int r = e / BK;
    const int kk = e % BK;
    const int row = r0 + r;
    const int k = k0 + kk;
    const bool ok = row < d && k < k_end && k <= row;
    cp_async4(dst + kk * S + r, ok ? L + (size_t)row * d + k : L, ok);
  }
}

// Block t's output tile: G tiles (ti >= tj) by column tj descending, ti
// ascending within a column, then the B tiles row by row.
__device__ __forceinline__ void tile_of(int t, int T, int Tc, int& ti, int& tj, bool& is_b) {
  const long long tri = (long long)T * (T + 1) / 2;
  is_b = t >= tri;
  if (!is_b) {
    // the m columns nearest the right hold m(m+1)/2 tiles; find the m with
    // m(m+1)/2 <= t < (m+1)(m+2)/2: column T-1-m, its m+1 tiles
    long long m = (long long)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while ((m + 1) * (m + 2) / 2 <= t) ++m;
    while (m * (m + 1) / 2 > t) --m;
    tj = T - 1 - (int)m;
    ti = tj + (int)(t - m * (m + 1) / 2);
  } else {
    const int u = (int)(t - tri);
    ti = u / Tc;
    tj = u % Tc;
  }
}

// F is L in the plain mode and G0 = L L^T (d, d) in the heads mode.  Z (n, d)
// and Y (n, C) (in the heads mode (K, n, d) and (K, n, C)), G (d, d) and
// B (d, C) (each K of them), all row-major fp32.  Z, Y and B are not touched
// where n = 0 and the grid has no B tiles.
template <int BT, int TM, int MIN_BLOCKS, bool VEC, bool HEADS>
__global__ void __launch_bounds__(Tiling<BT, TM>::THREADS, MIN_BLOCKS)
gram_kernel(const float* __restrict__ F, const float* __restrict__ Z,
            const float* __restrict__ Y, float* __restrict__ G, float* __restrict__ B, int d,
            int n, int C) {
  using T_ = Tiling<BT, TM>;
  constexpr int THREADS = T_::THREADS;
  constexpr int GR = T_::G;
  constexpr int GS = T_::GSTRIDE;
  constexpr int S = T_::S;
  constexpr int PANEL = T_::PANEL;
  extern __shared__ __align__(16) float smem[];

  int ti, tj;
  bool is_b;
  tile_of(blockIdx.x, (d + BT - 1) / BT, (C + BT - 1) / BT, ti, tj, is_b);
  if constexpr (HEADS) {
    const size_t h = blockIdx.y;
    Z += h * n * d;
    Y += h * n * C;
    G += h * d * d;
    B += h * d * C;
  }
  const int i0 = ti * BT;
  const int j0 = tj * BT;
  // the column operand of the sample rows: Z (pitch d) for G, Y (pitch C) for B
  const float* __restrict__ Sj = is_b ? Y : Z;
  const int s_pitch = is_b ? C : d;
  // the factor sweep: k < min(i0, j0) + BT = j0 + BT, G tiles of the plain mode
  const int k_end = (HEADS || is_b) ? 0 : min(j0 + BT, d);
  const int PF = (k_end + BK - 1) / BK;
  const int P = PF + (n + BK - 1) / BK;

  const int tx = threadIdx.x % T_::TPR;
  const int ty = threadIdx.x / T_::TPR;

  // accumulator (r, c) is the tile's element
  // ((r / 4) * GS + ty * 4 + r % 4, (c / 4) * GS + tx * 4 + c % 4)
  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.0f;
  if constexpr (HEADS) {
    if (!is_b) {  // start from G0's tile: the chain after the factor rows
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = i0 + (r / 4) * GS + ty * 4 + r % 4;
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const int j = j0 + g * GS + tx * 4;
          if constexpr (VEC) {  // d % 4 == 0: four columns all in or all out
            if (i < d && j < d) {
              const float4 v = *reinterpret_cast<const float4*>(F + (size_t)i * d + j);
              acc[r][g * 4 + 0] = v.x; acc[r][g * 4 + 1] = v.y;
              acc[r][g * 4 + 2] = v.z; acc[r][g * 4 + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (i < d && j + q < d) acc[r][g * 4 + q] = F[(size_t)i * d + j + q];
          }
        }
      }
    }
  }

  auto issue = [&](int p) {
    float* st = smem + (p % STAGES) * 2 * PANEL;
    if (!HEADS && p < PF) {
      load_factor<BT, THREADS>(st, F, d, i0, p * BK, k_end);
      load_factor<BT, THREADS>(st + PANEL, F, d, j0, p * BK, k_end);
    } else {
      const int k0 = (p - PF) * BK;
      load_samples<BT, THREADS, VEC>(st, Z, d, i0, k0, n);
      load_samples<BT, THREADS, VEC>(st + PANEL, Sj, s_pitch, j0, k0, n);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < P) issue(s);
    cp_async_commit();
  }

  for (int p = 0; p < P; ++p) {
    cp_async_wait<STAGES - 2>();  // panel p has landed (this thread's copies) ...
    const float* Rs = smem + (p % STAGES) * 2 * PANEL;
    const float* Ss = Rs + PANEL;
    bool live = true;
    if (p < PF) {
      __syncthreads();  // ... everyone's, and panel p - 1 is free again
    } else {            // the same barrier, which also says whether the panel is all zero
      live = __syncthreads_or(copied_nonzero<BT, THREADS, VEC>(Rs) ||
                              copied_nonzero<BT, THREADS, VEC>(Ss));
    }
    if (p + STAGES - 1 < P) issue(p + STAGES - 1);
    cp_async_commit();

    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], w[TM];
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float4 va = *reinterpret_cast<const float4*>(Rs + kk * S + g * GS + ty * 4);
          const float4 vw = *reinterpret_cast<const float4*>(Ss + kk * S + g * GS + tx * 4);
          a[g * 4 + 0] = va.x; a[g * 4 + 1] = va.y; a[g * 4 + 2] = va.z; a[g * 4 + 3] = va.w;
          w[g * 4 + 0] = vw.x; w[g * 4 + 1] = vw.y; w[g * 4 + 2] = vw.z; w[g * 4 + 3] = vw.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TM; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is now the staging tile

  float* Cs = smem;
  constexpr int P1 = BT + 1;
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TM; ++c)
      Cs[((r / 4) * GS + ty * 4 + r % 4) * P1 + (c / 4) * GS + tx * 4 + c % 4] = acc[r][c];
  __syncthreads();

  float* __restrict__ out = is_b ? B : G;
#pragma unroll 4
  for (int e = threadIdx.x; e < BT * BT; e += THREADS) {  // (i, j): rows of the tile
    const int r = e / BT;
    const int c = e % BT;
    if (i0 + r < d && j0 + c < s_pitch) out[(size_t)(i0 + r) * s_pitch + j0 + c] = Cs[r * P1 + c];
  }
  if (!is_b && ti != tj) {
#pragma unroll 4
    for (int e = threadIdx.x; e < BT * BT; e += THREADS) {  // (j, i): columns of the tile
      const int c = e / BT;
      const int r = e % BT;
      if (j0 + c < d && i0 + r < d) G[(size_t)(j0 + c) * d + i0 + r] = Cs[r * P1 + c];
    }
  }
}

// One launch on `stream` over K heads (blockIdx.y; K = 1 in the plain mode):
// the G tiles, and the B tiles where `with_b`.  Returns the cudaError_t.
template <int BT, int TM, int MIN_BLOCKS, bool VEC, bool HEADS>
int launch(const float* F, const float* Z, const float* Y, float* G, float* B, int d, int n,
           int C, int K, bool with_b, cudaStream_t stream) {
  using T_ = Tiling<BT, TM>;
  auto kernel = gram_kernel<BT, TM, MIN_BLOCKS, VEC, HEADS>;
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
  const long long blocks = T * (T + 1) / 2 + (with_b ? T * Tc : 0);
  if (blocks >= (1ll << 31) || K < 1 || K > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(K));
  kernel<<<grid, T_::THREADS, T_::SMEM_BYTES, stream>>>(F, Z, Y, G, B, d, n, C);
  return static_cast<int>(cudaGetLastError());
}

// The instance for `tile` (128: 8 x 8 a thread, two blocks an SM; 64: 4 x 4,
// four blocks an SM), its sample copies 16 bytes wide where `vec`.
template <bool HEADS>
int dispatch(int tile, bool vec, const float* F, const float* Z, const float* Y, float* G,
             float* B, int d, int n, int C, int K, bool with_b, cudaStream_t s) {
  if (tile == 128) {
    return vec ? launch<128, 8, 2, true, HEADS>(F, Z, Y, G, B, d, n, C, K, with_b, s)
               : launch<128, 8, 2, false, HEADS>(F, Z, Y, G, B, d, n, C, K, with_b, s);
  }
  if (tile == 64) {
    return vec ? launch<64, 4, 4, true, HEADS>(F, Z, Y, G, B, d, n, C, K, with_b, s)
               : launch<64, 4, 4, false, HEADS>(F, Z, Y, G, B, d, n, C, K, with_b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 16-byte sample copies: d and C multiples of 4 and every pointer read
// 16 bytes at a time aligned to 16 bytes.
inline bool vector_copies(int d, int C, const void* a, const void* b, const void* c) {
  return d % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

}  // namespace
}  // namespace chol_gram_tile
