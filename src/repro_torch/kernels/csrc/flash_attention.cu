// Causal GQA flash attention with an online softmax and an optional sliding
// window: the prefill attention of the dense backbone.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  Inputs q (B, S, H, hd) and k, v
// (B, S, KV, hd), all bf16 or all fp32; query head h reads KV head
// h / (H / KV).  For each query row, over key tiles in order:
//
//   s     = (q . k^T in fp32) * hd^-0.5          (scale on the fp32 scores)
//   s     = -1e30 outside  k <= q  (causal)  and  k > q - W  (window W)
//   m'    = max(m, rowmax s);  alpha = exp(m - m');  p = exp(s - m')
//   l     = l * alpha + sum p                      (p unrounded, fp32)
//   acc   = acc * alpha + (p rounded to v's type) . v   (fp32 accumulation)
//   out   = acc / max(l, 1e-20), rounded to q's type
//
// exactly as the Pallas kernel orders it, with the accurate expf (no
// fast-math).  A row whose first tiles are all masked sums exp(0) = 1 per
// entry until its first valid tile drives alpha to exp(-1e30 - m') = 0;
// every row reaches its diagonal, so the result is right, and nothing here
// may shortcut that update.  Keys at or past S are masked too, so any
// S >= 1 works (the ragged last tile is zero-filled, never read past S).
//
// What bounds it on an H100 SXM.  Operations: 4 * B * H * hd FLOPs per
// (query, key) pair the mask keeps, S(S+1)/2 pairs causal; at the serving
// shape (8, 2048, 28 heads, 4 KV heads, hd 128) 2.4e11 FLOPs, 0.243 ms at
// the 989 TFLOP/s of the bf16 tensor cores, against 0.03 ms for the bytes
// (q, k, v, o once at 3.35 TB/s).  In fp32 the bound is the 67 TFLOP/s of
// the FMA units.
//
// What this design does about that (a right kernel first; wgmma, TMA and
// warp specialisation are later work):
// * one block per (query tile of 64 rows, head, batch); the loop over key
//   tiles runs inside the block, from the first tile any row's window
//   reaches to the diagonal, so tiles wholly in the causal future or
//   wholly before every row's window are never touched.  Blocks are issued
//   longest first (the last query tile has the most key tiles);
// * the (B, S, H, hd) layout is read through its batch and sequence
//   strides (head stride hd): no transposes;
// * K and V tiles of 64 keys are staged in shared memory, zero-filled past S;
// * bf16: 4 warps of 16 query rows each; q . k^T and p . v run on the tensor
//   cores through mma.sync.m16n8k16 (bf16 in, fp32 accumulate, written
//   here as PTX).  Q stays in registers as A fragments for the whole loop;
//   the score accumulator's layout is the A layout of the p . v product,
//   so p goes from registers to the tensor cores without shared memory;
// * fp32: 256 threads on a 16 x 16 grid, each 4 rows x 4 keys of the score
//   tile and 4 rows x hd/16 columns of the output, plain IEEE FMA (the
//   tensor cores have no fp32 mode), Q, K, V and p in dynamic shared
//   memory (115 KB at hd 128).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so flash_attention.cu
// The C interface below is loaded with ctypes (kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, G;  // G = H / KV
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // batch, seq strides (elements)
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ bool keep(int qp, int kp, const Args& a) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// The key tiles [lo, hi] that query rows [q0, q0 + BQ) reach.
__device__ __forceinline__ void key_tiles(int q0, const Args& a, int& lo, int& hi) {
  int last = a.S - 1;
  if (a.causal) last = min(last, q0 + BQ - 1);
  hi = last / BK;
  lo = 0;
  if (a.window > 0) {
    const int first = q0 - a.window + 1;  // the first key row q0's window keeps
    lo = first > 0 ? first / BK : 0;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bf16_kernel(Args a) {
  constexpr int LD = HD + 8;  // padded smem row: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + (long long)h * HD;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + (long long)kvh * HD;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + (long long)kvh * HD;

  // Q as A fragments (rows r0 / r1, 16 columns a k-step), zero past S
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < a.S ? *reinterpret_cast<const uint32_t*>(qb + r0 * a.q_ss + c) : 0u;
    qa[kk][1] = r1 < a.S ? *reinterpret_cast<const uint32_t*>(qb + r1 * a.q_ss + c) : 0u;
    qa[kk][2] = r0 < a.S ? *reinterpret_cast<const uint32_t*>(qb + r0 * a.q_ss + c + 8) : 0u;
    qa[kk][3] = r1 < a.S ? *reinterpret_cast<const uint32_t*>(qb + r1 * a.q_ss + c + 8) : 0u;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  int lo, hi;
  key_tiles(q0, a, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    // stage K and V: 16 bytes (8 values) a thread a step, zeros past S
    for (int c = threadIdx.x; c < BK * (HD / 8); c += MMA_THREADS) {
      const int row = c / (HD / 8);
      const int col = (c % (HD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < a.S) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + row) * a.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + row) * a.v_ss + col);
      }
      *reinterpret_cast<uint4*>(Ks + row * LD + col) = kv;
      *reinterpret_cast<uint4*>(Vs + row * LD + col) = vv;
    }
    __syncthreads();

    // s = q . k^T: 8 score fragments of 16 rows x 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const __nv_bfloat16* krow = Ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }

    // scale, mask, row max (rows r0: elements 0-1, r1: elements 2-3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? r0 : r1;
        const float x = s[n][e] * a.scale;
        s[n][e] = keep(qp, kp, a) ? x : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row group
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // acc = acc * alpha + bf16(p) . v; the score fragments of keys
    // 16j..16j+15 are the A fragment of k-step j
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* v0 = Vs + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vc = v0 + n * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[LD]);
        const uint32_t b1 = pack_bf16(vc[8 * LD], vc[9 * LD]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // out = acc / max(l, 1e-20) in bf16, rows past S not written
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (long long)h * HD;
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < a.S)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.o_ss + c) = pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < a.S)
      *reinterpret_cast<uint32_t*>(ob + r1 * a.o_ss + c) = pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMA
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;  // 16 x 16: 4 rows x 4 keys each

template <int HD>
constexpr int fma_smem_bytes() {
  // Q and K rows padded by one (conflict-free column reads), V, p
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) * 4;
}

template <int HD>
__global__ void __launch_bounds__(FMA_THREADS)
flash_fp32_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);     // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);     // [BK][HD]
  float* Ps = Vs + BK * HD;           // [BQ][BK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15;  // key / output column lane
  const int ty = threadIdx.x >> 4;  // row lane: rows ty + 16 i

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * HD;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + (long long)kvh * HD;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + (long long)kvh * HD;

  for (int e = threadIdx.x; e < BQ * HD; e += FMA_THREADS) {
    const int r = e / HD, c = e % HD;
    Qs[r * (HD + 1) + c] = q0 + r < a.S ? qb[(q0 + r) * a.q_ss + c] : 0.0f;
  }

  float acc[4][HD / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.0f;
  }

  int lo, hi;
  key_tiles(q0, a, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged; the previous tile's readers are done
    for (int e = threadIdx.x; e < BK * HD; e += FMA_THREADS) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < a.S;
      Ks[r * (HD + 1) + c] = in ? kb[(k0 + r) * a.k_ss + c] : 0.0f;
      Vs[r * HD + c] = in ? vb[(k0 + r) * a.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * a.scale;
        s[i][j] = keep(qp, k0 + tx + 16 * j, a) ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 threads of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        sum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;  // fp32 p: v's type
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }
    __syncthreads();

    float pv[4][HD / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) pv[i][j] = 0.0f;
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[HD / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) vv[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) pv[i][j] = fmaf(p[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

  float* ob = static_cast<float*>(a.o) + b * a.o_sb + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.S) continue;
    const float d = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) ob[r * a.o_ss + tx + 16 * j] = acc[i][j] / d;
  }
}

template <int HD>
cudaError_t launch_hd(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  if (is_bf16) {
    flash_bf16_kernel<HD><<<grid, MMA_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr int smem = fma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fp32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fp32_kernel<HD><<<grid, FMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k / v (B, S, KV, hd), o like q; element strides of the
// batch and sequence dims (the head stride is hd, the last dim contiguous);
// bf16 pointers 16-byte aligned.  window <= 0: no window.  hd in {16, 32,
// 64, 128}.  Returns the launch's cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
                           int B, int S, int H, int KV, int hd, long long q_sb, long long q_ss,
                           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                           long long o_sb, long long o_ss, int causal, int window, float scale,
                           void* stream) {
  Args a{q, k, v, o, S, H, H / KV, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
         causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(a, B, is_bf16, st);
    case 32: return launch_hd<32>(a, B, is_bf16, st);
    case 64: return launch_hd<64>(a, B, is_bf16, st);
    case 128: return launch_hd<128>(a, B, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
