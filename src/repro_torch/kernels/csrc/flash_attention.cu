// Causal GQA flash attention with an online softmax and an optional sliding
// window: the prefill attention of the dense backbone.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py.  Inputs q (B, S, H, hd) and k, v
// (B, S, KV, hd), all bf16 or all fp32, hd a multiple of 8 in [8, 256];
// query head h reads KV head h / (H / KV).  For each query row, over key
// tiles in order:
//
//   s     = (q . k^T in fp32) * hd^-0.5          (scale on the fp32 scores)
//   s     = -1e30 outside  k <= q  (causal)  and  k > q - W  (window W)
//   m'    = max(m, rowmax s);  alpha = exp(m - m');  p = exp(s - m')
//   l     = l * alpha + sum p                      (p unrounded, fp32)
//   acc   = acc * alpha + (p rounded to v's type) . v   (fp32 accumulation)
//   out   = acc / max(l, 1e-20), rounded to q's type
//
// exactly as the Pallas kernel orders it.  A row whose first tiles are all
// masked sums exp(0) = 1 per entry until its first valid tile drives alpha
// to exp(-1e30 - m') = 0; every row reaches its diagonal, so the result is
// right, and nothing here may shortcut that update.  Keys at or past S are
// masked too, so any S >= 1 works.  Given a non-null `lse`, the kernel also
// writes each row's log-sum-exp m + log l in fp32 (B, H, S): l is the row
// sum of the unrounded p, so a check of lse sees the order of p's two
// roundings.
//
// What bounds it on an H100 SXM.  Operations: 4 * B * H * hd FLOPs per
// (query, key) pair the mask keeps, S(S+1)/2 pairs causal; at the serving
// shape (8, 2048, 28 heads, 4 KV heads, hd 128) 2.4e11 FLOPs, 0.243 ms at
// the 989 TFLOP/s of the bf16 tensor cores, against 0.03 ms for the bytes
// (q, k, v, o once at 3.35 TB/s).  In fp32 the bound is the 67 TFLOP/s of
// the FMA units.
//
// bf16: FlashAttention-3's shape, for the full tensor-core rate.
// * Persistent: one block an SM walks work items of (128-row query tile,
//   head, batch), longest first (query tiles counted down), dealt to the
//   blocks in rounds, every other round in reverse, so that each block's
//   long and short items even out.  Within an item the loop over key tiles
//   runs from the first tile any row's window reaches to the diagonal:
//   tiles wholly in the causal future or wholly before every row's window
//   are never touched.
// * 384 threads, warp-specialized.  Warpgroups 0 and 1 consume, 64 query
//   rows each, with `setmaxnreg` raised to 232; warpgroup 2 produces, with
//   `setmaxnreg` lowered to 40, and one thread of it issues every copy.
// * The producer loads each item's Q tile (two Q buffers below hd 256, so
//   the next item's Q lands during this one), and keeps a ring of two K/V
//   stages in flight with TMA (`cp.async.bulk.tensor`) across items, each
//   completing on an `mbarrier` (K and V apart, so q . k^T starts before V
//   lands).  The consumers free K and V apart through two more `mbarrier`s,
//   K as soon as q . k^T has read it: the next K is then in flight a whole
//   tile ahead.  The tensor maps are encoded on the host per launch over
//   the (B, S, H, hd) layout through the caller's strides (no transposes;
//   the GQA head is a box coordinate), with 128-byte swizzle: a row of 64
//   bf16 is one box row, so a 128-wide tile is two boxes side by side.  TMA
//   fills rows at or past S and columns at or past hd with zeros, so any hd
//   runs on the next wider instance (64, 128, 256): zero columns add
//   nothing to the scores.
// * Key tiles of 128 (64 at hd 256, for registers and shared memory): 192
//   KB of shared memory at hd 128 and at hd 256.
// * s = q . k^T by `wgmma` with both operands in shared memory (SS), fp32
//   accumulators; the online softmax in registers in the log2 domain
//   (log2 e folded into the scale, one FFMA and `ex2.approx` a score, ~2^-22
//   relative, far inside bf16's rounding), row maxima across the four
//   threads of a row by shuffles, masks only on tiles that cross the
//   diagonal, the window's edge or S (a separate instance: a mask test on
//   every score would double the softmax).  l is summed from the unrounded
//   fp32 p; only then is p packed to bf16 as the register A operand of o +=
//   p . v by `wgmma` RS (a 16-bit `wgmma`'s fp32 accumulator layout is its
//   A layout).  V is read as an MN-major B operand through the descriptor's
//   transpose bit.
// * In flight: tile j's q . k^T is issued before tile j-1's p . v, and the
//   softmax of tile j runs while that p . v does.  The two warpgroups take
//   turns at the tensor cores (two named barriers, "ping-pong"): one issues
//   its products while the other runs its softmax.  The softmax (the
//   exponentials and the fp32 pipe) takes about as long as the products,
//   and the two overlap only in part: that, not the tensor cores' rate,
//   is what holds the loop back.
// * Epilogue: o / max(l, 1e-20) (times its IEEE reciprocal) in bf16 into
//   the warpgroup's Q tile (read by then), swizzled as TMA reads it, and
//   one TMA store that clips rows at or past S and columns at or past hd.
//
// fp32: 256 threads on a 16 x 16 grid, each 4 rows x 4 keys of a 64 x 64
// score tile and 4 rows x hd/16 columns of the output, plain IEEE FMA and
// the accurate expf (the tensor cores have no fp32 mode), Q, K, V and p in
// dynamic shared memory (115 KB at hd 128, 209 KB at hd 256); acc is scaled
// by alpha, then p . v accumulates into it FMA by FMA.  Widths below an
// instance are zero-filled on load and clipped on store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so flash_attention.cu
// The tensor-map encoder is the driver's, reached through
// cudaGetDriverEntryPoint, so nothing links libcuda.  The C interface below
// is loaded with ctypes (kernels/flash_attention.py).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) or null
  int S, H, G, hd, B;  // G = H / KV
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
template <int BQ, int BK>
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma, written as PTX
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;            // query rows of one consumer warpgroup
constexpr int BQ16 = 2 * WG_ROWS;      // query rows of a block
constexpr int THREADS16 = 3 * 128;     // two consumer warpgroups, one producer
constexpr int STAGES = 2;              // K/V ring
constexpr int ROW_BYTES = 128;         // a swizzled box row: 64 bf16

template <int HDP>
struct Tile {
  static constexpr int BK = HDP > 128 ? 64 : 128;
  static constexpr int PANELS = HDP / 64;  // 64-column boxes across a row
  static constexpr int Q_WG_BYTES = PANELS * WG_ROWS * ROW_BYTES;
  static constexpr int KV_BYTES = PANELS * BK * ROW_BYTES;  // one K or V stage
  // Q tiles in flight: with two, the next work item's Q lands during this
  // one (no room at hd 256)
  static constexpr int Q_BUFS = HDP > 128 ? 1 : 2;
  static constexpr int K_OFF = Q_BUFS * 2 * Q_WG_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;  // 12 mbarriers; slack to align to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile (8-row
// groups 1024 bytes apart).  K-major: lbo unused; MN-major: lbo is the
// stride between 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an in-flight wgmma reads or writes: pinned here, so that the
// compiler neither reads them early nor reuses them before the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma m64nNk16, bf16 in, fp32 accumulate.  ss: A and B from shared
// memory, both K-major; rs: A from registers, B MN-major (transposed).
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// s = q . k^T over the warpgroup's 64 rows and one key stage.
template <int HDP>
__device__ __forceinline__ void score_tile(float (&s)[Tile<HDP>::BK / 2], uint32_t q_wg,
                                           uint32_t k_stage) {
  constexpr int BK = Tile<HDP>::BK;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 bf16 inside a 128-byte row
    const uint64_t da = sw128_desc(q_wg + (kk >> 2) * WG_ROWS * ROW_BYTES + col, 16, 1024);
    const uint64_t db = sw128_desc(k_stage + (kk >> 2) * BK * ROW_BYTES + col, 16, 1024);
    wgmma_ss(s, da, db, kk > 0);
  }
  wg_commit();
}

// o += p . v over one key stage, p as register A fragments.
template <int HDP>
__device__ __forceinline__ void value_tile(float (&o)[HDP / 2],
                                           const uint32_t (&p)[Tile<HDP>::BK / 16][4],
                                           uint32_t v_stage) {
  constexpr int BK = Tile<HDP>::BK;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // 16 keys are 16 rows down; the next 64 value columns are the next box
    const uint64_t db = sw128_desc(v_stage + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
    wgmma_rs(o, p[kk], db, 1);
  }
  wg_commit();
}

// The online-softmax step on one score tile: s becomes p (fp32), m the
// running max of the unscaled scores, l the thread's share of the running
// sum; returns the rows' alpha.  p = 2^((s - m) * c) with c = scale * log2 e
// is exp(scale * s - scale * m).  Element i of the accumulator is row g + 8 *
// ((i >> 1) & 1) of the warp's 16, key 8 * (i >> 2) + 2t + (i & 1).  MASK:
// the tile crosses S, the diagonal or the window's edge.  Without it every
// score and the running max are finite, and (s - m) * c is one FFMA.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0, int r0, int t,
                                             const Args& a, float c, float& m0, float& m1,
                                             float& l0, float& l1, float& al0, float& al1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (MASK && !keep(i & 2 ? r0 + 8 : r0, k0 + (i >> 2) * 8 + 2 * t + (i & 1), a))
      s[i] = NEG_INF;
    if (i & 2)
      mx1 = fmaxf(mx1, s[i]);
    else
      mx0 = fmaxf(mx0, s[i]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2((m0 - mn0) * c);  // 1 while a row has seen only masked keys, 0 after
  al1 = ex2((m1 - mn1) * c);
  const float mc0 = -mn0 * c, mc1 = -mn1 * c;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    // masked: exp(0) = 1 for a row that has seen only masked keys
    const float mn = i & 2 ? mn1 : mn0;
    s[i] = ex2(MASK ? (s[i] - mn) * c : fmaf(s[i], c, i & 2 ? mc1 : mc0));
    if (i & 2)
      sum1 += s[i];
    else
      sum0 += s[i];
  }
  l0 = l0 * al0 + sum0;  // the 4 threads' shares are added at the end
  l1 = l1 * al1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// p to bf16 A fragments: the score fragments of keys 16j..16j+15 are the A
// fragment of k-step j.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    p[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    p[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    p[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    p[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// Work item w of a launch: query tile, head, batch; longest first (the
// query tiles counted down, every head and batch of one before the next).
struct Work {
  int q0, h, b;
};

// The j-th work item of this block: the items dealt in rounds of one a
// block, every other round in reverse, so that each block's share of long
// and short items evens out.
__device__ __forceinline__ int work_index(int j) {
  return j * gridDim.x + (j & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

__device__ __forceinline__ Work work_item(int w, const Args& a) {
  const int n_qt = (a.S + BQ16 - 1) / BQ16, hb = a.H * a.B;
  const int r = w % hb;
  return {(n_qt - 1 - w / hb) * BQ16, r % a.H, r / a.H};
}

template <int HDP>
__global__ void __launch_bounds__(THREADS16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap, const Args a) {
  using T = Tile<HDP>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + T::K_OFF, v_s = base + T::V_OFF;
  // per Q buffer: landed, stored from (the output is staged in it); per
  // K/V stage: K and V landed, K and V read (freed apart: K after q . k^T,
  // V after p . v)
  const uint32_t q_full = base + T::BAR_OFF, q_free = q_full + 8 * T::Q_BUFS;
  const uint32_t k_full = q_free + 8 * T::Q_BUFS, v_full = k_full + 8 * STAGES;
  const uint32_t k_free = v_full + 8 * STAGES, v_free = k_free + 8 * STAGES;
  const int n_work = ((a.S + BQ16 - 1) / BQ16) * a.H * a.B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::Q_BUFS; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_free + 8 * i, 2);  // one arrival from each consumer warpgroup
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_free + 8 * i, 8);  // one arrival from each consumer warp
      mbar_init(v_free + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int it = 0;  // K/V tiles loaded so far, over all work items
      for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
        const Work x = work_item(w, a);
        const int kvh = x.h / a.G;
        int lo, hi;
        key_tiles<BQ16, BK>(x.q0, a, lo, hi);
        const int qb = j % T::Q_BUFS;
        mbar_wait(q_free + 8 * qb, ((j / T::Q_BUFS) & 1) ^ 1);  // the first use passes
        mbar_expect_tx(q_full + 8 * qb, 2 * T::Q_WG_BYTES);
        for (int wg = 0; wg < 2; ++wg)
          for (int p = 0; p < T::PANELS; ++p)
            tma_load(q_s + (2 * qb + wg) * T::Q_WG_BYTES + p * WG_ROWS * ROW_BYTES, &qmap, p * 64,
                     x.h, x.q0 + wg * WG_ROWS, x.b, q_full + 8 * qb);
        for (int kt = lo; kt <= hi; ++kt, ++it) {
          const int st = it % STAGES;
          const uint32_t free_parity = ((it / STAGES) & 1) ^ 1;  // the first round passes
          mbar_wait(k_free + 8 * st, free_parity);
          mbar_expect_tx(k_full + 8 * st, T::KV_BYTES);
          for (int p = 0; p < T::PANELS; ++p)
            tma_load(k_s + st * T::KV_BYTES + p * BK * ROW_BYTES, &kmap, p * 64, kvh, kt * BK,
                     x.b, k_full + 8 * st);
          mbar_wait(v_free + 8 * st, free_parity);
          mbar_expect_tx(v_full + 8 * st, T::KV_BYTES);
          for (int p = 0; p < T::PANELS; ++p)
            tma_load(v_s + st * T::KV_BYTES + p * BK * ROW_BYTES, &vmap, p * 64, kvh, kt * BK,
                     x.b, v_full + 8 * st);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int rw = (warp & 3) * 16 + g;  // this thread's first row in the warpgroup's 64
    const float c = a.scale * LOG2E;
    float o[HDP / 2];
    float s[BK / 2];
    uint32_t p[BK / 16][4];
    float m0, m1, l0, l1, al0, al1;

    // turns at the tensor cores: warpgroup w issues after bar.sync 1 + w,
    // then lets the other one go (bar.arrive 2 - w); warpgroup 0 first
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    int it = 0;  // K/V tiles consumed so far, over all work items
    for (int j = 0, w = work_index(0); w < n_work; w = work_index(++j)) {
      const Work x = work_item(w, a);
      const int qw = x.q0 + wg * WG_ROWS;
      const int r0 = qw + rw;  // this thread's two query rows: r0, r0 + 8
      int lo, hi;
      key_tiles<BQ16, BK>(x.q0, a, lo, hi);
      const int n_tiles = hi - lo + 1;
      const int qb = j % T::Q_BUFS;
      const uint32_t q_wg = q_s + (2 * qb + wg) * T::Q_WG_BYTES;
      // masks only where a tile crosses S, the diagonal or the window's edge
      auto softmax = [&](int k0) {
        if (k0 + BK > a.S || (a.causal && k0 + BK - 1 > qw) ||
            (a.window > 0 && k0 <= qw + WG_ROWS - 1 - a.window))
          softmax_tile<BK, true>(s, k0, r0, t, a, c, m0, m1, l0, l1, al0, al1);
        else
          softmax_tile<BK, false>(s, k0, r0, t, a, c, m0, m1, l0, l1, al0, al1);
      };
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.0f;

      mbar_wait(q_full + 8 * qb, (j / T::Q_BUFS) & 1);
      mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
      score_tile<HDP>(s, q_wg, k_s + (it % STAGES) * T::KV_BYTES);
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
      wg_wait<0>();
      pin(s);
      if (lane == 0) mbar_arrive(k_free + 8 * (it % STAGES));
      softmax(lo * BK);
      pack_p<BK>(p, s);
      for (int i = 1; i < n_tiles; ++i) {
        const int cur = it + i, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(k_full + 8 * st, (cur / STAGES) & 1);
        mbar_wait(v_full + 8 * prev, ((cur - 1) / STAGES) & 1);
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
        score_tile<HDP>(s, q_wg, k_s + st * T::KV_BYTES);
        value_tile<HDP>(o, p, v_s + prev * T::KV_BYTES);
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
        wg_wait<1>();  // this tile's scores are in; the previous p . v runs on
        pin(s);
        if (lane == 0) mbar_arrive(k_free + 8 * st);
        softmax((lo + i) * BK);
        wg_wait<0>();
        pin(o);
        pin(p);
        if (lane == 0) mbar_arrive(v_free + 8 * prev);
#pragma unroll
        for (int jj = 0; jj < HDP / 2; ++jj) o[jj] *= jj & 2 ? al1 : al0;
        pack_p<BK>(p, s);
      }
      const int last = it + n_tiles - 1;
      mbar_wait(v_full + 8 * (last % STAGES), (last / STAGES) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
      value_tile<HDP>(o, p, v_s + (last % STAGES) * T::KV_BYTES);
      // no turn after the block's last product
      if (wg == 0 || work_index(j + 1) < n_work)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
      wg_wait<0>();
      pin(o);
      pin(p);
      if (lane == 0) mbar_arrive(v_free + 8 * (last % STAGES));
      it += n_tiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // out = o / max(l, 1e-20) (times its IEEE reciprocal) in bf16 into
      // this warpgroup's Q tile (its last read is done), swizzled as TMA
      // stores it: 16-byte chunk c of row r of a box sits at chunk c ^ (r & 7)
      const float d0 = 1.0f / fmaxf(l0, 1e-20f), d1 = 1.0f / fmaxf(l1, 1e-20f);
#pragma unroll
      for (int nb = 0; nb < HDP / 8; ++nb) {
        const uint32_t at = q_wg + (nb >> 3) * WG_ROWS * ROW_BYTES + rw * ROW_BYTES +
                            (((nb & 7) ^ (rw & 7)) << 4) + t * 4;
        const uint32_t lo_row = pack_bf16(o[4 * nb] * d0, o[4 * nb + 1] * d0);
        const uint32_t hi_row = pack_bf16(o[4 * nb + 2] * d1, o[4 * nb + 3] * d1);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(lo_row) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * ROW_BYTES), "r"(hi_row)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");    // this warpgroup only
      if ((threadIdx.x & 127) == 0) {
        if (qw < a.S) {
          for (int pn = 0; pn < T::PANELS; ++pn)
            tma_store(&omap, q_wg + pn * WG_ROWS * ROW_BYTES, pn * 64, x.h, qw, x.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(q_free + 8 * qb);  // the producer may load the next Q here
      }
      if (a.lse != nullptr && t == 0) {
        float* row = a.lse + (static_cast<long long>(x.b) * a.H + x.h) * a.S;
        if (r0 < a.S) row[r0] = (m0 * c + log2f(l0)) * LN2;
        if (r0 + 8 < a.S) row[r0 + 8] = (m1 * c + log2f(l1)) * LN2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMA
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;           // query rows per block
constexpr int BK32 = 64;           // keys per tile
constexpr int FMA_THREADS = 256;  // 16 x 16: 4 rows x 4 keys each

template <int HDP>
constexpr int fma_smem_bytes() {
  // Q and K rows padded by one (conflict-free column reads), V, p
  return (BQ32 * (HDP + 1) + BK32 * (HDP + 1) + BK32 * HDP + BQ32 * (BK32 + 1)) * 4;
}

template <int HDP>
__global__ void __launch_bounds__(FMA_THREADS)
flash_fp32_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ32][HDP + 1]
  float* Ks = Qs + BQ32 * (HDP + 1);    // [BK32][HDP + 1]
  float* Vs = Ks + BK32 * (HDP + 1);    // [BK32][HDP]
  float* Ps = Vs + BK32 * HDP;          // [BQ32][BK32 + 1]

  const int qt = gridDim.z - 1 - blockIdx.z;  // longest blocks first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / a.G;
  const int q0 = qt * BQ32;
  const int hd = a.hd;
  const int tx = threadIdx.x & 15;  // key / output column lane
  const int ty = threadIdx.x >> 4;  // row lane: rows ty + 16 i

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + (long long)h * hd;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + (long long)kvh * hd;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + (long long)kvh * hd;

  for (int e = threadIdx.x; e < BQ32 * HDP; e += FMA_THREADS) {
    const int r = e / HDP, c = e % HDP;
    Qs[r * (HDP + 1) + c] = q0 + r < a.S && c < hd ? qb[(q0 + r) * a.q_ss + c] : 0.0f;
  }

  float acc[4][HDP / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) acc[i][j] = 0.0f;
  }

  int lo, hi;
  key_tiles<BQ32, BK32>(q0, a, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();  // Q is staged; the previous tile's readers are done
    for (int e = threadIdx.x; e < BK32 * HDP; e += FMA_THREADS) {
      const int r = e / HDP, c = e % HDP;
      const bool in = k0 + r < a.S && c < hd;
      Ks[r * (HDP + 1) + c] = in ? kb[(k0 + r) * a.k_ss + c] : 0.0f;
      Vs[r * HDP + c] = in ? vb[(k0 + r) * a.v_ss + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HDP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HDP + 1) + d];
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
        Ps[(ty + 16 * i) * (BK32 + 1) + tx + 16 * j] = p;  // fp32 p: v's type
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) acc[i][j] *= alpha[i];
    for (int kk = 0; kk < BK32; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK32 + 1) + kk];
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        const float vv = Vs[kk * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  float* ob = static_cast<float*>(a.o) + b * a.o_sb + (long long)h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.S) continue;
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.S + r] = m[i] + logf(l[i]);
    const float d = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) ob[r * a.o_ss + c] = acc[i][j] / d;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, hd) tensor with element strides ss, sb as a 4-D map
// (hd, heads, S, B), boxes of 64 columns x 1 head x `rows` rows, 128-byte
// swizzle, zeros outside.
bool encode(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B, long long ss,
            long long sb, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled not found\n");
    return false;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled returned %d\n", static_cast<int>(r));
    return false;
  }
  return true;
}

template <int HDP>
cudaError_t launch_hd(const Args& a, int B, int KV, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    using T = Tile<HDP>;
    CUtensorMap qm, km, vm, om;
    if (!encode(&qm, a.q, a.hd, a.H, a.S, B, a.q_ss, a.q_sb, WG_ROWS) ||
        !encode(&km, a.k, a.hd, KV, a.S, B, a.k_ss, a.k_sb, T::BK) ||
        !encode(&vm, a.v, a.hd, KV, a.S, B, a.v_ss, a.v_sb, T::BK) ||
        !encode(&om, a.o, a.hd, a.H, a.S, B, a.o_ss, a.o_sb, WG_ROWS))
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<HDP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    const int n_work = (a.S + BQ16 - 1) / BQ16 * a.H * B;  // persistent: one block an SM
    flash_bf16_kernel<HDP><<<n_work < sms ? n_work : sms, THREADS16, T::SMEM, stream>>>(
        qm, km, vm, om, a);
    return cudaGetLastError();
  }
  constexpr int smem = fma_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fp32_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.S + BQ32 - 1) / BQ32);
  flash_fp32_kernel<HDP><<<grid, FMA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k / v (B, S, KV, hd), o like q; element strides of the
// batch and sequence dims (the head stride is hd, the last dim contiguous);
// pointers 16-byte aligned.  window <= 0: no window.  hd a multiple of 8 in
// [8, 256], run on the instance of 64, 128 or 256 columns at or above it.
// lse: null, or fp32 (B, H, S) for each row's log-sum-exp.  Returns the
// launch's cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                           int is_bf16, int B, int S, int H, int KV, int hd, long long q_sb,
                           long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                           long long v_ss, long long o_sb, long long o_ss, int causal, int window,
                           float scale, void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0 || KV < 1 || H % KV != 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, lse, S, H, H / KV, hd, B, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
         causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_hd<64>(a, B, KV, is_bf16, st);
  if (hd <= 128) return launch_hd<128>(a, B, KV, is_bf16, st);
  return launch_hd<256>(a, B, KV, is_bf16, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
