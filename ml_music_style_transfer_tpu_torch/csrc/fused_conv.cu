// Fused Conv1x3 -> InstanceNorm -> LeakyReLU for Hopper (sm_90a), plain C
// interface.
//
// Replaces ml_music_style_transfer_tpu/ops/pallas/fused_conv.py:42 _kernel
// (pallas_call at :117): for channel-last x (B, T, Cin), w (3, Cin, Cout)
// and a float32 bias b (Cout,),
//   y[b, t, n]   = b[n] + sum_{d<3, c<Cin} x[b, t + d - 1, c] * w[d, c, n]
//                  (x is zero outside 0 <= t + d - 1 < T: torch padding=1)
//   out[b, t, n] = LReLU((y - mean_t y) * rsqrt(var_t y + eps)), in x's dtype
// with float32 accumulation and population statistics over T.
//
// Bias. InstanceNorm subtracts each (item, channel)'s mean over T, so b
// cancels exactly; the kernel leaves it out (b is not read) and normalises
// the bias-free conv, which rounds no worse than adding it first.
//
// What bounds it. The function reads x, w once and writes out once; its
// work is 6*B*T*Cin*Cout FLOPs. At the full-width model's shapes (batch 16)
// that is bound by the tensor cores' bfloat16 rate (audio_down_0.conv2,
// 1536 -> 1536 at T = 860: 194.8 GFLOP, 197 us at 989 TFLOP/s; its bytes
// alone take 27 us), except at the narrow 64..256-channel layers, which are
// bound by bytes.
//
// Design. The TPU kernel keeps a whole (T, 128) float32 tile in VMEM for its
// epilogue; at T = 860 that is 440 KB a batch row, more than an SM's 227 KB
// of shared memory. So one C entry point makes two launches. What each part
// does about the four costs of the mma.sync kernel it replaces (mma.sync
// below the tensor cores' rate; every address computed by hand; a float32
// workspace written once and read three times; two launches whose fixed
// costs dominate the narrow shapes) is marked [1]..[4]:
//   (a) conv as a GEMM, rows cut into boxes of 64 time rows of one batch
//       item, (item, t0) with t0 a multiple of 64; N = Cout, K = 3 * Cin
//       ordered (tap, channel). bfloat16 (`conv_gemm_wgmma_kernel`):
//       - [2] TMA feeds the tiles. x is a 3-D tensor map (Cin, T, B); the A
//         box of tap d is the 64 x 64 tile at (c0, t0 + d - 1, item), and
//         the hardware zero-fills coordinates outside [0, T) (t = -1
//         included) and past Cin: that fill is the conv's zero halo and each
//         item's ragged end, with no index arithmetic and no padded copy of
//         x. w is a 3-D map (Cout, Cin, 3), so a K tile past Cin is zero in
//         w as well as in x. Both land 128-byte swizzled; x K-major, w
//         N-major (wgmma's transposed B), so w is used as it is stored.
//       - [1] wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulate): one
//         consumer warpgroup per 64-row box, two per CTA (M = 128; the two
//         boxes may belong to two items); K tiles of 64 channels (one
//         swizzle row) in a ring of stages filled by one producer thread and
//         released through mbarriers; a consumer keeps one group of wgmmas
//         in flight while it waits for the next tile. 384 threads: 2
//         consumer warpgroups (setmaxnreg 232) and a producer warpgroup
//         (setmaxnreg 40), 168 registers a thread at launch; one CTA per SM.
//         BN, the tile's output channels, and its ring:
//             BN = 256: 4 stages of 48 KB, 203 KB of shared memory
//             BN = 192: 5 stages of 40 KB, 209 KB
//             BN = 128: 6 stages of 32 KB, 198 KB
//         `tile_n` picks BN from the grid's waves on the card's SMs (128 when
//         Cout <= 128); the grid is ceil(B * ceil(T / 64) / 2) x
//         ceil(Cout / BN) CTAs, walked in groups of M tiles by every N tile
//         so that the CTAs resident together share x rows and w columns in
//         L2. Rows wasted to ragged boxes: ~4 % at T = 430 and 860, 10-17 %
//         at T = 53..215.
//       - [3] The epilogue reduces each box's valid rows (t < T) in registers
//         to partial statistics per column, a box mean and M2 = sum (y - box
//         mean)^2 (two passes over registers, so no sum / sum-of-squares
//         cancellation when |mean| >> std), by warp shuffles and a shared
//         memory sum over the warpgroup's four warps. It writes them to a
//         small float32 buffer (B * ceil(T / 64), Cout, 2) and y once to the
//         float32 workspace (B * T, Cout). y stays float32: the output's
//         tolerance is one bf16 rounding, and a bf16 y would round twice.
//       float32 (`conv_gemm_f32_kernel`): FFMA (no TF32) over the same boxes
//       (64 rows x 64 columns, a 4x4 micro-tile per thread, index-arithmetic
//       halo), with the same partials, so one normalisation serves both.
//   (b) `instnorm_lrelu_kernel`: per (item, channel), Chan's parallel merge
//       of the box partials (n = na + nb, delta = mean_b - mean_a,
//       M2 = M2a + M2b + delta^2 na nb / n), then [3] ONE read of y,
//       normalise, LeakyReLU, write in x's dtype, coalesced along C. A
//       channel constant over T has var 0 and gives 0 (eps > 0), not NaN.
//   Workspace traffic falls from a write and three reads of B*T*Cout floats
//   to a write and one read. [4] Both bf16 launches are programmatic
//   dependent launches: each may start while the kernel before it in the
//   stream finishes, and waits for it before touching global memory, so a
//   launch's fixed cost overlaps the previous kernel's tail.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Shape {
  int batch;
  int t_len;  // T
  int cin;    // x's row length, and the channel count the GEMM sums over
  int cout;   // real output channels
  int ldw;    // row length of w (>= cout)
  int ldy;    // row length of the workspace and the partials: cout rounded up to 8
  int nbox;   // 64-row boxes per item: ceil(T / 64)
  int group;  // bf16 GEMM: M tiles per group of the grid's raster (see the kernel)
};

constexpr int kBox = 64;  // time rows of one item per box

// ---- (a) bfloat16: TMA + wgmma GEMM -------------------------------------------

constexpr int kBK = 64;                        // channels per K tile: 128 B, one swizzle row
constexpr int kConsumers = 2;                  // consumer warpgroups = boxes per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABox = kBox * kBK * 2;          // 8 KB: one box's K tile
constexpr int kAStage = kConsumers * kABox;    // 16 KB
constexpr int kWChunk = kBK * 64 * 2;          // 8 KB: 64 K rows x 64 output channels

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 256 ? 4 : (BN == 192 ? 5 : 6);
  static constexpr int kStage = kAStage + BN * kBK * 2;  // A boxes, then BN / 64 w chunks
  static constexpr int kRed = 5 * BN;                    // floats per consumer: 4 warp rows + means
  static constexpr int kSmem =
      1024 + kStages * kStage + 2 * kStages * 8 + kConsumers * kRed * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch: a kernel launched with it may start while
// the previous kernel in the stream runs; it waits here for that kernel's
// completion (and memory) before touching global memory, and lets the next
// kernel start early once it has reached `grid_dependents_launch`. Both are
// no-ops for a kernel launched without it.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// wait until the phase of parity `parity` has completed; a pipeline that
// never completes traps (a launch error the wrapper raises), not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// one 3-D box global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, K-major) * B (16 x N, N-major), both bf16;
// scale-d is the predicate p = (1 != 0): accumulate
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) {
    wgmma_n256(d, a, b);
  } else if constexpr (BN == 192) {
    wgmma_n192(d, a, b);
  } else {
    wgmma_n128(d, a, b);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, float* __restrict__ y,
                       float2* __restrict__ part, Shape s) {
  using TL = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that boundary
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + TL::kStages * TL::kStage;  // full[kStages], empty[kStages]
  float* red_all = reinterpret_cast<float*>(smem_raw + (bars - raw) + 2 * TL::kStages * 8);

  const int wg = threadIdx.x / 128;  // 0 .. kConsumers-1: consumers; kConsumers: producer
  const int nct = (s.cin + kBK - 1) / kBK;  // K tiles per tap
  const int kt_total = 3 * nct;
  const int nboxes = s.batch * s.nbox;
  // the 1-D grid walks groups of s.group M tiles by every N tile, M first,
  // so that the CTAs resident together share their x rows and w columns in L2
  const int mt = (nboxes + kConsumers - 1) / kConsumers, nt = (s.ldy + BN - 1) / BN;
  const int gi = blockIdx.x / (s.group * nt), gr = blockIdx.x - gi * s.group * nt;
  const int gm = min(s.group, mt - gi * s.group);
  const int m_tile = gi * s.group + gr % gm;
  const int n0 = gr / gm * BN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < TL::kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (TL::kStages + st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dependency_wait();
  grid_dependents_launch();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      int item[kConsumers], t0[kConsumers];
#pragma unroll
      for (int i = 0; i < kConsumers; ++i) {
        int g = m_tile * kConsumers + i;
        if (g >= nboxes) g = m_tile * kConsumers;  // no such box: reload the first, never stored
        item[i] = g / s.nbox;
        t0[i] = (g - item[i] * s.nbox) * kBox;
      }
      for (int kt = 0; kt < kt_total; ++kt) {
        const int st = kt % TL::kStages;
        if (kt >= TL::kStages) mbar_wait(bars + 8 * (TL::kStages + st), ((kt / TL::kStages) + 1) & 1);
        const uint32_t full = bars + 8 * st;
        const uint32_t sa = base + st * TL::kStage, sb = sa + kAStage;
        mbar_expect_tx(full, TL::kStage);
        const int d = kt / nct, c0 = (kt - d * nct) * kBK;
#pragma unroll
        for (int i = 0; i < kConsumers; ++i) {
          tma_load_3d(sa + i * kABox, &xmap, full, c0, t0[i] + d - 1, item[i]);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load_3d(sb + j * kWChunk, &wmap, full, n0 + 64 * j, c0, d);
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: box m_tile * kConsumers + wg -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < kt_total; ++kt) {
      const int st = kt % TL::kStages;
      mbar_wait(bars + 8 * st, (kt / TL::kStages) & 1);
      const uint32_t sa = base + st * TL::kStage + wg * kABox;
      const uint32_t sb = base + st * TL::kStage + kAStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: K-major, 8-row groups 1024 B apart, k16 slices 32 B apart;
        // B: N-major, 64-column chunks 8 KB apart (LBO), 8-row K groups
        //    1024 B apart (SBO), k16 slices 2048 B apart
        wgmma<BN>(acc, smem_desc(sa + 32 * kk, 16, 1024), smem_desc(sb + 2048 * kk, kWChunk, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's wgmmas are done: release its stage
      if (kt > 0) mbar_arrive(bars + 8 * (TL::kStages + (kt - 1) % TL::kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int g = m_tile * kConsumers + wg;
    if (g < nboxes) {
      const int item = g / s.nbox, t0 = (g - item * s.nbox) * kBox;
      const int nvalid = min(kBox, s.t_len - t0);
      const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, q = lane % 4;
      // accumulator: rows r0 and r0 + 8, columns 8j + 2q + {0, 1} (j < BN / 8)
      const int r0 = warp * 16 + lane / 4;
      const bool v0 = r0 < nvalid, v1 = r0 + 8 < nvalid;
      float* red = red_all + wg * TL::kRed;  // [4][BN] warp sums
      float* mean_s = red + 4 * BN;          // [BN] box means
      const int bar_id = 1 + wg;

      // pass 1: column sums over the box's valid rows -> box means
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = (v0 ? acc[4 * j + e] : 0.f) + (v1 ? acc[4 * j + 2 + e] : 0.f);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[warp * BN + 8 * j + 2 * q + e] = v;
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      for (int c = tid; c < BN; c += 128) {
        mean_s[c] = (red[c] + red[BN + c] + red[2 * BN + c] + red[3 * BN + c]) / nvalid;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      // pass 2: squared deviations from the box mean -> box M2
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = mean_s[8 * j + 2 * q + e];
          const float d0 = v0 ? acc[4 * j + e] - m : 0.f;
          const float d1 = v1 ? acc[4 * j + 2 + e] - m : 0.f;
          float v = d0 * d0 + d1 * d1;
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[warp * BN + 8 * j + 2 * q + e] = v;
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      float2* pb = part + static_cast<long long>(g) * s.ldy;
      for (int c = tid; c < BN; c += 128) {
        if (n0 + c < s.ldy) {
          pb[n0 + c] = make_float2(mean_s[c], red[c] + red[BN + c] + red[2 * BN + c] + red[3 * BN + c]);
        }
      }

      float* y0 = y + (static_cast<long long>(item) * s.t_len + t0 + r0) * s.ldy + n0 + 2 * q;
      float* y1 = y0 + 8LL * s.ldy;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j + 2 * q < s.ldy) {
          if (v0) *reinterpret_cast<float2*>(y0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
          if (v1) *reinterpret_cast<float2*>(y1 + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

// ---- (a) float32: FFMA GEMM over the same boxes -------------------------------

constexpr int kFBN = 64, kFBK = 16;

__global__ void __launch_bounds__(256)
conv_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, float2* __restrict__ part, Shape s) {
  __shared__ float As[kFBK][kBox + 4];  // k-major: a thread's 4 rows are adjacent
  __shared__ float Bs[kFBK][kFBN + 4];
  __shared__ float red[16][kFBN];
  __shared__ float mean_s[kFBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int g = blockIdx.x;  // box
  const int item = g / s.nbox, t0 = (g - item * s.nbox) * kBox;
  const int nvalid = min(kBox, s.t_len - t0);
  const int n0 = blockIdx.y * kFBN;
  const float* xb = x + static_cast<long long>(item) * s.t_len * s.cin;
  const int b_n = tid & 63, b_k = tid >> 6;  // B loads: k rows b_k + 4i, column b_n

  float acc[4][4] = {};
  for (int d = 0; d < 3; ++d) {
    for (int c0 = 0; c0 < s.cin; c0 += kFBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A loads: rows ty + 16i, channel tx (coalesced along C)
        const int r = ty + 16 * i, t = t0 + r + d - 1, c = c0 + tx;
        As[tx][r] = (t >= 0 && t < s.t_len && c < s.cin) ? xb[static_cast<long long>(t) * s.cin + c]
                                                           : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = b_k + 4 * i, c = c0 + k, n = n0 + b_n;
        Bs[k][b_n] = (c < s.cin && n < s.cout)
                         ? w[(static_cast<long long>(d) * s.cin + c) * s.ldw + n]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // thread: rows ty*4 + i, columns tx*4 + j; box statistics as in the wgmma epilogue
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) v += ty * 4 + i < nvalid ? acc[i][j] : 0.f;
    red[ty][tx * 4 + j] = v;
  }
  __syncthreads();
  if (tid < kFBN) {
    float v = 0.f;
    for (int r = 0; r < 16; ++r) v += red[r][tid];
    mean_s[tid] = v / nvalid;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m = mean_s[tx * 4 + j];
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dv = acc[i][j] - m;
      v += ty * 4 + i < nvalid ? dv * dv : 0.f;
    }
    red[ty][tx * 4 + j] = v;
  }
  __syncthreads();
  if (tid < kFBN && n0 + tid < s.ldy) {
    float v = 0.f;
    for (int r = 0; r < 16; ++r) v += red[r][tid];
    part[static_cast<long long>(g) * s.ldy + n0 + tid] = make_float2(mean_s[tid], v);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nvalid) continue;
    float* yr = y + (static_cast<long long>(item) * s.t_len + t0 + r) * s.ldy;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.ldy) yr[n] = acc[i][j];
    }
  }
}

// ---- (b) merge the box statistics, normalise over T, LeakyReLU ----------------

constexpr int kNormThreads = 256, kNormRows = 128;  // time rows per block

// 4 channels at p, one vector store when `vec` (rows of a multiple of 4
// channels), else the first min(valid, 4) one by one
__device__ __forceinline__ void store4(float* p, float4 v, int valid, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < valid && i < 4; ++i) p[i] = a[i];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int valid, bool vec) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < valid && i < 4; ++i) p[i] = __float2bfloat16_rn(a[i]);
  }
}

// block: 4 * qc channels (qc = min(32, ldy / 4) threads per row, 4 channels
// each) of one item, kNormRows time rows; grid (channel chunks, row chunks, B)
template <typename Out>
__global__ void __launch_bounds__(kNormThreads)
instnorm_lrelu_kernel(const float* __restrict__ y, const float2* __restrict__ part,
                      Out* __restrict__ out, Shape s, float eps, float slope) {
  __shared__ float4 mean_s[32], inv_s[32];
  grid_dependency_wait();
  const int qc = min(32, s.ldy / 4);
  const int rows = kNormThreads / qc;
  const int q = threadIdx.x % qc, r = threadIdx.x / qc;
  const int n = (blockIdx.x * qc + q) * 4;
  const int b = blockIdx.z;
  const bool on = n < s.ldy && r < rows;

  if (r == 0 && on) {
    // Chan's merge of the boxes' (mean, M2), box by box in order, the
    // partials of four boxes loaded at a time
    float cnt = 0.f, mean[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f};
    const float2* pb = part + static_cast<long long>(b) * s.nbox * s.ldy + n;
    for (int k0 = 0; k0 < s.nbox; k0 += 4) {
      float4 lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long k = min(k0 + u, s.nbox - 1);
        lo[u] = *reinterpret_cast<const float4*>(pb + k * s.ldy);
        hi[u] = *reinterpret_cast<const float4*>(pb + k * s.ldy + 2);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k0 + u >= s.nbox) break;
        const float bm[4] = {lo[u].x, lo[u].z, hi[u].x, hi[u].z};
        const float bq[4] = {lo[u].y, lo[u].w, hi[u].y, hi[u].w};
        const float nb = static_cast<float>(min(kBox, s.t_len - (k0 + u) * kBox));
        const float tot = cnt + nb, f = nb / tot, cross = cnt * f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float delta = bm[i] - mean[i];
          mean[i] += delta * f;
          m2[i] += bq[i] + delta * delta * cross;
        }
        cnt = tot;
      }
    }
    const float inv_t = 1.f / static_cast<float>(s.t_len);
    mean_s[q] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    inv_s[q] = make_float4(rsqrtf(m2[0] * inv_t + eps), rsqrtf(m2[1] * inv_t + eps),
                           rsqrtf(m2[2] * inv_t + eps), rsqrtf(m2[3] * inv_t + eps));
  }
  __syncthreads();
  grid_dependents_launch();
  if (!on) return;
  const float4 mu = mean_s[q], inv = inv_s[q];
  const int valid = s.cout - n;
  if (valid <= 0) return;
  const bool vec = s.cout % 4 == 0;
  const int t_end = min(s.t_len, (blockIdx.y + 1) * kNormRows);
  const float* yb = y + static_cast<long long>(b) * s.t_len * s.ldy + n;
  Out* ob = out + static_cast<long long>(b) * s.t_len * s.cout + n;
  // four rows' loads in flight per thread; y is read once (streaming)
  for (int t = blockIdx.y * kNormRows + r; t < t_end; t += 4 * rows) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int tu = t + u * rows;
      v[u] = tu < t_end ? __ldcs(reinterpret_cast<const float4*>(yb + static_cast<long long>(tu) * s.ldy))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int tu = t + u * rows;
      if (tu >= t_end) break;
      float4 z = make_float4((v[u].x - mu.x) * inv.x, (v[u].y - mu.y) * inv.y,
                             (v[u].z - mu.z) * inv.z, (v[u].w - mu.w) * inv.w);
      z.x = z.x >= 0.f ? z.x : slope * z.x;
      z.y = z.y >= 0.f ? z.y : slope * z.y;
      z.z = z.z >= 0.f ? z.z : slope * z.z;
      z.w = z.w >= 0.f ? z.w : slope * z.w;
      store4(ob + static_cast<long long>(tu) * s.cout, z, valid, vec);
    }
  }
}

// ---- host --------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (so the build links no -lcuda)
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a bfloat16 3-D map (d0 innermost), 64 x 64 x 1 boxes, 128-byte swizzle,
// zero fill outside the tensor
CUresult encode_3d(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                   uint64_t d2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// cudaLaunchKernelEx's config for a programmatic dependent launch on `stream`
struct PdlLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  PdlLaunch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The bf16 GEMM's output-tile width: of 256, 192 and 128 the one whose
// waves of CTAs (one per SM) take least time, a tile's time taken as
// proportional to its width plus 256 (its fixed cost: the pipeline's fill,
// the epilogue, and the narrower wgmma's lower rate; measured on an H100:
// 128-wide tiles lost at T = 430 and 860, 192-wide won at T = 53, where the
// 256-wide grid is 1.45 waves); ties go to the wider tile. 128 when
// Cout <= 128.
int tile_n(long long mt, int ldy, int sms) {
  if (ldy <= 128) return 128;
  int best = 256;
  long long best_cost = -1;
  const int widths[3] = {256, 192, 128};
  for (const int bn : widths) {
    const long long tiles = mt * ((ldy + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + 256);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

long long m_tiles(long long batch, int t_len) {
  return (batch * ((t_len + kBox - 1) / kBox) + kConsumers - 1) / kConsumers;
}

cudaError_t sm_count(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, float* ws, float2* part, Shape s, int sms,
                 cudaStream_t stream) {
  EncodeTiledFn fn;
  cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap xmap, wmap;
  CUresult r = encode_3d(fn, &xmap, x, s.cin, s.t_len, s.batch);
  if (r == CUDA_SUCCESS) r = encode_3d(fn, &wmap, w, s.ldw, s.cin, 3);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  using TL = Tile<BN>;
  // above 48 KB of dynamic shared memory only after this opt-in
  e = cudaFuncSetAttribute(conv_gemm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TL::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long mt = m_tiles(s.batch, s.t_len);
  const int nt = (s.ldy + BN - 1) / BN;
  if (mt * nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // a group of M tiles by all N tiles fills about a wave, but no fewer than
  // 16 M tiles share each w tile (fewer lost time at Cout >= 3072 on an H100)
  s.group = sms / nt > 16 ? sms / nt : 16;
  PdlLaunch launch(dim3(static_cast<unsigned>(mt * nt)), kThreads, TL::kSmem, stream);
  e = cudaLaunchKernelEx(&launch.cfg, conv_gemm_wgmma_kernel<BN>, xmap, wmap, ws, part, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// out (B, T, cout) <- LReLU(InstanceNorm_T(conv1x3(x, w) + bias)).
// x (B, T, cin) and w (3, cin, ldw) in dtype (0 = float32, 1 = bfloat16);
// bias (cout,) float32 is not read (InstanceNorm cancels it); ws a float32
// workspace of B*T*ldy + 2*B*ceil(T/64)*ldy, ldy = cout rounded up to 8.
// bfloat16 needs cin and ldw to be multiples of 8 and x, w 16-byte aligned.
// Two launches on `stream`; returns 0 on success, else the first error: a
// cudaError (> 0) or minus a CUresult of cuTensorMapEncodeTiled (< 0).
int conv1x3_instnorm_lrelu(const void* x, const void* w, const float* bias, float* ws, void* out,
                           long long batch, int t_len, int cin, int cout, int ldw, int dtype,
                           float eps, float slope, cudaStream_t stream) {
  (void)bias;
  if (batch <= 0 || t_len <= 0 || cout <= 0) return 0;
  if (cin < 0 || ldw < cout || batch > 0x7fffffffLL || cout > 0x7ffffff0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ldy = (cout + 7) / 8 * 8;
  const Shape s{static_cast<int>(batch), t_len, cin, cout, ldw, ldy, (t_len + kBox - 1) / kBox, 1};
  float2* part = reinterpret_cast<float2*>(ws + batch * t_len * static_cast<long long>(ldy));

  int err;
  if (dtype == 1) {
    if (cin % 8 != 0 || ldw != ldy || !aligned16(x) || !aligned16(w)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int sms;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    switch (tile_n(m_tiles(batch, t_len), ldy, sms)) {
      case 256: err = launch_wgmma<256>(x, w, ws, part, s, sms, stream); break;
      case 192: err = launch_wgmma<192>(x, w, ws, part, s, sms, stream); break;
      default: err = launch_wgmma<128>(x, w, ws, part, s, sms, stream);
    }
  } else if (dtype == 0) {
    const long long nb = batch * s.nbox;
    const int nt = (ldy + kFBN - 1) / kFBN;
    if (nb > 0x7fffffffLL || nt > 65535) return static_cast<int>(cudaErrorInvalidValue);
    conv_gemm_f32_kernel<<<dim3(static_cast<unsigned>(nb), nt), 256, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ws, part, s);
    err = static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;

  const int qc = ldy / 4 < 32 ? ldy / 4 : 32;
  const dim3 ngrid(static_cast<unsigned>((ldy + 4 * qc - 1) / (4 * qc)),
                   static_cast<unsigned>((t_len + kNormRows - 1) / kNormRows),
                   static_cast<unsigned>(batch));
  if (ngrid.y > 65535u || ngrid.z > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  PdlLaunch launch(ngrid, kNormThreads, 0, stream);
  const cudaError_t e =
      dtype == 1 ? cudaLaunchKernelEx(&launch.cfg, instnorm_lrelu_kernel<__nv_bfloat16>,
                                      static_cast<const float*>(ws), static_cast<const float2*>(part),
                                      static_cast<__nv_bfloat16*>(out), s, eps, slope)
                 : cudaLaunchKernelEx(&launch.cfg, instnorm_lrelu_kernel<float>,
                                      static_cast<const float*>(ws), static_cast<const float2*>(part),
                                      static_cast<float*>(out), s, eps, slope);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// CTAs of the GEMM launch that conv1x3_instnorm_lrelu makes for this shape
// on the current device, or minus a cudaError.
long long conv1x3_instnorm_lrelu_ctas(long long batch, int t_len, int cout, int dtype) {
  const int ldy = (cout + 7) / 8 * 8;
  if (dtype != 1) return batch * ((t_len + kBox - 1) / kBox) * ((ldy + kFBN - 1) / kFBN);
  int sms;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  const long long mt = m_tiles(batch, t_len);
  const int bn = tile_n(mt, ldy, sms);
  return mt * ((ldy + bn - 1) / bn);
}

}  // extern "C"
