// Fused Conv1x3 -> InstanceNorm -> LeakyReLU for Hopper (sm_90a), plain C
// interface.
//
// Replaces ml_music_style_transfer_tpu/ops/pallas/fused_conv.py _kernel
// (pallas_call at :117): for channel-last x (B, T, Cin), w (3, Cin, Cout)
// and a float32 bias b (Cout,),
//   y[b, t, n]   = b[n] + sum_{d<3, c<Cin} x[b, t + d - 1, c] * w[d, c, n]
//                  (x is zero outside 0 <= t + d - 1 < T: torch padding=1)
//   out[b, t, n] = LReLU((y - mean_t y) * rsqrt(var_t y + eps)), in x's dtype
// with float32 accumulation and population statistics over T.
//
// Design. The TPU kernel keeps a whole (T, 128) float32 tile in VMEM for its
// normalisation epilogue; at T = 860 that is 440 KB a batch row, more than
// the 227 KB of shared memory an SM has. So the function runs as two
// launches from one entry point:
//   (a) conv as one GEMM over all batch items: M = B*T rows, N = Cout,
//       K = 3*Cin ordered (tap, channel). The three time shifts and the
//       zero halo are index arithmetic on the loads (row m + d - 1, valid
//       while its time index stays inside the same batch item), so there is
//       no padded copy of x; flattening B*T keeps the tiles full at T = 53.
//       The bias is added and y goes to a float32 workspace (B*T, ldw).
//       bfloat16: 128x128x32 block tiles, 8 warps of 64x32, mma.sync
//       m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from padded
//       (conflict-free) shared memory, three cp.async stages; out-of-range
//       chunks are zero-filled by the copy itself. The 16-byte copies need
//       Cin and ldw to be multiples of 8 and x, w 16-byte aligned: the
//       wrapper pads Cin = 1025 (audio_down_0.conv1) and any Cout that is
//       not a multiple of 8 with zeros. float32: 64x64x16 tiles, a 4x4
//       FFMA micro-tile per thread (no TF32), scalar loads, so no padding.
//   (b) InstanceNorm + LeakyReLU: one block per (batch item, 32 channels),
//       coalesced along C, 16 time phases; a two-pass mean and variance over
//       T in float32 (one-pass sum / sum of squares cancels when
//       |mean| >> std), then a third pass writes the result. Passes two and
//       three mostly hit L2. A channel constant over T has var 0 and gives
//       0 (eps > 0), not NaN.
//
// What bounds it. The function itself reads x, w, b once and writes out
// once; its work is 6*B*T*Cin*Cout FLOPs. At the full-width model's
// shapes (batch 16) that is bound by operations on the tensor cores in
// bfloat16 (e.g. audio_down_0.conv2, 1536 -> 1536 at T = 860: 194.8 GFLOP,
// 197 us at 989 TFLOP/s; its bytes alone take 27 us) except at the narrow
// 64..256-channel layers, which are bound by bytes. mma.sync reaches a
// part of the card's rate that only wgmma reaches in full, and the float32
// workspace adds a write and two or three reads of B*T*Cout floats that the
// bound does not count; wgmma, TMA and the statistics fused into (a) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Shape {
  long long rows;  // B * T
  int t_len;       // T
  int cin;         // x's row length, and the channel count the GEMM sums over
  int cout;        // real output channels
  int ldw;         // row length of w and of the workspace (>= cout)
};

// ---- (a) bfloat16 tensor-core GEMM -------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kALd = kBK + 8;  // 80-byte rows: ldmatrix rows fall on distinct banks
constexpr int kBLd = kBN + 8;  // 272-byte rows: the same
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;  // 56,832

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (no bytes are read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kStages * kAStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A copies: rows tid/4 and tid/4 + 64 of the tile, 16-byte chunk tid%4
  const int a_ch = tid & 3;
  long long a_m[2];
  int a_t[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_m[i] = m0 + (tid >> 2) + 64 * i;
    a_in[i] = a_m[i] < s.rows;
    a_t[i] = a_in[i] ? static_cast<int>(a_m[i] % s.t_len) : 0;
  }
  // B copies: k rows tid/16 and tid/16 + 16, 16-byte chunk tid%16
  const int b_ch = tid & 15, b_kr = tid >> 4;
  const int b_n = n0 + b_ch * 8;
  const bool b_nin = b_n < s.ldw;

  const int nct = (s.cin + kBK - 1) / kBK;  // channel tiles per tap
  const int kt_total = 3 * nct;

  auto load_tile = [&](int stage, int kt) {
    const int d = kt / nct;
    const int c0 = (kt - d * nct) * kBK;
    __nv_bfloat16* as = As + stage * kAStage;
    __nv_bfloat16* bs = Bs + stage * kBStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + a_ch * 8;
      const int ts = a_t[i] + d - 1;
      const bool ok = a_in[i] && ts >= 0 && ts < s.t_len && c < s.cin;
      const __nv_bfloat16* src = ok ? x + (a_m[i] + d - 1) * s.cin + c : x;
      cp_async16(as + ((tid >> 2) + 64 * i) * kALd + a_ch * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = b_kr + 16 * i;
      const int c = c0 + kr;
      const bool ok = b_nin && c < s.cin;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<long long>(d) * s.cin + c) * s.ldw + b_n : w;
      cp_async16(bs + kr * kBLd + b_ch * 8, src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < kt_total) load_tile(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < kt_total) load_tile(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % kStages) * kAStage;
    const __nv_bfloat16* bs = Bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + (lane & 15)) * kALd + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * kBLd + wn * 32 + j2 * 16 + (lane >> 4) * 8);
        bf[2 * j2][0] = r[0];
        bf[2 * j2][1] = r[1];
        bf[2 * j2 + 1][0] = r[2];
        bf[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows g and g + 8 of m16 tile i, columns 2q, 2q+1 of n8 tile j
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + j * 8 + 2 * q;
    if (n >= s.cout) continue;
    const float b0 = bias[n];
    const float b1 = n + 1 < s.cout ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m < s.rows) {
          *reinterpret_cast<float2*>(y + m * s.ldw + n) =
              make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
        }
      }
  }
}

// ---- (a) float32 FFMA GEMM -------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

__global__ void __launch_bounds__(256)
conv_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  __shared__ float As[kFBK][kFBM + 4];  // k-major: a thread's 4 rows are adjacent
  __shared__ float Bs[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFBM;
  const int n0 = blockIdx.y * kFBN;

  // A loads: rows ty + 16i, channel tx of the k tile (coalesced along C)
  long long a_m[4];
  int a_t[4];
  bool a_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_m[i] = m0 + ty + 16 * i;
    a_in[i] = a_m[i] < s.rows;
    a_t[i] = a_in[i] ? static_cast<int>(a_m[i] % s.t_len) : 0;
  }
  const int b_n = tid & 63, b_k = tid >> 6;  // B loads: k rows b_k + 4i, column b_n

  float acc[4][4] = {};
  for (int d = 0; d < 3; ++d) {
    for (int c0 = 0; c0 < s.cin; c0 += kFBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + tx;
        const int ts = a_t[i] + d - 1;
        const bool ok = a_in[i] && ts >= 0 && ts < s.t_len && c < s.cin;
        As[tx][ty + 16 * i] = ok ? x[(a_m[i] + d - 1) * s.cin + c] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= s.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.cout) y[m * s.ldw + n] = acc[i][j] + bias[n];
    }
  }
}

// ---- (b) InstanceNorm over T + LeakyReLU -------------------------------------

constexpr int kNormC = 32, kNormR = 16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename Out>
__global__ void __launch_bounds__(kNormC * kNormR)
instnorm_lrelu_kernel(const float* __restrict__ y, Out* __restrict__ out, Shape s, float eps,
                      float slope) {
  __shared__ float part[kNormR][kNormC];
  __shared__ float mean_s[kNormC], var_s[kNormC];
  const int cx = threadIdx.x, ry = threadIdx.y;
  const int c = blockIdx.y * kNormC + cx;
  const bool on = c < s.cout;
  const long long row0 = static_cast<long long>(blockIdx.x) * s.t_len;
  const float* yb = y + row0 * s.ldw + c;
  Out* ob = out + row0 * s.cout + c;

  float acc = 0.f;
  if (on)
    for (int t = ry; t < s.t_len; t += kNormR) acc += yb[static_cast<long long>(t) * s.ldw];
  part[ry][cx] = acc;
  __syncthreads();
  if (ry == 0) {
    float sum = 0.f;
    for (int r = 0; r < kNormR; ++r) sum += part[r][cx];
    mean_s[cx] = sum / static_cast<float>(s.t_len);
  }
  __syncthreads();
  const float mean = mean_s[cx];

  acc = 0.f;
  if (on)
    for (int t = ry; t < s.t_len; t += kNormR) {
      const float dv = yb[static_cast<long long>(t) * s.ldw] - mean;
      acc += dv * dv;
    }
  part[ry][cx] = acc;
  __syncthreads();
  if (ry == 0) {
    float sum = 0.f;
    for (int r = 0; r < kNormR; ++r) sum += part[r][cx];
    var_s[cx] = sum / static_cast<float>(s.t_len);
  }
  __syncthreads();
  const float inv = rsqrtf(var_s[cx] + eps);

  if (on)
    for (int t = ry; t < s.t_len; t += kNormR) {
      const float z = (yb[static_cast<long long>(t) * s.ldw] - mean) * inv;
      store(ob + static_cast<long long>(t) * s.cout, z >= 0.f ? z : slope * z);
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// out (B, T, cout) <- LReLU(InstanceNorm_T(conv1x3(x, w) + bias)).
// x (B, T, cin) and w (3, cin, ldw) in dtype (0 = float32, 1 = bfloat16),
// bias (cout,) float32, ws a float32 workspace of B*T*ldw. bfloat16 needs
// cin and ldw to be multiples of 8 and x, w 16-byte aligned. Two launches on
// `stream`; returns the first cudaError, 0 on success.
int conv1x3_instnorm_lrelu(const void* x, const void* w, const float* bias, float* ws, void* out,
                           long long batch, int t_len, int cin, int cout, int ldw, int dtype,
                           float eps, float slope, cudaStream_t stream) {
  if (batch <= 0 || t_len <= 0 || cout <= 0) return 0;
  if (cin < 0 || ldw < cout || batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{batch * t_len, t_len, cin, cout, ldw};

  if (dtype == 1) {
    if (cin % 8 != 0 || ldw % 8 != 0 || !aligned16(x) || !aligned16(w)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // above 48 KB of dynamic shared memory only after this opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        conv_gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(ceil_div(s.rows, kBM)),
                    static_cast<unsigned>(ceil_div(ldw, kBN)));
    if (ceil_div(s.rows, kBM) > 0x7fffffffLL || grid.y > 65535u) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    conv_gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias, ws, s);
  } else if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(s.rows, kFBM)),
                    static_cast<unsigned>(ceil_div(cout, kFBN)));
    if (ceil_div(s.rows, kFBM) > 0x7fffffffLL || grid.y > 65535u) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    conv_gemm_f32_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(w), bias, ws, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 ngrid(static_cast<unsigned>(batch), static_cast<unsigned>(ceil_div(cout, kNormC)));
  if (ngrid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 nblock(kNormC, kNormR);
  if (dtype == 1) {
    instnorm_lrelu_kernel<__nv_bfloat16><<<ngrid, nblock, 0, stream>>>(
        ws, static_cast<__nv_bfloat16*>(out), s, eps, slope);
  } else {
    instnorm_lrelu_kernel<float><<<ngrid, nblock, 0, stream>>>(ws, static_cast<float*>(out), s,
                                                               eps, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
