// Griffin-Lim consistency glue for Hopper (sm_90a), plain C interface.
//
// One Griffin-Lim iteration on the card is
//   irfft (cuFFT) -> [window -> overlap-add -> x 1/WSS -> centre crop ->
//                     reflect pad -> re-frame -> window] -> rfft (cuFFT)
// and these two kernels compute the bracket:
//
//   gl_ola_nola_kernel      replaces ml_music_style_transfer_tpu/ops/pallas/gl_glue.py
//                           _ola_kernel (pallas_call at :95):
//       y[b*hop + s] = inv[b, s] * sum_{k=0..7, 0<=b-k<nf} frames[b-k, k*hop+s] * window[k*hop+s]
//   gl_frame_window_kernel  replaces ml_music_style_transfer_tpu/ops/pallas/gl_glue.py
//                           _frame_kernel (pallas_call at :110) AND the wrapper's
//                           exact edge-frame fix-up (gl_glue.py:161-180):
//       G[i, t] = window[t] * y[reflect(i*hop + t - n_fft/2) + n_fft/2]
//       with reflect() mirroring into [0, hop*(nf-1)) as numpy's "reflect".
//
// Design for the card. The TPU kernel carries the 7-block overlap tail from
// one grid step to the next in VMEM scratch, which relies on the TPU grid
// running in order. CUDA blocks run in no order, so each overlap-added
// sample is computed directly as the sum of its (at most) 8 contributing
// frame pieces: no carry, no atomics. The sum runs over k ascending, the
// order of the plain version's shifted adds. The centre crop and reflect pad
// are index arithmetic in the second kernel, so the 8 edge frames at each
// end come out of the same launch as the interior.
//
// What bounds it. Both kernels do a handful of flops per 4-byte element:
// they are bound by device memory. Per call the function must read the
// frames (nf*n_fft*4 B), the window and 1/WSS ((nf+7)*hop*4 B) and write G
// (nf*n_fft*4 B); the intermediate y ((nf+7)*hop*4 B, 1/8 of the frame
// bytes) is written by the first kernel and re-read by the second while it
// is still in the 50 MB L2. Every thread moves 16 bytes per access
// (float4), neighbouring threads on neighbouring addresses; only the few
// output elements whose source crosses the reflect boundary fall back to
// scalar reads.
#include <cuda_runtime.h>

namespace {

constexpr int kOverlap = 8;  // n_fft / hop
constexpr int kThreads = 256;

// Explicitly rounded multiply and add: no FMA contraction, so the kernels
// round exactly as the plain version's separate multiply and add do.
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
gl_ola_nola_kernel(const float* __restrict__ frames,
                   const float* __restrict__ window,
                   const float* __restrict__ inv,
                   float* __restrict__ y, int nf, int hop) {
  const int n_fft = kOverlap * hop;
  const int q = hop / 4;  // float4 per hop block
  const long long n_vec = static_cast<long long>(nf + kOverlap - 1) * q;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int b = static_cast<int>(v / q);
    const int s = static_cast<int>(v - static_cast<long long>(b) * q) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kOverlap; ++k) {
      const int f = b - k;
      if (f >= 0 && f < nf) {
        const int col = k * hop + s;
        const float4 x = *reinterpret_cast<const float4*>(
            frames + static_cast<size_t>(f) * n_fft + col);
        const float4 w = __ldg(reinterpret_cast<const float4*>(window + col));
        const float4 p = mul4(x, w);
        acc.x = __fadd_rn(acc.x, p.x);
        acc.y = __fadd_rn(acc.y, p.y);
        acc.z = __fadd_rn(acc.z, p.z);
        acc.w = __fadd_rn(acc.w, p.w);
      }
    }
    const float4 iv = *reinterpret_cast<const float4*>(
        inv + static_cast<size_t>(b) * hop + s);
    reinterpret_cast<float4*>(y)[v] = mul4(acc, iv);
  }
}

__global__ void __launch_bounds__(kThreads)
gl_frame_window_kernel(const float* __restrict__ y,
                       const float* __restrict__ window,
                       float* __restrict__ g, int nf, int hop) {
  const int n_fft = kOverlap * hop;
  const int half = n_fft / 2;
  const int length = hop * (nf - 1);  // samples istft keeps after the crop
  const int qf = n_fft / 4;           // float4 per output frame
  const long long n_vec = static_cast<long long>(nf) * qf;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const int i = static_cast<int>(v / qf);
    const int t = static_cast<int>(v - static_cast<long long>(i) * qf) * 4;
    const float4 w = __ldg(reinterpret_cast<const float4*>(window + t));
    const int c0 = i * hop + t - half;  // index into the cropped signal
    float4 out;
    if (c0 >= 0 && c0 + 3 < length) {
      // interior: crop and pad cancel, one aligned 16-byte read
      out = mul4(*reinterpret_cast<const float4*>(y + c0 + half), w);
    } else {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int c = c0 + u;
        c = c < 0 ? -c : c;
        c = c >= length ? 2 * (length - 1) - c : c;
        e[u] = y[c + half];
      }
      out = mul4(make_float4(e[0], e[1], e[2], e[3]), w);
    }
    reinterpret_cast<float4*>(g)[v] = out;
  }
}

int grid_for(long long n_vec) {
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535LL * 32 ? blocks : 65535LL * 32);
}

}  // namespace

extern "C" {

// frames (nf, 8*hop), window (8*hop), inv (nf+7, hop) -> y (nf+7, hop); f32.
int gl_ola_nola(const float* frames, const float* window, const float* inv,
                float* y, int nf, int hop, cudaStream_t stream) {
  const long long n_vec = static_cast<long long>(nf + kOverlap - 1) * (hop / 4);
  gl_ola_nola_kernel<<<grid_for(n_vec), kThreads, 0, stream>>>(
      frames, window, inv, y, nf, hop);
  return static_cast<int>(cudaGetLastError());
}

// y (nf+7, hop), window (8*hop) -> g (nf, 8*hop); f32.
int gl_frame_window(const float* y, const float* window, float* g, int nf,
                    int hop, cudaStream_t stream) {
  const long long n_vec = static_cast<long long>(nf) * (kOverlap * hop / 4);
  gl_frame_window_kernel<<<grid_for(n_vec), kThreads, 0, stream>>>(
      y, window, g, nf, hop);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
