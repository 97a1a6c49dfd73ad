// Relayout of (B, C, T) activations between channel-last and channel-first
// memory, with a cast, for Hopper (sm_90a), plain C interface.
//
// The models run channel-last on the card (models/layers.py): cuDNN's bf16
// convolutions take NHWC with no transpose. InstanceNorm still sums its
// statistics, and a convolution's bias its gradient, over a contiguous
// time axis, so that the channel-last model computes the channel-first
// one's numbers bit for bit; this kernel moves a tensor between the two
// layouts in the pass that casts it anyway (bf16 <-> f32), or alone.
//
// Each batch item is a matrix x (R, S) read with strides (xr, xs), written
// transposed into y (S, R), contiguous: channel-last to channel-first is
// R = T, S = C; channel-first to channel-last R = C, S = T. A block of
// 32 x 8 threads moves one 64 x 64 tile through shared memory, 16 elements
// a thread: its threads read along S, the input's unit-stride axis where
// the models call it (any strides are read right), and write along R, the
// output's, so both sides are coalesced; the tile's row pad keeps the
// transposed reads free of bank conflicts. Values pass
// through float32 (exact for bf16 and f32) and are rounded once to the
// output type, to nearest even, as PyTorch's casts do.
//
// What bounds it: memory. It reads each element once and writes it once
// (6 bytes an element between bf16 and f32, 4 for bf16 alone); no
// arithmetic to speak of.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kCols = 32;  // threads a block along the tile's columns
constexpr int kRows = 8;   // and along its rows: 32 x 8, 16 elements each

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kCols * kRows)
relayout_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, long long R, long long S,
                long long xb, long long xr, long long xs) {
  __shared__ float tile[kTile][kTile + 1];
  const long long b = blockIdx.z;
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long r0 = static_cast<long long>(blockIdx.y) * kTile;
  const Tin* xi = x + b * xb;
#pragma unroll
  for (int i = threadIdx.y; i < kTile; i += kRows) {
#pragma unroll
    for (int j = threadIdx.x; j < kTile; j += kCols) {
      const long long r = r0 + i, s = s0 + j;
      if (r < R && s < S) tile[i][j] = load_f(xi + r * xr + s * xs);
    }
  }
  __syncthreads();
  Tout* yi = y + b * R * S;
#pragma unroll
  for (int i = threadIdx.y; i < kTile; i += kRows) {
#pragma unroll
    for (int j = threadIdx.x; j < kTile; j += kCols) {
      const long long s = s0 + i, r = r0 + j;
      if (s < S && r < R) store_f(yi + s * R + r, tile[j][i]);
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, void* y, long long B, long long R, long long S, long long xb,
           long long xr, long long xs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + kTile - 1) / kTile),
                  static_cast<unsigned>((R + kTile - 1) / kTile), static_cast<unsigned>(B));
  relayout_kernel<Tin, Tout><<<grid, dim3(kCols, kRows), 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(y), R, S, xb, xr, xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y[b, s, r] = x[b * xb + r * xr + s * xs] for b < B, r < R, s < S, y
// contiguous; dtypes 0 float32, 1 bfloat16. Returns a cudaError_t; grid
// limits: B and ceil(R / 64) at most 65535.
extern "C" int relayout(const void* x, void* y, long long B, long long R, long long S,
                        long long xb, long long xr, long long xs, int in_dtype, int out_dtype,
                        cudaStream_t stream) {
  if (B == 0 || R == 0 || S == 0) return 0;
  if (B > 65535 || (R + kTile - 1) / kTile > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, y, B, R, S, xb, xr, xs, stream);
  if (in_dtype == 1) return launch<__nv_bfloat16, float>(x, y, B, R, S, xb, xr, xs, stream);
  if (out_dtype == 1) return launch<float, __nv_bfloat16>(x, y, B, R, S, xb, xr, xs, stream);
  return launch<float, float>(x, y, B, R, S, xb, xr, xs, stream);
}
