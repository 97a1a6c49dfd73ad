// DenseConcat dropout for Hopper (sm_90a), plain C interface.
//
// Replaces ml_music_style_transfer_tpu/ops/pallas/dropout.py _mask_kernel
// (pallas_call at :94): a scaled keep-mask, 1/(1-rate) where the random
// uint32 bits <= threshold (_keep_threshold, :52-60), else 0, in the
// activation dtype. The JAX model multiplies activations by that mask
// (layers.py:64-66); here one kernel does either
//   mask  : out[i] = keep(i) ? scale : 0                  (philox_dropout_mask)
//   apply : out[i] = x[i] * (keep(i) ? scale : 0)         (philox_dropout_apply)
// and the apply form serves both the forward and the backward (the gradient
// of x * mask is grad * mask, the same mask regenerated from its seed).
//
// Random bits. The TPU's hardware PRNG has no counterpart on the card, so
// the bits come from Philox4x32-10 (Salmon et al., SC'11; Random123's
// constants): key = the 64-bit seed as (lo, hi), counter = (g lo, g hi,
// call_index, 0) with g = element index / 4, and word j of the result is
// the bits of element 4g + j. The bits depend only on (seed, call_index,
// element index), never on the launch shape, so the plain PyTorch version
// (ops/kernels/dropout.py) reproduces them exactly.
//
// Rounding. The scale arrives already rounded to the tensor's dtype. For
// bf16, x * scale of two bf16 values is exact in f32 and is rounded once to
// bf16, as PyTorch's bf16 multiply does; for f32, __fmul_rn. The product is
// taken even for dropped elements (x * 0), so signs of zero and NaNs match
// the plain x * mask.
//
// What bounds it. The function reads x once and writes out once: at the
// largest call on the training path, (16, 384, 860) bf16 = 5.28 M elements,
// that is 21.1 MB, 6.3 us at 3.35 TB/s. Philox costs 10 rounds of two
// 32x32->64 multiplies (one IMAD.WIDE each) and two three-input XORs (one
// LOP3 each) per 4 elements, plus a compare and a select per element:
// about 12 int32 instructions per element, 3.8 us at the card's int32 rate
// (a quarter of its 67 TFLOP/s float32 rate). So the fused apply is bound
// by memory and the mask alone by integer work; neither bound is far below
// the other. The design keeps both at their minimum: no shared memory, no
// carry between blocks, one pass; each thread runs one Philox call per 4
// elements and moves 16 bytes per access (8 bf16 or 4 f32 values, two or
// one Philox calls), neighbouring threads on neighbouring addresses; a
// grid-stride loop covers the tensor and a scalar path its ragged tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key bumps

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  long long n;
  uint32_t seed_lo, seed_hi, call_index, threshold;
  float scale;  // 1/(1-rate), already rounded to the element type
};

template <typename T, bool kApply>
__device__ __forceinline__ T element(const T* x, long long i, uint32_t bits, const Params& p) {
  const float m = bits <= p.threshold ? p.scale : 0.f;
  if constexpr (kApply) {
    return from_f32<T>(__fmul_rn(to_f32(x[i]), m));
  } else {
    return from_f32<T>(m);
  }
}

template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

// kVec: x and out are 16-byte aligned, so whole chunks move as one access.
template <typename T, bool kApply, bool kVec>
__global__ void __launch_bounds__(kThreads)
philox_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, Params p) {
  constexpr int kElems = 16 / sizeof(T);  // elements per chunk: 8 bf16, 4 f32
  constexpr int kCalls = kElems / 4;      // Philox calls per chunk
  const long long n_chunks = (p.n + kElems - 1) / kElems;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < n_chunks; c += stride) {
    const long long e0 = c * kElems;
    uint32_t bits[kElems];
#pragma unroll
    for (int k = 0; k < kCalls; ++k) {
      const unsigned long long g = static_cast<unsigned long long>(e0 / 4 + k);
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                     p.call_index, 0u),
          p.seed_lo, p.seed_hi);
      bits[4 * k] = r.x;
      bits[4 * k + 1] = r.y;
      bits[4 * k + 2] = r.z;
      bits[4 * k + 3] = r.w;
    }
    if (kVec && e0 + kElems <= p.n) {
      Vec<T> in_v, out_v;
      if constexpr (kApply) in_v = *reinterpret_cast<const Vec<T>*>(x + e0);
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        out_v.v[j] = element<T, kApply>(in_v.v, j, bits[j], p);
      }
      *reinterpret_cast<Vec<T>*>(out + e0) = out_v;
    } else {  // unaligned tensors, and the ragged tail
#pragma unroll
      for (int j = 0; j < kElems; ++j) {
        if (e0 + j < p.n) out[e0 + j] = element<T, kApply>(x, e0 + j, bits[j], p);
      }
    }
  }
}

int grid_for(long long n_chunks) {
  const long long blocks = (n_chunks + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535LL * 32 ? blocks : 65535LL * 32);
}

template <typename T, bool kApply>
int launch(const void* x, void* out, const Params& p, cudaStream_t stream) {
  constexpr long long kElems = 16 / sizeof(T);
  if (p.n <= 0) return 0;
  const long long n_chunks = (p.n + kElems - 1) / kElems;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (!kApply || reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (aligned) {
    philox_dropout_kernel<T, kApply, true><<<grid_for(n_chunks), kThreads, 0, stream>>>(xt, ot, p);
  } else {
    philox_dropout_kernel<T, kApply, false><<<grid_for(n_chunks), kThreads, 0, stream>>>(xt, ot, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kApply>
int dispatch(const void* x, void* out, long long n, int dtype, uint32_t seed_lo,
             uint32_t seed_hi, uint32_t call_index, uint32_t threshold, float scale,
             cudaStream_t stream) {
  const Params p{n, seed_lo, seed_hi, call_index, threshold, scale};
  if (dtype == 0) return launch<float, kApply>(x, out, p, stream);
  if (dtype == 1) return launch<__nv_bfloat16, kApply>(x, out, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (n,) <- scaled keep-mask; dtype 0 = float32, 1 = bfloat16.
int philox_dropout_mask(void* out, long long n, int dtype, uint32_t seed_lo,
                        uint32_t seed_hi, uint32_t call_index, uint32_t threshold,
                        float scale, cudaStream_t stream) {
  return dispatch<false>(nullptr, out, n, dtype, seed_lo, seed_hi, call_index,
                         threshold, scale, stream);
}

// out (n,) <- x * mask, the mask never stored; dtype as above.
int philox_dropout_apply(const void* x, void* out, long long n, int dtype,
                         uint32_t seed_lo, uint32_t seed_hi, uint32_t call_index,
                         uint32_t threshold, float scale, cudaStream_t stream) {
  return dispatch<true>(x, out, n, dtype, seed_lo, seed_hi, call_index, threshold,
                        scale, stream);
}

}  // extern "C"
