// The port's kernels as PyTorch operators, defined and implemented in C++.
//
// TORCH_LIBRARY(mmst_torch) defines
//   gl_ola_nola(Tensor frames, Tensor window, Tensor inv_blocks) -> Tensor      K3a
//   gl_frame_window(Tensor y, Tensor window, SymInt nf) -> Tensor               K3b
//   dropout_apply(Tensor x, SymInt seed, SymInt call_index, float rate,
//                 bool backward=False) -> Tensor                                K2
//   dropout_mask(int[] shape, int seed, int call_index, float rate,
//                ScalarType dtype, Device device) -> Tensor                     K2
//   conv1x3_instnorm_lrelu(Tensor x, Tensor w, Tensor b, float eps=1e-05,
//                          float slope=0.01) -> Tensor                          K1
//   relayout(Tensor x, int dtype, bool channel_first) -> Tensor                K4
// (the first three with the names and schemas that programs exported
// earlier name), and the launch counters. Each operator has
//   - a CUDA implementation (built with MMST_WITH_CUDA) that launches the
//     hand-written kernel of csrc/<kernel>.cu through its plain C entry
//     point, on c10::cuda::getCurrentCUDAStream(), and raises on an error;
//   - a CPU implementation, the plain version in ATen or plain C++ (the
//     Python plain versions in ops/kernels/*.py compute the same numbers;
//     the glue's here are what an AOTInductor package run on the CPU calls);
//   - a Meta implementation (shapes only), which torch.export traces.
// The gradient of dropout_apply is attached from Python
// (ops/kernels/_library.py), as torch.library.register_autograd.
//
// Launch counters: one atomic per operator entry and device, bumped where a
// CUDA implementation has launched its kernel and where a CPU
// implementation has run, nowhere else. Python reads and resets them
// through launch_entries/launch_count/reset_launch_count; a C++ process
// (csrc/aoti_runner.cpp) through the extern "C" functions at the end.
#include <ATen/ATen.h>
#include <c10/util/BFloat16.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#ifdef MMST_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

extern "C" {
int gl_ola_nola(const float* frames, const float* window, const float* inv, float* y, int nf,
                int hop, cudaStream_t stream);
int gl_frame_window(const float* y, const float* window, float* g, int nf, int hop,
                    cudaStream_t stream);
int philox_dropout_mask(void* out, long long n, int dtype, uint32_t seed_lo, uint32_t seed_hi,
                        uint32_t call_index, uint32_t threshold, float scale,
                        cudaStream_t stream);
int philox_dropout_apply(const void* x, void* out, long long n, int dtype, uint32_t seed_lo,
                         uint32_t seed_hi, uint32_t call_index, uint32_t threshold, float scale,
                         cudaStream_t stream);
int conv1x3_instnorm_lrelu(const void* x, const void* w, const float* bias, float* ws, void* out,
                           long long batch, int t_len, int cin, int cout, int ldw, int dtype,
                           float eps, float slope, cudaStream_t stream);
long long conv1x3_instnorm_lrelu_ctas(long long batch, int t_len, int cout, int dtype);
int relayout(const void* x, void* y, long long B, long long R, long long S, long long xb,
             long long xr, long long xs, int in_dtype, int out_dtype, cudaStream_t stream);
}
#endif

namespace {

// ---- launch counters --------------------------------------------------------

enum Entry : int { kOla, kFrame, kMask, kApply, kGrad, kConv, kRelayout, kEntries };
constexpr const char* kEntryNames[kEntries] = {"gl_ola_nola",   "gl_frame_window",
                                               "dropout_mask",  "dropout_apply",
                                               "dropout_grad",  "conv1x3_instnorm_lrelu",
                                               "relayout"};
enum Dev : int { kCuda, kCpu, kDevs };
std::atomic<int64_t> g_counts[kEntries][kDevs];

void bump(Entry e, Dev d) { g_counts[e][d].fetch_add(1, std::memory_order_relaxed); }

int entry_index(const std::string& name) {
  for (int e = 0; e < kEntries; ++e) {
    if (name == kEntryNames[e]) return e;
  }
  TORCH_CHECK(false, "mmst_torch: no launch counter named '", name, "'");
}

int64_t launch_count(std::string op, std::string device) {
  TORCH_CHECK(device == "cuda" || device == "cpu", "device must be 'cuda' or 'cpu', got ", device);
  return g_counts[entry_index(op)][device == "cuda" ? kCuda : kCpu].load();
}

std::vector<std::string> launch_entries() {
  return std::vector<std::string>(kEntryNames, kEntryNames + kEntries);
}

void reset_launch_count(std::string op) {
  const int e = entry_index(op);
  for (int d = 0; d < kDevs; ++d) g_counts[e][d].store(0);
}

// ---- shared checks ----------------------------------------------------------

constexpr int64_t kR = 8;  // n_fft / hop

int64_t glue_hop(int64_t nf, int64_t n_fft) {
  TORCH_CHECK(n_fft % kR == 0 && (n_fft / kR) % 4 == 0, "n_fft=", n_fft, " must be ", kR,
              " hops of a multiple of 4 samples");
  TORCH_CHECK(nf >= 3 * kR, "the glue needs at least ", 3 * kR, " frames, got ", nf);
  return n_fft / kR;
}

void check_f32(const at::Tensor& t, const char* name, at::IntArrayRef shape,
               const at::Device& dev) {
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32, got ", t.scalar_type());
  TORCH_CHECK(t.sizes() == shape, name, " must have shape ", shape, ", got ", t.sizes());
  TORCH_CHECK(t.device() == dev, name, " is on ", t.device(), ", expected ", dev);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_ola(const at::Tensor& frames, const at::Tensor& window, const at::Tensor& inv) {
  TORCH_CHECK(frames.dim() == 2, "frames must be (nf, n_fft), got ", frames.sizes());
  const int64_t nf = frames.size(0), n_fft = frames.size(1);
  const int64_t hop = glue_hop(nf, n_fft);
  check_f32(frames, "frames", {nf, n_fft}, frames.device());
  check_f32(window, "window", {n_fft}, frames.device());
  check_f32(inv, "inv_blocks", {nf + kR - 1, hop}, frames.device());
}

void check_frame(const at::Tensor& y, const at::Tensor& window, int64_t nf) {
  TORCH_CHECK(window.dim() == 1, "window must be (n_fft,), got ", window.sizes());
  const int64_t n_fft = window.size(0);
  const int64_t hop = glue_hop(nf, n_fft);
  check_f32(y, "y", {nf + kR - 1, hop}, y.device());
  check_f32(window, "window", {n_fft}, y.device());
}

// ---- dropout: keep threshold, scale, Philox ---------------------------------

struct DropoutArgs {
  uint32_t seed_lo, seed_hi, call_index, threshold;
  double rate;
};

DropoutArgs dropout_args(int64_t seed, int64_t call_index, double rate) {
  TORCH_CHECK(call_index >= 0 && call_index < (int64_t{1} << 32),
              "call_index must be a 32-bit unsigned integer, got ", call_index);
  TORCH_CHECK(rate > 0.0 && rate < 1.0, "dropout rate must lie in (0, 1), got ", rate);
  const uint64_t s = static_cast<uint64_t>(seed);  // the signed schema int's two's complement
  // keep iff bits <= threshold: round((1 - rate) 2^32) clamped to [1, 2^32 - 1], minus 1
  // (Python's round is to the nearest even, as nearbyint in the default mode)
  double k = std::nearbyint((1.0 - rate) * 4294967296.0);
  k = std::min(std::max(k, 1.0), 4294967295.0);
  return {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32),
          static_cast<uint32_t>(call_index), static_cast<uint32_t>(k - 1.0), rate};
}

// 1/(1-rate) rounded to float32, then to the tensor's dtype
template <typename scalar_t>
scalar_t dropout_scale(double rate) {
  return static_cast<scalar_t>(static_cast<float>(1.0 / (1.0 - rate)));
}

// Philox4x32-10 (Random123's constants): counter (g lo, g hi, call_index, 0),
// key (seed lo, seed hi); word j is the bits of element 4 g + j
void philox(uint64_t g, const DropoutArgs& a, uint32_t out[4]) {
  uint32_t c0 = static_cast<uint32_t>(g), c1 = static_cast<uint32_t>(g >> 32);
  uint32_t c2 = a.call_index, c3 = 0, k0 = a.seed_lo, k1 = a.seed_hi;
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = static_cast<uint64_t>(c0) * 0xD2511F53u;
    const uint64_t p1 = static_cast<uint64_t>(c2) * 0xCD9E8D57u;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32), lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32), lo1 = static_cast<uint32_t>(p1);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// out[i] = keep(i) ? scale : 0 (the mask), or with x, x[i] times that: the
// product is taken for dropped elements too, so signs of zero and NaNs match
// the plain x * mask
template <typename scalar_t>
void dropout_cpu_loop(const scalar_t* x, scalar_t* out, int64_t n, const DropoutArgs& a) {
  const scalar_t scale = dropout_scale<scalar_t>(a.rate);
  const scalar_t zero = static_cast<scalar_t>(0.0f);
  uint32_t bits[4];
  for (int64_t g = 0; 4 * g < n; ++g) {
    philox(static_cast<uint64_t>(g), a, bits);
    for (int j = 0; j < 4 && 4 * g + j < n; ++j) {
      const int64_t i = 4 * g + j;
      const scalar_t m = bits[j] <= a.threshold ? scale : zero;
      out[i] = x ? static_cast<scalar_t>(x[i] * m) : m;
    }
  }
}

at::Tensor dropout_cpu(const at::Tensor* x, at::Tensor out, const DropoutArgs& a) {
  AT_DISPATCH_FLOATING_TYPES_AND(at::kBFloat16, out.scalar_type(), "mmst_dropout_cpu", [&] {
    dropout_cpu_loop<scalar_t>(x ? x->data_ptr<scalar_t>() : nullptr, out.data_ptr<scalar_t>(),
                               out.numel(), a);
  });
  return out;
}

void check_dropout_dtype(at::ScalarType t, bool cuda) {
  if (cuda) {
    TORCH_CHECK(t == at::kFloat || t == at::kBFloat16,
                "the dropout kernel takes float32 or bfloat16, got ", t);
  } else {
    TORCH_CHECK(t == at::kFloat || t == at::kBFloat16 || t == at::kDouble,
                "dropout takes float32, bfloat16 or float64, got ", t);
  }
}

// ---- CPU implementations: the plain versions --------------------------------

at::Tensor ola_nola_cpu(const at::Tensor& frames, const at::Tensor& window,
                        const at::Tensor& inv) {
  check_ola(frames, window, inv);
  const int64_t nf = frames.size(0), hop = frames.size(1) / kR;
  // window, then the dense shifted overlap-add, then x 1/WSS (stft.overlap_add)
  const at::Tensor pieces = (frames * window).reshape({nf, kR, hop});
  at::Tensor total = at::zeros({nf + kR - 1, hop}, frames.options());
  for (int64_t j = 0; j < kR; ++j) total.narrow(0, j, nf).add_(pieces.select(1, j));
  at::Tensor y = (total.reshape({-1}) * inv.reshape({-1})).reshape({-1, hop});
  bump(kOla, kCpu);
  return y;
}

at::Tensor frame_window_cpu(const at::Tensor& y, const at::Tensor& window, int64_t nf) {
  check_frame(y, window, nf);
  const int64_t n_fft = window.size(0), hop = n_fft / kR, half = n_fft / 2;
  // centre crop, numpy "reflect" pad, reshape-shift framing (stft.frame_dense), window
  const at::Tensor flat = y.reshape({-1});
  const at::Tensor yc = flat.slice(0, half, flat.size(0) - half);
  const at::Tensor padded = at::cat({yc.slice(0, 1, half + 1).flip({0}), yc,
                                     yc.slice(0, yc.size(0) - half - 1, yc.size(0) - 1).flip({0})});
  const at::Tensor blocks = padded.slice(0, 0, (nf - 1 + kR) * hop).reshape({nf - 1 + kR, hop});
  std::vector<at::Tensor> parts;
  for (int64_t j = 0; j < kR; ++j) parts.push_back(blocks.slice(0, j, j + nf));
  at::Tensor g = at::cat(parts, -1) * window;
  bump(kFrame, kCpu);
  return g;
}

at::Tensor dropout_apply_cpu(const at::Tensor& x, int64_t seed, int64_t call_index, double rate,
                             bool backward) {
  check_dropout_dtype(x.scalar_type(), false);
  TORCH_CHECK(x.is_contiguous(), "dropout_apply needs a contiguous tensor");
  const DropoutArgs a = dropout_args(seed, call_index, rate);
  at::Tensor out = dropout_cpu(&x, at::empty_like(x), a);
  bump(backward ? kGrad : kApply, kCpu);
  return out;
}

at::Tensor conv1x3_cpu(const at::Tensor& x, const at::Tensor& w, const at::Tensor& b, double eps,
                       double slope) {
  // ops/kernels/fused_conv.py conv1x3_instnorm_lrelu_reference, op for op
  const int64_t T = x.size(1);
  const at::Tensor x32 = at::constant_pad_nd(x.to(at::kFloat), {0, 0, 1, 1});
  const at::Tensor w32 = w.to(x.scalar_type()).to(at::kFloat);
  at::Tensor acc = at::matmul(x32.slice(1, 0, T), w32[0]);
  for (int64_t d = 1; d < 3; ++d) acc = acc + at::matmul(x32.slice(1, d, d + T), w32[d]);
  const at::Tensor y = b.to(at::kFloat) + acc;
  const at::Tensor mean = y.mean({1}, true);
  const at::Tensor var = (y - mean).pow(2).mean({1}, true);
  const at::Tensor yn = (y - mean) * at::rsqrt(var + eps);
  at::Tensor out = at::where(yn >= 0, yn, slope * yn).to(x.scalar_type());
  bump(kConv, kCpu);
  return out;
}

// relayout: (B, C, T) x as ``dtype``, stored channel-first contiguous or
// channel-last (the transpose view of a contiguous (B, T, C)). The dtype
// travels as a code of this operator's own (0 float32, 1 bfloat16, 2
// float64; ops/kernels/relayout.py): AOTInductor's runtime hands a
// ScalarType argument of a custom operator on as another type. K4 takes
// float32 and bfloat16; float64 is the CPU's, for the float64 yardstick.
at::ScalarType relayout_type(int64_t code) {
  constexpr at::ScalarType kTypes[] = {at::kFloat, at::kBFloat16, at::kDouble};
  TORCH_CHECK(code >= 0 && code < 3, "relayout: unknown dtype code ", code);
  return kTypes[code];
}

at::Tensor relayout_empty(const at::Tensor& x, at::ScalarType dtype, bool channel_first) {
  const auto opts = x.options().dtype(dtype);
  if (channel_first) return at::empty_symint(x.sym_sizes(), opts);
  return at::empty_symint({x.sym_size(0), x.sym_size(2), x.sym_size(1)}, opts).transpose(1, 2);
}

void check_relayout(const at::Tensor& x) {
  TORCH_CHECK(x.dim() == 3, "relayout takes (B, C, T), got ", x.sizes());
}

at::Tensor relayout_cpu(const at::Tensor& x, int64_t dtype, bool channel_first) {
  check_relayout(x);
  at::Tensor out = relayout_empty(x, relayout_type(dtype), channel_first).copy_(x);
  bump(kRelayout, kCpu);
  return out;
}

// ---- Meta implementations: shapes only --------------------------------------

at::Tensor ola_nola_meta(const at::Tensor& frames, const at::Tensor& window,
                         const at::Tensor& inv) {
  return at::empty_symint({frames.sym_size(0) + (kR - 1), frames.sym_size(1) / kR},
                          frames.options());
}

at::Tensor frame_window_meta(const at::Tensor& y, const at::Tensor& window, c10::SymInt nf) {
  return at::empty_symint({std::move(nf), window.sym_size(0)}, y.options());
}

at::Tensor dropout_apply_meta(const at::Tensor& x, c10::SymInt, c10::SymInt, double, bool) {
  return at::empty_like(x);
}

at::Tensor conv1x3_meta(const at::Tensor& x, const at::Tensor& w, const at::Tensor&, double,
                        double) {
  return at::empty_symint({x.sym_size(0), x.sym_size(1), w.sym_size(2)}, x.options());
}

at::Tensor relayout_meta(const at::Tensor& x, int64_t dtype, bool channel_first) {
  check_relayout(x);
  return relayout_empty(x, relayout_type(dtype), channel_first);
}

// ---- CUDA implementations: the hand-written kernels -------------------------

#ifdef MMST_WITH_CUDA
cudaStream_t stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void launched(int err, const char* kernel) {
  TORCH_CHECK(err == 0, kernel, " launch failed with cudaError ", err, " (",
              cudaGetErrorString(static_cast<cudaError_t>(err)), ")");
}

at::Tensor ola_nola_cuda(const at::Tensor& frames, const at::Tensor& window,
                         const at::Tensor& inv) {
  check_ola(frames, window, inv);
  const c10::cuda::CUDAGuard guard(frames.device());
  const int64_t nf = frames.size(0), hop = frames.size(1) / kR;
  at::Tensor y = at::empty({nf + kR - 1, hop}, frames.options());
  launched(gl_ola_nola(frames.data_ptr<float>(), window.data_ptr<float>(), inv.data_ptr<float>(),
                       y.data_ptr<float>(), static_cast<int>(nf), static_cast<int>(hop),
                       stream_of(frames)),
           "gl_ola_nola");
  bump(kOla, kCuda);
  return y;
}

at::Tensor frame_window_cuda(const at::Tensor& y, const at::Tensor& window, int64_t nf) {
  check_frame(y, window, nf);
  const c10::cuda::CUDAGuard guard(y.device());
  const int64_t n_fft = window.size(0);
  at::Tensor g = at::empty({nf, n_fft}, y.options());
  launched(gl_frame_window(y.data_ptr<float>(), window.data_ptr<float>(), g.data_ptr<float>(),
                           static_cast<int>(nf), static_cast<int>(n_fft / kR), stream_of(y)),
           "gl_frame_window");
  bump(kFrame, kCuda);
  return g;
}

int dropout_kernel_dtype(at::ScalarType t) { return t == at::kBFloat16 ? 1 : 0; }

float dropout_kernel_scale(const DropoutArgs& a, at::ScalarType t) {
  return t == at::kBFloat16 ? static_cast<float>(dropout_scale<c10::BFloat16>(a.rate))
                            : dropout_scale<float>(a.rate);
}

at::Tensor dropout_apply_cuda(const at::Tensor& x, int64_t seed, int64_t call_index, double rate,
                              bool backward) {
  check_dropout_dtype(x.scalar_type(), true);
  TORCH_CHECK(x.is_contiguous(), "dropout_apply needs a contiguous tensor");
  const DropoutArgs a = dropout_args(seed, call_index, rate);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty_like(x);
  launched(philox_dropout_apply(x.data_ptr(), out.data_ptr(), x.numel(),
                                dropout_kernel_dtype(x.scalar_type()), a.seed_lo, a.seed_hi,
                                a.call_index, a.threshold,
                                dropout_kernel_scale(a, x.scalar_type()), stream_of(x)),
           "philox_dropout_apply");
  bump(backward ? kGrad : kApply, kCuda);
  return out;
}

constexpr int64_t kBf16Align = 8;  // bfloat16 elements in 16 bytes: TMA's stride unit
constexpr int64_t kBox = 64;       // time rows of one item per GEMM box (fused_conv.cu kBox)

int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }

at::Tensor aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0 ? t : t.clone();
}

at::Tensor conv1x3_cuda(const at::Tensor& x_in, const at::Tensor& w_in, const at::Tensor& b,
                        double eps, double slope) {
  const c10::cuda::CUDAGuard guard(x_in.device());
  const int64_t B = x_in.size(0), T = x_in.size(1), cin = x_in.size(2), cout = w_in.size(2);
  at::Tensor x = x_in;
  at::Tensor w = w_in.to(x.scalar_type()).contiguous();
  int64_t cin_p = cin, cout_p = cout;
  if (x.scalar_type() == at::kBFloat16) {
    // TMA: row strides a multiple of 16 bytes, so Cin and Cout padded to
    // multiples of 8 with zeros (Cin = 1025 at audio_down_0.conv1), and
    // 16-byte starts
    cin_p = round_up(cin, kBf16Align);
    cout_p = round_up(cout, kBf16Align);
    x = cin_p != cin ? at::constant_pad_nd(x, {0, cin_p - cin}) : aligned16(x);
    w = (cin_p != cin || cout_p != cout)
            ? at::constant_pad_nd(w, {0, cout_p - cout, 0, cin_p - cin})
            : aligned16(w);
  }
  at::Tensor out = at::empty({B, T, cout}, x.options());
  if (out.numel() == 0) return out;
  // y (B*T, ldy) then the boxes' (mean, M2) partials (B*ceil(T/64), ldy, 2)
  const int64_t ldy = round_up(cout, 8);
  at::Tensor ws = at::empty({ldy * (B * T + 2 * B * ((T + kBox - 1) / kBox))},
                            x.options().dtype(at::kFloat));
  const int err = conv1x3_instnorm_lrelu(
      x.data_ptr(), w.data_ptr(), nullptr, ws.data_ptr<float>(), out.data_ptr(), B,
      static_cast<int>(T), static_cast<int>(cin_p), static_cast<int>(cout),
      static_cast<int>(cout_p), x.scalar_type() == at::kBFloat16 ? 1 : 0,
      static_cast<float>(eps), static_cast<float>(slope), stream_of(x));
  TORCH_CHECK(err >= 0, "conv1x3_instnorm_lrelu: cuTensorMapEncodeTiled failed with CUresult ",
              -err);
  launched(err, "conv1x3_instnorm_lrelu");
  bump(kConv, kCuda);
  return out;
}

int relayout_dtype(at::ScalarType t, const char* what) {
  TORCH_CHECK(t == at::kFloat || t == at::kBFloat16, "relayout on the card: ", what,
              " must be float32 or bfloat16, got ", t);
  return t == at::kBFloat16 ? 1 : 0;
}

at::Tensor relayout_cuda(const at::Tensor& x, int64_t dtype_code, bool channel_first) {
  check_relayout(x);
  const at::ScalarType dtype = relayout_type(dtype_code);
  const int in_dtype = relayout_dtype(x.scalar_type(), "the input"),
            out_dtype = relayout_dtype(dtype, "the output");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = relayout_empty(x, dtype, channel_first);
  if (x.numel() == 0) return out;
  // each batch item (R, S), read through x's strides, is written transposed
  // (S, R): to channel-first R = T, S = C; to channel-last R = C, S = T.
  // The reads coalesce where S has unit stride, the layout the models hand
  // it (a tensor already stored as asked is cast by its caller, not here)
  const int64_t fast = channel_first ? 1 : 2, slow = 3 - fast;
  launched(relayout(x.data_ptr(), out.data_ptr(), x.size(0), x.size(slow), x.size(fast),
                    x.stride(0), x.stride(slow), x.stride(fast), in_dtype, out_dtype,
                    stream_of(x)),
           "relayout");
  bump(kRelayout, kCuda);
  return out;
}
#endif

// ---- operators without tensor inputs: dispatched here by their arguments -----

at::Tensor dropout_mask_any(at::IntArrayRef shape, int64_t seed, int64_t call_index, double rate,
                            at::ScalarType dtype, at::Device device) {
  const DropoutArgs a = dropout_args(seed, call_index, rate);
  check_dropout_dtype(dtype, device.is_cuda());
  at::Tensor out = at::empty(shape, at::TensorOptions().dtype(dtype).device(device));
  if (device.is_cpu()) {
    dropout_cpu(nullptr, out, a);
    bump(kMask, kCpu);
    return out;
  }
#ifdef MMST_WITH_CUDA
  if (device.is_cuda()) {
    const c10::cuda::CUDAGuard guard(device);
    launched(philox_dropout_mask(out.data_ptr(), out.numel(), dropout_kernel_dtype(dtype),
                                 a.seed_lo, a.seed_hi, a.call_index, a.threshold,
                                 dropout_kernel_scale(a, dtype), stream_of(out)),
             "philox_dropout_mask");
    bump(kMask, kCuda);
    return out;
  }
#endif
  TORCH_CHECK(device.is_meta(), "dropout_mask: unsupported device ", device,
              " (this operator library was built without CUDA)");
  return out;
}

int64_t conv1x3_ctas(int64_t batch, int64_t t, int64_t cout, at::ScalarType dtype) {
#ifdef MMST_WITH_CUDA
  const long long n = conv1x3_instnorm_lrelu_ctas(batch, static_cast<int>(t),
                                                  static_cast<int>(cout),
                                                  dtype == at::kBFloat16 ? 1 : 0);
  TORCH_CHECK(n >= 0, "conv1x3_instnorm_lrelu_ctas failed with cudaError ", -n);
  return n;
#else
  TORCH_CHECK(false, "conv1x3_instnorm_lrelu_ctas needs the operator library built with CUDA");
#endif
}

}  // namespace

TORCH_LIBRARY(mmst_torch, m) {
  m.def("gl_ola_nola(Tensor frames, Tensor window, Tensor inv_blocks) -> Tensor");
  m.def("gl_frame_window(Tensor y, Tensor window, SymInt nf) -> Tensor");
  m.def("dropout_apply(Tensor x, SymInt seed, SymInt call_index, float rate, "
        "bool backward=False) -> Tensor");
  m.def("conv1x3_instnorm_lrelu(Tensor x, Tensor w, Tensor b, float eps=1e-05, "
        "float slope=0.01) -> Tensor");
  m.def("dropout_mask(int[] shape, int seed, int call_index, float rate, ScalarType dtype, "
        "Device device) -> Tensor",
        &dropout_mask_any);
  m.def("conv1x3_instnorm_lrelu_ctas(int batch, int t, int cout, ScalarType dtype) -> int",
        &conv1x3_ctas);
  m.def("relayout(Tensor x, int dtype, bool channel_first) -> Tensor");
  m.def("launch_entries() -> str[]", &launch_entries);
  m.def("launch_count(str op, str device) -> int", &launch_count);
  m.def("reset_launch_count(str op) -> ()", &reset_launch_count);
}

TORCH_LIBRARY_IMPL(mmst_torch, CPU, m) {
  m.impl("gl_ola_nola", &ola_nola_cpu);
  m.impl("gl_frame_window", &frame_window_cpu);
  m.impl("dropout_apply", &dropout_apply_cpu);
  m.impl("conv1x3_instnorm_lrelu", &conv1x3_cpu);
  m.impl("relayout", &relayout_cpu);
}

TORCH_LIBRARY_IMPL(mmst_torch, Meta, m) {
  m.impl("gl_ola_nola", &ola_nola_meta);
  m.impl("gl_frame_window", &frame_window_meta);
  m.impl("dropout_apply", &dropout_apply_meta);
  m.impl("conv1x3_instnorm_lrelu", &conv1x3_meta);
  m.impl("relayout", &relayout_meta);
}

#ifdef MMST_WITH_CUDA
TORCH_LIBRARY_IMPL(mmst_torch, CUDA, m) {
  m.impl("gl_ola_nola", &ola_nola_cuda);
  m.impl("gl_frame_window", &frame_window_cuda);
  m.impl("dropout_apply", &dropout_apply_cuda);
  m.impl("conv1x3_instnorm_lrelu", &conv1x3_cuda);
  m.impl("relayout", &relayout_cuda);
}
#endif

// For a process without Python (csrc/aoti_runner.cpp): the count of ``op``
// (a name above) on ``device`` ("cuda" or "cpu"), or -1 for an unknown name.
extern "C" long long mmst_launch_count(const char* op, const char* device) {
  const bool cuda = std::strcmp(device, "cuda") == 0;
  for (int e = 0; e < kEntries; ++e) {
    if (std::strcmp(op, kEntryNames[e]) == 0) return g_counts[e][cuda ? kCuda : kCpu].load();
  }
  return -1;
}

extern "C" int mmst_launch_entries(const char* const** names) {
  *names = kEntryNames;
  return kEntries;
}
