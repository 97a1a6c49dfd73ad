// wavdec: native WAV decode + mono mixdown (+ polyphase resample), the
// port's own copy of the JAX package's native/fastloader/wavdec.cpp.
//
// A ctypes call releases the GIL for its whole duration, so a decode on
// the serving daemon's reader thread overlaps the completer's work even on
// one core, and the decode itself skips NumPy's int->float64->float32
// temporaries.
//
// Python contract (data/audio_io.py:read_wav): mono float32 in [-1, 1];
// int16/32, uint8, float32/64 and 24-bit PCM supported; channels averaged;
// float formats rejected if non-finite; malformed bytes -> negative code
// (Python raises ValueError). Resampling: wd_resample_poly implements
// scipy.signal.resample_poly's default configuration (kaiser(5.0) firwin,
// half_len = 10*max(up,down)) in float64 so the native path matches the
// scipy path to ~1e-6.
//
// A plain C API for ctypes, built by ops/kernels/_build.load_host (g++).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---- little-endian readers over a bounds-checked buffer -------------------
struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  bool need(size_t k) {
    if (!ok || off + k > n) { ok = false; return false; }
    return true;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                 ((uint32_t)p[off + 2] << 16) | ((uint32_t)p[off + 3] << 24);
    off += 4;
    return v;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t)(p[off] | (p[off + 1] << 8));
    off += 2;
    return v;
  }
  bool tag(const char* t) {
    if (!need(4)) return false;
    bool m = std::memcmp(p + off, t, 4) == 0;
    off += 4;
    return m;
  }
};

double kaiser_i0(double x) {
  // modified Bessel I0 by power series (converges fast for beta=5 range)
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (double)(k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Decode a WAV file to mono float32 at ITS OWN sample rate.
// On success returns the sample count (>= 1), mallocs *out (free with
// wd_free) and sets *sr_out. Negative return = error:
//   -1 cannot open/read   -2 not a RIFF/WAVE or truncated header
//   -3 unsupported/invalid fmt chunk    -4 no samples
//   -5 non-finite float samples         -6 non-positive sample rate
long long wd_decode(const char* path, float** out, int* sr_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsz <= 0) { std::fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)fsz);
  size_t got = std::fread(buf.data(), 1, (size_t)fsz, f);
  std::fclose(f);
  if (got != (size_t)fsz) return -1;

  Cursor c{buf.data(), buf.size()};
  if (!c.tag("RIFF")) return -2;
  (void)c.u32();  // riff size (untrusted; we bound by the real file size)
  if (!c.tag("WAVE")) return -2;

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  bool have_fmt = false;
  const uint8_t* data = nullptr;
  size_t data_len = 0;

  while (c.ok && c.off + 8 <= c.n) {
    char id[5] = {0};
    std::memcpy(id, c.p + c.off, 4);
    c.off += 4;
    uint32_t sz = c.u32();
    if (!c.ok) break;
    size_t body = c.off;
    size_t avail = c.n - body;
    size_t take = sz < avail ? sz : avail;  // tolerate truncated final chunk
    if (std::memcmp(id, "fmt ", 4) == 0) {
      if (take < 16) return -3;
      Cursor fc{c.p + body, take};
      fmt_code = fc.u16();
      channels = fc.u16();
      rate = fc.u32();
      (void)fc.u32();  // byte rate
      (void)fc.u16();  // block align
      bits = fc.u16();
      if (fmt_code == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE: sub-format GUID
        if (take < 26 + 16) return -3;
        uint16_t sub = (uint16_t)(c.p[body + 24] | (c.p[body + 25] << 8));
        fmt_code = sub;  // first 2 bytes of the GUID carry the format tag
      }
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      data = c.p + body;
      data_len = take;
    }
    c.off = body + take + (take & 1);  // chunks are word-aligned
    if (take != sz) break;             // truncated: nothing follows
  }

  if (!have_fmt || data == nullptr) return -2;
  if (channels == 0) return -3;
  if ((int32_t)rate <= 0) return -6;

  size_t bytes_per = bits / 8;
  bool is_float = fmt_code == 3;
  if (fmt_code == 1) {
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return -3;
  } else if (is_float) {
    if (bits != 32 && bits != 64) return -3;
  } else {
    return -3;
  }
  if (bytes_per == 0) return -3;
  size_t frame = bytes_per * channels;
  size_t n_frames = data_len / frame;
  if (n_frames == 0) return -4;

  float* y = (float*)std::malloc(n_frames * sizeof(float));
  if (!y) return -1;
  const double inv_ch = 1.0 / (double)channels;
  bool finite = true;
  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    const uint8_t* fr = data + i * frame;
    for (unsigned ch = 0; ch < channels; ++ch) {
      const uint8_t* s = fr + ch * bytes_per;
      double v;
      if (is_float) {
        if (bits == 32) {
          float fv;
          std::memcpy(&fv, s, 4);
          v = fv;
        } else {
          double dv;
          std::memcpy(&dv, s, 8);
          v = dv;
        }
        if (!std::isfinite(v)) finite = false;
      } else if (bits == 16) {
        int16_t iv;
        std::memcpy(&iv, s, 2);
        v = iv / 32768.0;
      } else if (bits == 32) {
        int32_t iv;
        std::memcpy(&iv, s, 4);
        v = iv / 2147483648.0;
      } else if (bits == 24) {
        // sign-extend; scipy surfaces 24-bit as int32 << 8, same scale
        int32_t iv = (int32_t)((uint32_t)s[0] << 8 | (uint32_t)s[1] << 16 |
                               (uint32_t)s[2] << 24);
        v = iv / 2147483648.0;
      } else {  // 8-bit unsigned
        v = ((double)s[0] - 128.0) / 128.0;
      }
      acc += v;
    }
    y[i] = (float)(acc * inv_ch);
  }
  if (!finite) { std::free(y); return -5; }
  *out = y;
  *sr_out = (int)rate;
  return (long long)n_frames;
}

// Polyphase resample matching scipy.signal.resample_poly(x, up, down)
// with the default ('kaiser', 5.0) window: half_len = 10*max(up,down),
// h = firwin(2*half_len+1, 1/max(up,down), kaiser 5.0) * up, upfirdn,
// n_out = ceil(len(x)*up/down), group-delay-trimmed. float64 throughout
// (scipy upcasts too), result cast to float32.
// Returns n_out and mallocs *out, or -1 (alloc) / -7 (ratio too extreme,
// same 65536 bound as the Python guard).
long long wd_resample_poly(const float* x, long long n, int up, int down,
                           float** out) {
  if (up <= 0 || down <= 0 || n <= 0) return -7;
  long long mx = up > down ? up : down;
  if (mx > 65536) return -7;
  if (up == down) {
    float* y = (float*)std::malloc((size_t)n * sizeof(float));
    if (!y) return -1;
    std::memcpy(y, x, (size_t)n * sizeof(float));
    *out = y;
    return n;
  }
  const long long half_len = 10 * mx;
  const long long ntaps = 2 * half_len + 1;
  // firwin(ntaps, fc, kaiser beta=5.0), fc in Nyquist units = 1/mx:
  // h[k] = sinc(fc*(k-half_len)) * fc * kaiser[k], normalized to DC gain 1
  std::vector<double> h((size_t)ntaps);
  const double fc = 1.0 / (double)mx;
  const double beta = 5.0;
  const double i0b = kaiser_i0(beta);
  double dc = 0.0;
  for (long long k = 0; k < ntaps; ++k) {
    double m = (double)(k - half_len);
    double s = m == 0.0 ? fc : std::sin(M_PI * fc * m) / (M_PI * m);
    double r = 2.0 * (double)k / (double)(ntaps - 1) - 1.0;
    double w = kaiser_i0(beta * std::sqrt(std::fmax(0.0, 1.0 - r * r))) / i0b;
    h[(size_t)k] = s * w;
    dc += h[(size_t)k];
  }
  for (auto& v : h) v = v / dc * (double)up;

  // upfirdn with scipy's padding/trim: output sample t (0-based, after
  // removing the group delay) reads y_full[t*down + half_len] of the
  // zero-stuffed convolution — equivalently a polyphase dot product.
  long long n_out = (n * (long long)up + down - 1) / down;
  float* y = (float*)std::malloc((size_t)n_out * sizeof(float));
  if (!y) return -1;
  for (long long t = 0; t < n_out; ++t) {
    // position in the up-sampled stream whose filter output we want
    long long pos = t * (long long)down + half_len;
    // x[j] sits at up-sampled index j*up; tap index = pos - j*up
    long long j_hi = pos / up;              // largest j with tap >= 0
    long long j_lo = (pos - (ntaps - 1) + up - 1) / up;  // smallest j, tap < ntaps
    if (j_lo < 0) j_lo = 0;
    if (j_hi > n - 1) j_hi = n - 1;
    double acc = 0.0;
    for (long long j = j_lo; j <= j_hi; ++j) {
      acc += (double)x[j] * h[(size_t)(pos - j * up)];
    }
    y[t] = (float)acc;
  }
  *out = y;
  return n_out;
}

void wd_free(float* p) { std::free(p); }

}  // extern "C"
