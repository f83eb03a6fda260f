// Native audio frontend: WAV codec + polyphase sinc resampler + overlap-add.
//
// Fills the role of the reference's native audio stack (librosa/soundfile/
// libsndfile — reference neutts/neutts.py:267, examples/basic_example.py:31)
// as a first-party C++ component. Exposed through a plain C ABI consumed via
// ctypes (neutts_tpu_torch/native/__init__.py); the NumPy implementation in
// neutts_tpu_torch/audio/io.py is the path taken where no compiler is present.
//
// Resampler: polyphase upfirdn with a Kaiser-windowed sinc low-pass, the same
// design as scipy.signal.resample_poly (half_len = 10*max(up,down), cutoff
// 1/max(up,down) in Nyquist units, kaiser beta parameterized) so both paths
// agree to float tolerance.
//
// Build: automatically on first use, with g++ -O3 -shared, into
// neutts_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

void ntpu_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// WAV
// ---------------------------------------------------------------------------

struct WavInfo {
  int sr;
  int channels;
  int64_t frames;
};

// Reads a RIFF/WAVE file: PCM 8/16/24/32-bit and IEEE float32.
// Returns 0 on success; *out is malloc'd interleaved float32 [frames*ch].
int ntpu_read_wav(const char *path, float **out, int64_t *frames,
                  int *channels, int *sr) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  auto fail = [&](int code) { fclose(f); return code; };

  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4)) return fail(-2);
  if (fread(&sz, 4, 1, f) != 1) return fail(-2);
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4)) return fail(-2);

  uint16_t fmt = 0, ch = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;

  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!memcmp(id, "fmt ", 4)) {
      std::vector<uint8_t> buf(sz);
      if (fread(buf.data(), 1, sz, f) != sz) return fail(-3);
      fmt = buf[0] | (buf[1] << 8);
      ch = buf[2] | (buf[3] << 8);
      rate = buf[4] | (buf[5] << 8) | (buf[6] << 16) | ((uint32_t)buf[7] << 24);
      bits = buf[14] | (buf[15] << 8);
      if (fmt == 0xFFFE && sz >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        fmt = buf[24] | (buf[25] << 8);
      }
      have_fmt = true;
    } else if (!memcmp(id, "data", 4)) {
      data.resize(sz);
      if (fread(data.data(), 1, sz, f) != sz) return fail(-4);
      have_data = true;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
      continue;
    }
    if (sz & 1) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!have_fmt || !have_data || ch == 0) return -5;

  const int bytes = bits / 8;
  const int64_t n = (int64_t)data.size() / (bytes * ch);
  float *buf = (float *)malloc(sizeof(float) * n * ch);
  if (!buf) return -6;

  const uint8_t *p = data.data();
  for (int64_t i = 0; i < n * ch; i++) {
    float v = 0.f;
    if (fmt == 3 && bits == 32) {  // IEEE float
      float fv;
      memcpy(&fv, p + i * 4, 4);
      v = fv;
    } else if (bits == 16) {
      int16_t s = (int16_t)(p[i * 2] | (p[i * 2 + 1] << 8));
      v = s / 32768.f;
    } else if (bits == 24) {
      int32_t s = p[i * 3] | (p[i * 3 + 1] << 8) | (p[i * 3 + 2] << 16);
      if (s >= (1 << 23)) s -= (1 << 24);
      v = s / 8388608.f;
    } else if (bits == 32) {
      int32_t s;
      memcpy(&s, p + i * 4, 4);
      v = s / 2147483648.f;
    } else if (bits == 8) {
      v = ((int)p[i] - 128) / 128.f;
    } else {
      free(buf);
      return -7;
    }
    buf[i] = v;
  }
  *out = buf;
  *frames = n;
  *channels = ch;
  *sr = (int)rate;
  return 0;
}

// Writes 16-bit PCM.
int ntpu_write_wav(const char *path, const float *data, int64_t frames,
                   int channels, int sr) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_sz = (uint32_t)(frames * channels * 2);
  const uint32_t riff_sz = 36 + data_sz;
  const uint16_t block = (uint16_t)(channels * 2);
  const uint32_t byterate = (uint32_t)sr * block;
  const uint16_t one = 1, ch16 = (uint16_t)channels, bits = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_sz, 4, 1, f);
  fwrite("WAVEfmt ", 1, 8, f);
  const uint32_t fmt_sz = 16;
  fwrite(&fmt_sz, 4, 1, f);
  fwrite(&one, 2, 1, f);
  fwrite(&ch16, 2, 1, f);
  const uint32_t sr32 = (uint32_t)sr;
  fwrite(&sr32, 4, 1, f);
  fwrite(&byterate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_sz, 4, 1, f);
  std::vector<int16_t> pcm(frames * channels);
  for (int64_t i = 0; i < frames * channels; i++) {
    float v = data[i] * 32767.f;
    if (v > 32767.f) v = 32767.f;
    if (v < -32768.f) v = -32768.f;
    pcm[i] = (int16_t)lrintf(v);
  }
  fwrite(pcm.data(), 2, pcm.size(), f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampler (scipy.signal.resample_poly design)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion; converges quickly for the beta range we use
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; k++) {
    term *= y / (k * (double)k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// firwin(numtaps, cutoff, window=('kaiser', beta)) with scale=True.
// cutoff in Nyquist-normalized units (1.0 = fs/2).
static void kaiser_sinc_filter(int numtaps, double cutoff, double beta,
                               std::vector<double> &h) {
  h.resize(numtaps);
  const double m = (numtaps - 1) / 2.0;
  const double i0b = bessel_i0(beta);
  double sum = 0.0;
  for (int i = 0; i < numtaps; i++) {
    const double t = i - m;
    const double sinc =
        (t == 0.0) ? cutoff : sin(M_PI * cutoff * t) / (M_PI * t);
    const double r = 2.0 * i / (numtaps - 1) - 1.0;
    const double w = bessel_i0(beta * sqrt(1.0 - r * r)) / i0b;
    h[i] = sinc * w;
  }
  // scale so the passband center (DC for low-pass) has unit gain
  for (int i = 0; i < numtaps; i++) sum += h[i];
  for (int i = 0; i < numtaps; i++) h[i] /= sum;
}

int64_t ntpu_resample_len(int64_t n, int sr_in, int sr_out) {
  const int64_t g = std::gcd((int64_t)sr_in, (int64_t)sr_out);
  const int64_t up = sr_out / g, down = sr_in / g;
  return (n * up + down - 1) / down;  // ceil, matches resample_poly
}

// Polyphase upfirdn with group-delay compensation, matching
// scipy.signal.resample_poly(x, up, down, window=('kaiser', beta)).
int ntpu_resample(const float *in, int64_t n, int sr_in, int sr_out,
                  double beta, float *out, int64_t out_cap) {
  if (sr_in == sr_out) {
    if (out_cap < n) return -1;
    memcpy(out, in, sizeof(float) * n);
    return 0;
  }
  const int64_t g = std::gcd((int64_t)sr_in, (int64_t)sr_out);
  const int64_t up = sr_out / g, down = sr_in / g;
  const int64_t n_out = ntpu_resample_len(n, sr_in, sr_out);
  if (out_cap < n_out) return -1;

  const int64_t max_rate = std::max(up, down);
  const double f_c = 1.0 / (double)max_rate;  // Nyquist units
  const int64_t half_len = 10 * max_rate;
  std::vector<double> h;
  kaiser_sinc_filter((int)(2 * half_len + 1), f_c, beta, h);
  for (auto &v : h) v *= (double)up;

  // y[m] = sum_k h[k] * x_up[m*down + half_len - k], where x_up is x with
  // (up-1) zeros between samples: x_up[j] = x[j/up] if j%up==0.
  const int64_t htaps = (int64_t)h.size();
  for (int64_t m = 0; m < n_out; m++) {
    const int64_t center = m * down + half_len;
    // j = center - k must satisfy j % up == 0, 0 <= j/up < n
    // k in [max(0, center-(n-1)*up), min(htaps-1, center)]
    double acc = 0.0;
    int64_t j0 = center % up;  // smallest k with (center-k)%up==0 is center%up
    for (int64_t k = j0; k < htaps && k <= center; k += up) {
      const int64_t j = (center - k) / up;
      if (j < n) acc += h[k] * (double)in[j];
    }
    out[m] = (float)acc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Overlap-add (triangular weights, reference neutts/neutts.py:46-70)
// ---------------------------------------------------------------------------

int ntpu_overlap_add(const float *frames, int n_frames, int64_t frame_len,
                     int64_t stride, float *out, int64_t out_cap) {
  const int64_t total = stride * (n_frames - 1) + frame_len;
  if (out_cap < total) return -1;
  std::vector<double> acc(total, 0.0), wsum(total, 0.0);
  std::vector<double> w(frame_len);
  for (int64_t t = 0; t < frame_len; t++) {
    const double x = (double)(t + 1) / (double)(frame_len + 1);
    w[t] = fabs(0.5 - (x - 0.5));
  }
  for (int i = 0; i < n_frames; i++) {
    const float *fr = frames + (int64_t)i * frame_len;
    const int64_t off = (int64_t)i * stride;
    for (int64_t t = 0; t < frame_len; t++) {
      acc[off + t] += w[t] * fr[t];
      wsum[off + t] += w[t];
    }
  }
  for (int64_t t = 0; t < total; t++)
    out[t] = (float)(wsum[t] > 0 ? acc[t] / wsum[t] : 0.0);
  return 0;
}

}  // extern "C"
