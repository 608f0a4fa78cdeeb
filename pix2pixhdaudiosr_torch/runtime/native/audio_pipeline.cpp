// Copied from pix2pixhdaudiosr_tpu/runtime/native/audio_pipeline.cpp
// (the port loads no file of that package), with one addition: the
// OpenMP team size of each call, native_audio_set_threads below.
//
// Native host-side audio pipeline: WAV PCM decode + polyphase sinc resample
// + segment assembly, OpenMP-parallel over batch items.
//
// Role: the TPU-native equivalent of the reference's native layer. The
// reference spends its C++/CUDA on DCT kernels (reference dct/src/*) because
// its transforms run on the GPU hot path; on TPU those transforms are XLA/MXU
// matmuls (see ops/dct.py), and the native-code hot spot moves to the HOST
// input pipeline that must keep a chip fed at batch 64 (the reference leans
// on torchaudio's C++ decoders + 16 worker processes, reference
// data/audio_dataset.py:30-58, data/custom_dataset_data_loader.py:43-62).
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// OpenMP team size for the parallel regions of every entry point below, set
// on the calling thread as each call starts: 0 keeps the runtime's default.
static int g_threads = 0;

void native_audio_set_threads(int32_t n) { g_threads = n > 0 ? n : 0; }

static void apply_threads() {
#ifdef _OPENMP
  if (g_threads > 0) omp_set_num_threads(g_threads);
#endif
}

// ---------------------------------------------------------------------------
// PCM decode: interleaved raw bytes -> float32 first channel.
// fmt: 1 = PCM int (bits 8/16/24/32), 3 = IEEE float (bits 32/64).
// Returns frames decoded, or -1 on unsupported format.
// ---------------------------------------------------------------------------
int64_t decode_pcm_first_channel(const uint8_t* raw, int64_t nbytes,
                                 int32_t fmt, int32_t bits, int32_t nch,
                                 float* out, int64_t out_cap) {
  apply_threads();
  if (nch <= 0) return -1;
  const int64_t bpf = (int64_t)nch * (bits / 8);
  if (bpf == 0) return -1;
  int64_t frames = nbytes / bpf;
  if (frames > out_cap) frames = out_cap;
  if (fmt == 1 && bits == 16) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i) {
      int16_t v;
      std::memcpy(&v, raw + i * bpf, 2);
      out[i] = (float)v / 32768.0f;
    }
  } else if (fmt == 1 && bits == 32) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i) {
      int32_t v;
      std::memcpy(&v, raw + i * bpf, 4);
      out[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt == 1 && bits == 24) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i) {
      const uint8_t* b = raw + i * bpf;
      int32_t v = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
      v = (v ^ 0x800000) - 0x800000;
      out[i] = (float)v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 8) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i)
      out[i] = ((float)raw[i * bpf] - 128.0f) / 128.0f;
  } else if (fmt == 3 && bits == 32) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i)
      std::memcpy(&out[i], raw + i * bpf, 4);
  } else if (fmt == 3 && bits == 64) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < frames; ++i) {
      double v;
      std::memcpy(&v, raw + i * bpf, 8);
      out[i] = (float)v;
    }
  } else {
    return -1;
  }
  return frames;
}

// ---------------------------------------------------------------------------
// Polyphase sinc resample, torchaudio-kernel convention (see
// ops/audio.py sinc_resample_kernel): output[j*q + i] = dot(kernel[i],
// x_padded[j*p : j*p + K]) with x padded by `width` left and `width + p`
// right. kernels: [q, K] row-major float64 from the Python side.
// Returns the number of output samples written (= ceil(n*q/p), clipped).
// ---------------------------------------------------------------------------
int64_t resample_poly_f32(const float* x, int64_t n, const double* kernels,
                          int64_t K, int64_t p, int64_t q, int64_t width,
                          float* out, int64_t out_cap) {
  apply_threads();
  const int64_t padded_len = n + width + width + p;
  const int64_t n_frames = (padded_len - K) / p + 1;
  int64_t target = (int64_t)std::ceil((double)n * (double)q / (double)p);
  if (target > out_cap) target = out_cap;

#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < n_frames; ++f) {
    const int64_t start = f * p - width;  // index into unpadded x
    for (int64_t i = 0; i < q; ++i) {
      const int64_t oi = f * q + i;
      if (oi >= target) continue;
      const double* k = kernels + i * K;
      double acc = 0.0;
      int64_t lo = start < 0 ? -start : 0;           // clip to valid x range
      int64_t hi = (start + K > n) ? (n - start) : K;
      for (int64_t t = lo; t < hi; ++t) acc += (double)x[start + t] * k[t];
      out[oi] = (float)acc;
    }
  }
  return target;
}

// ---------------------------------------------------------------------------
// Fused batch op: for each item, resample orig->hr and orig->lr->hr and
// crop/zero-pad both to segment_length (the whole AudioDataset.__getitem__
// compute, reference data/audio_dataset.py:56-62, parallel over the batch).
// All kernel banks are passed in from Python.
// ---------------------------------------------------------------------------
void make_pair_batch(const float* wavs, const int64_t* lens, int64_t batch,
                     int64_t max_len, int64_t segment_length,
                     // orig -> hr
                     const double* k_hr, int64_t K_hr, int64_t p_hr,
                     int64_t q_hr, int64_t w_hr,
                     // orig -> lr
                     const double* k_dn, int64_t K_dn, int64_t p_dn,
                     int64_t q_dn, int64_t w_dn,
                     // lr -> hr
                     const double* k_up, int64_t K_up, int64_t p_up,
                     int64_t q_up, int64_t w_up,
                     float* hr_out, float* lr_out) {
  apply_threads();
#pragma omp parallel
  {
    std::vector<float> tmp_lo;
    std::vector<float> tmp;
#pragma omp for schedule(dynamic)
    for (int64_t b = 0; b < batch; ++b) {
      const float* x = wavs + b * max_len;
      const int64_t n = lens[b];
      float* hr = hr_out + b * segment_length;
      float* lr = lr_out + b * segment_length;
      // hr path
      int64_t hr_len = (int64_t)std::ceil((double)n * q_hr / p_hr);
      tmp.assign((size_t)hr_len, 0.0f);
      if (p_hr == q_hr && K_hr == 0) {
        hr_len = n;
        tmp.assign(x, x + n);
      } else {
        hr_len = resample_poly_f32(x, n, k_hr, K_hr, p_hr, q_hr, w_hr,
                                   tmp.data(), hr_len);
      }
      for (int64_t i = 0; i < segment_length; ++i)
        hr[i] = i < hr_len ? tmp[i] : 0.0f;
      // lr path: down then up
      int64_t lo_len = (int64_t)std::ceil((double)n * q_dn / p_dn);
      tmp_lo.assign((size_t)lo_len, 0.0f);
      lo_len = resample_poly_f32(x, n, k_dn, K_dn, p_dn, q_dn, w_dn,
                                 tmp_lo.data(), lo_len);
      int64_t up_len = (int64_t)std::ceil((double)lo_len * q_up / p_up);
      tmp.assign((size_t)up_len, 0.0f);
      up_len = resample_poly_f32(tmp_lo.data(), lo_len, k_up, K_up, p_up,
                                 q_up, w_up, tmp.data(), up_len);
      for (int64_t i = 0; i < segment_length; ++i)
        lr[i] = i < up_len ? tmp[i] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// FLAC decode (self-contained; mirrors the Python reference decoder in
// data/flac.py, which is the oracle for its tests). Supports constant /
// verbatim / fixed / LPC subframes, 4- and 5-bit Rice partitions with
// escapes, wasted bits, all stereo decorrelation modes, 8-32 bit depths.
// Sequential bitstream -> single-threaded; ~2 orders of magnitude faster
// than the Python fallback, which is what keeps a chip fed when the corpus
// (VCTK 0.92 / HiFi-TTS) ships as .flac.
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* buf;
  int64_t nbytes;
  int64_t pos = 0;  // bit position
  bool fail = false;

  uint64_t read(int n) {
    if ((pos + n + 7) / 8 > nbytes) { fail = true; return 0; }
    uint64_t v = 0;
    int64_t p = pos;
    pos += n;
    while (n > 0) {
      int rem = 8 - (int)(p & 7);
      int take = n < rem ? n : rem;
      uint8_t byte = buf[p >> 3];
      uint8_t window = (uint8_t)(byte >> (rem - take)) & (uint8_t)((1u << take) - 1);
      v = (v << take) | window;
      p += take;
      n -= take;
    }
    return v;
  }
  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n < 64 && (v >> (n - 1)))
      return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }
  int64_t unary() {
    int64_t q = 0;
    while (true) {
      if ((pos >> 3) >= nbytes) { fail = true; return 0; }
      uint8_t byte = buf[pos >> 3];
      int rem = 8 - (int)(pos & 7);
      uint8_t window = byte & (uint8_t)((1u << rem) - 1);
      if (window) {
        int bl = 0;  // bit_length of window
        for (int t = window; t; t >>= 1) bl++;
        int lead = rem - bl;
        pos += lead + 1;
        return q + lead;
      }
      q += rem;
      pos += rem;
    }
  }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
};

static const int kFixedOrders[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

static bool decode_residual(BitReader& br, int64_t blocksize, int order,
                            int64_t* res) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  uint64_t escape = (1u << pbits) - 1;
  int po = (int)br.read(4);
  int64_t nparts = (int64_t)1 << po;
  int64_t psize = blocksize >> po;
  int64_t idx = 0;
  for (int64_t part = 0; part < nparts; ++part) {
    int64_t n = part == 0 ? psize - order : psize;
    uint64_t param = br.read(pbits);
    if (param == escape) {
      int raw = (int)br.read(5);
      for (int64_t i = 0; i < n; ++i)
        res[idx + i] = raw ? br.read_signed(raw) : 0;
      idx += n;
    } else {
      for (int64_t i = 0; i < n; ++i) {
        int64_t q = br.unary();
        uint64_t v = ((uint64_t)q << param) | (param ? br.read((int)param) : 0);
        res[idx + i] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
      idx += n;
    }
    if (br.fail) return false;
  }
  return true;
}

static bool decode_subframe(BitReader& br, int64_t blocksize, int bps,
                            int64_t* out, std::vector<int64_t>& scratch) {
  if (br.read(1)) return false;
  int stype = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = (int)br.unary() + 1;
  bps -= wasted;
  if (stype == 0) {
    int64_t v = br.read_signed(bps);
    for (int64_t i = 0; i < blocksize; ++i) out[i] = v;
  } else if (stype == 1) {
    for (int64_t i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (stype >= 8 && stype <= 12) {
    int order = stype & 7;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    scratch.resize((size_t)(blocksize - order));
    if (!decode_residual(br, blocksize, order, scratch.data())) return false;
    const int* c = kFixedOrders[order];
    for (int64_t i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += (int64_t)c[j] * out[i - 1 - j];
      out[i] = p + scratch[(size_t)(i - order)];
    }
  } else if (stype >= 32) {
    int order = (stype & 31) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int prec = (int)br.read(4) + 1;
    if (prec == 16) return false;
    int shift = (int)br.read_signed(5);
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(prec);
    scratch.resize((size_t)(blocksize - order));
    if (!decode_residual(br, blocksize, order, scratch.data())) return false;
    for (int64_t i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += coefs[j] * out[i - 1 - j];
      out[i] = (p >> shift) + scratch[(size_t)(i - order)];
    }
  } else {
    return false;
  }
  if (wasted)
    for (int64_t i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return !br.fail;
}

static int64_t utf8_number(BitReader& br) {
  uint64_t b0 = br.read(8);
  if (b0 < 0x80) return (int64_t)b0;
  int n = 0;
  uint64_t mask = 0x40;
  while (b0 & mask) { n++; mask >>= 1; }
  uint64_t val = b0 & (mask - 1);
  for (int i = 0; i < n; ++i) val = (val << 6) | (br.read(8) & 0x3F);
  return (int64_t)val;
}

static const int kBlocksize[16] = {0,   192,  576,  1152, 2304, 4608, -8, -16,
                                   256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const int kSampleSize[8] = {0, 8, 12, 0, 16, 20, 24, 32};

}  // namespace flac

// Decode a full FLAC stream; writes interleaved [frames, nch] float32.
// Returns frames decoded, -1 on parse error / unexpected channel count.
int64_t flac_decode(const uint8_t* buf, int64_t nbytes, float* out,
                    int64_t out_cap_frames, int32_t nch_expected) {
  using namespace flac;
  if (nbytes < 42 || memcmp(buf, "fLaC", 4) != 0) return -1;
  int64_t off = 4;
  int stream_bps = 0, nch = 0;
  int64_t total = 0;
  while (off + 4 <= nbytes) {
    int last = buf[off] >> 7, btype = buf[off] & 0x7F;
    int64_t size = ((int64_t)buf[off + 1] << 16) | ((int64_t)buf[off + 2] << 8)
                   | buf[off + 3];
    const uint8_t* body = buf + off + 4;
    if (btype == 0 && size >= 34) {
      nch = ((body[12] >> 1) & 0x7) + 1;
      stream_bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1;
      total = ((int64_t)(body[13] & 0x0F) << 32) | ((int64_t)body[14] << 24)
              | ((int64_t)body[15] << 16) | ((int64_t)body[16] << 8) | body[17];
    }
    off += 4 + size;
    if (last) break;
  }
  if (nch == 0 || nch != nch_expected) return -1;

  BitReader br{buf, nbytes};
  br.pos = off * 8;
  std::vector<std::vector<int64_t>> ch((size_t)nch);
  std::vector<int64_t> scratch;
  int64_t written = 0;
  const float scale = 1.0f / (float)((int64_t)1 << (stream_bps - 1));
  while ((br.pos >> 3) < nbytes && (total == 0 || written < total)) {
    if (br.read(14) != 0x3FFE) break;  // trailing garbage / done
    br.read(1);
    br.read(1);  // blocking strategy (frame start index handled by order)
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int ch_code = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    utf8_number(br);
    int64_t blocksize;
    if (bs_code == 6) blocksize = (int64_t)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int64_t)br.read(16) + 1;
    else blocksize = kBlocksize[bs_code];
    if (blocksize <= 0) return -1;
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    br.read(8);  // header crc
    int bps = ss_code == 0 ? stream_bps : kSampleSize[ss_code];
    for (auto& c : ch) c.resize((size_t)blocksize);

    if (ch_code < 8) {
      if (ch_code + 1 != nch) return -1;
      for (int c = 0; c < nch; ++c)
        if (!decode_subframe(br, blocksize, bps, ch[(size_t)c].data(), scratch))
          return -1;
    } else if (nch == 2 && ch_code == 8) {  // left-side
      if (!decode_subframe(br, blocksize, bps, ch[0].data(), scratch) ||
          !decode_subframe(br, blocksize, bps + 1, ch[1].data(), scratch))
        return -1;
      for (int64_t i = 0; i < blocksize; ++i) ch[1][(size_t)i] = ch[0][(size_t)i] - ch[1][(size_t)i];
    } else if (nch == 2 && ch_code == 9) {  // right-side (side, right)
      if (!decode_subframe(br, blocksize, bps + 1, ch[0].data(), scratch) ||
          !decode_subframe(br, blocksize, bps, ch[1].data(), scratch))
        return -1;
      for (int64_t i = 0; i < blocksize; ++i) ch[0][(size_t)i] += ch[1][(size_t)i];
    } else if (nch == 2 && ch_code == 10) {  // mid-side
      if (!decode_subframe(br, blocksize, bps, ch[0].data(), scratch) ||
          !decode_subframe(br, blocksize, bps + 1, ch[1].data(), scratch))
        return -1;
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][(size_t)i], side = ch[1][(size_t)i];
        int64_t lrsum = (mid << 1) | (side & 1);
        int64_t left = (lrsum + side) >> 1;
        ch[0][(size_t)i] = left;
        ch[1][(size_t)i] = left - side;
      }
    } else {
      return -1;
    }
    br.align();
    br.read(16);  // frame crc
    if (br.fail) return -1;
    int64_t n = blocksize;
    if (written + n > out_cap_frames) n = out_cap_frames - written;
    for (int64_t i = 0; i < n; ++i)
      for (int c = 0; c < nch; ++c)
        out[(written + i) * nch + c] = (float)ch[(size_t)c][(size_t)i] * scale;
    written += n;
    if (written >= out_cap_frames) break;
  }
  return written;
}

int32_t native_audio_version() { return 2; }

}  // extern "C"
