// Native audio IO for the data-loading hot path (the port's copy of
// speechbrain_tpu/io/_audioio.cpp).
//
// A dependency-free RIFF WAV decoder (unsigned 8-bit and signed
// 16/24/32-bit PCM, IEEE float32; WAVE_FORMAT_EXTENSIBLE with either
// subformat) exposed through a C ABI for ctypes. Calls release the Python
// GIL (ctypes does this), so the SaveableDataLoader's read-ahead threads
// decode files in parallel; the standard library's `wave` holds the GIL.
// Return codes: -1 the file does not open, -2 no RIFF/WAVE header with a
// fmt and a data chunk, -3 the output buffer is too small, -4 a sample
// format this decoder does not read.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (speechbrain_tpu_torch/io/
// native.py does it at first use, into speechbrain_tpu_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavMeta {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = -1;     // byte offset of sample data
  long data_bytes = 0;
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// Parse RIFF chunks up to (and including) locating the data chunk.
bool parse_header(FILE* f, WavMeta* meta) {
  char tag[4];
  uint32_t size;
  if (!read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4) != 0) return false;
  if (!read_exact(f, &size, 4)) return false;
  if (!read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4) != 0) return false;
  while (read_exact(f, tag, 4) && read_exact(f, &size, 4)) {
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t fmt[26];
      const uint32_t n = size < 26 ? size : 26;
      if (size < 16 || !read_exact(f, fmt, n)) return false;
      meta->format = fmt[0] | (fmt[1] << 8);
      meta->channels = fmt[2] | (fmt[3] << 8);
      meta->sample_rate =
          fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | ((uint32_t)fmt[7] << 24);
      meta->bits = fmt[14] | (fmt[15] << 8);
      // WAVE_FORMAT_EXTENSIBLE: the subformat GUID starts with the code
      if (meta->format == 0xFFFE && n >= 26) {
        meta->format = fmt[24] | (fmt[25] << 8);
      }
      const long skip = (long)(size - n) + (size & 1);
      if (skip > 0) fseek(f, skip, SEEK_CUR);
    } else if (memcmp(tag, "data", 4) == 0) {
      meta->data_offset = ftell(f);
      meta->data_bytes = size;
      return meta->format != 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// The encodings cvt_sample decodes.
bool readable(const WavMeta& m) {
  if (m.format == 3) return m.bits == 32;
  return m.format == 1 &&
         (m.bits == 8 || m.bits == 16 || m.bits == 24 || m.bits == 32);
}

inline float cvt_sample(const uint8_t* p, uint16_t bits, uint16_t format) {
  if (format == 3) {  // IEEE float32
    float v;
    memcpy(&v, p, 4);
    return v;
  }
  switch (bits) {
    case 16: {
      int16_t v = (int16_t)(p[0] | (p[1] << 8));
      return v / 32768.0f;
    }
    case 24: {
      int32_t v = (p[0] << 8) | (p[1] << 16) | ((int32_t)p[2] << 24);
      return (v >> 8) / 8388608.0f;
    }
    case 32: {
      int32_t v;
      memcpy(&v, p, 4);
      return v / 2147483648.0f;
    }
    case 8: {  // unsigned 8-bit PCM
      return (p[0] - 128) / 128.0f;
    }
    default:
      return 0.0f;
  }
}

}  // namespace

extern "C" {

// Frames / sample-rate / channels without decoding. Returns 0 on success.
int sbtpu_wav_info(const char* path, long* frames, int* sample_rate,
                   int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  bool ok = parse_header(f, &meta);
  fclose(f);
  if (!ok || meta.bits == 0 || meta.channels == 0) return -2;
  if (!readable(meta)) return -4;
  long bytes_per_frame = (meta.bits / 8) * meta.channels;
  *frames = meta.data_bytes / bytes_per_frame;
  *sample_rate = (int)meta.sample_rate;
  *channels = (int)meta.channels;
  return 0;
}

// Decode [start, stop) frames of a WAV file into interleaved float32.
// out must hold (stop-start)*channels floats. stop<0 means "to the end".
// Returns decoded frame count, or a negative error code.
long sbtpu_wav_decode(const char* path, long start, long stop, float* out,
                      long out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  if (!parse_header(f, &meta) || meta.bits == 0 || meta.channels == 0) {
    fclose(f);
    return -2;
  }
  if (!readable(meta)) {
    fclose(f);
    return -4;
  }
  const long bps = meta.bits / 8;
  const long frame_bytes = bps * meta.channels;
  const long total_frames = meta.data_bytes / frame_bytes;
  if (start < 0) start = 0;
  if (stop < 0 || stop > total_frames) stop = total_frames;
  if (stop <= start) {
    fclose(f);
    return 0;
  }
  const long n_frames = stop - start;
  const long n_samples = n_frames * meta.channels;
  if (n_samples > out_cap) {
    fclose(f);
    return -3;
  }
  fseek(f, meta.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<uint8_t> raw(n_frames * frame_bytes);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const long got_samples = (long)(got / bps);
  const uint8_t* p = raw.data();
  if (meta.format == 1 && meta.bits == 16) {
    // hot path: auto-vectorizable tight loop
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    constexpr float k = 1.0f / 32768.0f;
    for (long i = 0; i < got_samples; ++i) out[i] = s[i] * k;
  } else if (meta.format == 3 && meta.bits == 32) {
    memcpy(out, p, got_samples * 4);
  } else {
    for (long i = 0; i < got_samples; ++i, p += bps) {
      out[i] = cvt_sample(p, meta.bits, meta.format);
    }
  }
  return got_samples / meta.channels;
}

// Decode + downmix to mono in one pass (averaging channels).
long sbtpu_wav_decode_mono(const char* path, long start, long stop,
                           float* out, long out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  if (!parse_header(f, &meta) || meta.bits == 0 || meta.channels == 0) {
    fclose(f);
    return -2;
  }
  if (!readable(meta)) {
    fclose(f);
    return -4;
  }
  const long bps = meta.bits / 8;
  const int C = meta.channels;
  const long frame_bytes = bps * C;
  const long total_frames = meta.data_bytes / frame_bytes;
  if (start < 0) start = 0;
  if (stop < 0 || stop > total_frames) stop = total_frames;
  if (stop <= start) {
    fclose(f);
    return 0;
  }
  const long n_frames = stop - start;
  if (n_frames > out_cap) {
    fclose(f);
    return -3;
  }
  fseek(f, meta.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<uint8_t> raw(n_frames * frame_bytes);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const long got_frames = (long)(got / frame_bytes);
  const uint8_t* p = raw.data();
  const float inv_c = 1.0f / C;
  if (meta.format == 1 && meta.bits == 16 && C == 1) {
    // hot path: mono PCM16 (the overwhelmingly common corpus format)
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    constexpr float k = 1.0f / 32768.0f;
    for (long i = 0; i < got_frames; ++i) out[i] = s[i] * k;
  } else if (meta.format == 1 && meta.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    constexpr float k = 1.0f / 32768.0f;
    for (long i = 0; i < got_frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += s[i * C + c] * k;
      out[i] = acc * inv_c;
    }
  } else {
    for (long i = 0; i < got_frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c, p += bps) {
        acc += cvt_sample(p, meta.bits, meta.format);
      }
      out[i] = acc * inv_c;
    }
  }
  return got_frames;
}

}  // extern "C"
