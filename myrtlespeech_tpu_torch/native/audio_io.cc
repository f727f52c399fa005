// Native audio IO: parallel WAV batch decode straight into the padded
// collate buffer.
//
// TPU-native counterpart of the reference's C++ DataLoader worker core
// (SURVEY.md §2.10 N6: torch's multi-process DataLoader + sox/torchaudio
// decode).  Python-level decode (stdlib `wave` + numpy) costs one
// interpreter round-trip per file and an extra copy per sample; here one
// ctypes call decodes a whole batch with OpenMP threads and writes float32
// frames directly into the caller-allocated (B, max_samples) buffer — the
// host stays off the critical path between device steps.
//
// Format support mirrors data/dataset/librispeech.py::_read_wav: RIFF/WAVE
// with PCM16, PCM32 or IEEE float32 samples (plus WAVE_FORMAT_EXTENSIBLE
// wrappers), any channel count (averaged to mono).
//
// ABI (ctypes):
//   wav_info(path, *n_samples, *sample_rate) -> 0 ok / <0 error code
//   wav_read_batch(paths, n, out, max_samples, lengths, rates)
//     -> -1 ok / index of first failing file
//
// Built at first use by native/__init__.py (make -C myrtlespeech_tpu_torch/native).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrOpen = -2;
constexpr int kErrParse = -3;
constexpr int kErrFormat = -4;
constexpr int kErrTooLong = -5;

struct WavMeta {
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_off = 0;
  uint32_t data_bytes = 0;
};

uint32_t rd32(const unsigned char* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd16(const unsigned char* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Walk the RIFF chunk list; fill meta.  Returns 0 or an error code.
int parse_wav(FILE* f, WavMeta* m) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return kErrParse;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return kErrParse;
  bool have_fmt = false;
  while (true) {
    unsigned char ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    const uint32_t size = rd32(ch + 4);
    if (memcmp(ch, "fmt ", 4) == 0) {
      unsigned char buf[40];
      const uint32_t take = size < sizeof(buf) ? size : sizeof(buf);
      if (fread(buf, 1, take, f) != take) return kErrParse;
      if (take < 16) return kErrParse;
      m->format = rd16(buf);
      m->channels = rd16(buf + 2);
      m->sample_rate = rd32(buf + 4);
      m->bits = rd16(buf + 14);
      if (m->format == 0xFFFE && take >= 26) {
        m->format = rd16(buf + 24);  // first 2 bytes of the SubFormat GUID
      }
      if (size > take && fseek(f, size - take, SEEK_CUR) != 0)
        return kErrParse;
      have_fmt = true;
    } else if (memcmp(ch, "data", 4) == 0) {
      m->data_off = ftell(f);
      m->data_bytes = size;
      if (fseek(f, (size + 1) & ~1u, SEEK_CUR) != 0) break;  // padded
    } else {
      if (fseek(f, (size + 1) & ~1u, SEEK_CUR) != 0) break;
    }
    if (have_fmt && m->data_off) break;
  }
  if (!have_fmt || !m->data_off) return kErrParse;
  const bool pcm_ok = m->format == 1 && (m->bits == 16 || m->bits == 32);
  const bool flt_ok = m->format == 3 && m->bits == 32;
  if (!(pcm_ok || flt_ok) || m->channels == 0) return kErrFormat;
  return 0;
}

// Decode one file into out[0:max_samples]; *len_out = frame count.
int read_one(const char* path, float* out, int64_t max_samples,
             int32_t* len_out, int32_t* rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavMeta m;
  int rc = parse_wav(f, &m);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  const int bytes_per = m.bits / 8;
  const int64_t frames = m.data_bytes / (bytes_per * m.channels);
  if (frames > max_samples) {
    fclose(f);
    return kErrTooLong;
  }
  std::vector<unsigned char> raw(m.data_bytes);
  if (fseek(f, m.data_off, SEEK_SET) != 0 ||
      fread(raw.data(), 1, m.data_bytes, f) != m.data_bytes) {
    fclose(f);
    return kErrParse;
  }
  fclose(f);

  const int C = m.channels;
  const float inv_c = 1.0f / static_cast<float>(C);
  if (m.format == 1 && m.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += static_cast<float>(s[i * C + c]);
      out[i] = acc * inv_c * k;
    }
  } else if (m.format == 1 && m.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(raw.data());
    constexpr double k = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < C; ++c) acc += static_cast<double>(s[i * C + c]);
      out[i] = static_cast<float>(acc * inv_c * k);
    }
  } else {  // IEEE float32
    const float* s = reinterpret_cast<const float*>(raw.data());
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += s[i * C + c];
      out[i] = acc * inv_c;
    }
  }
  *len_out = static_cast<int32_t>(frames);
  *rate_out = static_cast<int32_t>(m.sample_rate);
  return 0;
}

}  // namespace

extern "C" {

// Header-only metadata (fast corpus indexing without decoding).
int wav_info(const char* path, int64_t* n_samples, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavMeta m;
  const int rc = parse_wav(f, &m);
  fclose(f);
  if (rc != 0) return rc;
  *n_samples = m.data_bytes / ((m.bits / 8) * m.channels);
  *sample_rate = static_cast<int32_t>(m.sample_rate);
  return 0;
}

// Decode n files in parallel into out (n, max_samples) float32 (caller
// zero-initialises for padding).  lengths/rates: (n,) int32.  Returns -1
// on success or the index of the first failing file (its slot's length
// is the negative error code).
int64_t wav_read_batch(const char** paths, int64_t n, float* out,
                       int64_t max_samples, int32_t* lengths,
                       int32_t* rates) {
  int64_t failed = -1;
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n; ++i) {
    const int rc = read_one(paths[i], out + i * max_samples, max_samples,
                            lengths + i, rates + i);
    if (rc != 0) {
      lengths[i] = rc;
#pragma omp critical
      { failed = (failed == -1 || i < failed) ? i : failed; }
    }
  }
  return failed;
}

}  // extern "C"
