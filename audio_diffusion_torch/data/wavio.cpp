// Native audio I/O for the PyTorch port's training data pipeline (a copy of
// the JAX package's audio_diffusion_tpu/data/wavio.cpp; only this comment
// differs).
//
// WAV decode (PCM16 / PCM24 / PCM32 / float32), random-crop extraction, and
// batched multi-file crop assembly, exposed through a C ABI consumed via
// ctypes (audio_diffusion_torch/data/loader.py). Decoding and crop assembly
// happen off the Python GIL so host-side input processing overlaps the GPU's
// compute.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libwavio.so wavio.cpp (the
// loader does this at first use, into audio_diffusion_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  uint64_t data_offset = 0;  // byte offset of sample data
  uint64_t data_bytes = 0;
};

bool read_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return false;

  // Walk chunks until fmt and data are both found.
  bool have_fmt = false, have_data = false;
  while (!(have_fmt && have_data)) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      if (size < 16) return false;  // malformed: PCM fmt needs >= 16 bytes
      uint8_t buf[40] = {0};
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) return false;
      if (size > n && fseek(f, size - n, SEEK_CUR) != 0) return false;
      memcpy(&info->format, buf + 0, 2);
      memcpy(&info->channels, buf + 2, 2);
      memcpy(&info->sample_rate, buf + 4, 4);
      memcpy(&info->bits, buf + 14, 2);
      if (info->format == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        memcpy(&info->format, buf + 24, 2);        // subformat GUID first 2B
      }
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = (uint64_t)ftell(f);
      info->data_bytes = size;
      have_data = true;
      if (fseek(f, (long)((size + 1) & ~1u), SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, (long)((size + 1) & ~1u), SEEK_CUR) != 0) break;
    }
  }
  if (!(have_fmt && have_data && info->channels > 0)) return false;
  // Admit only the combinations convert() can decode; anything else
  // (ADPCM, a-law, float64, bits < 8, ...) must fail at PROBE time, not
  // hours later mid-training — and bits < 8 would divide by zero in the
  // frame-count math.
  const bool pcm = info->format == 1 &&
      (info->bits == 16 || info->bits == 24 || info->bits == 32);
  const bool ieee = info->format == 3 && info->bits == 32;
  return pcm || ieee;
}

// Convert interleaved raw samples to planar float32 [channels, frames].
bool convert(const uint8_t* raw, const WavInfo& info, uint64_t start_frame,
             uint64_t num_frames, float* out) {
  const uint32_t c = info.channels;
  const uint32_t bytes_per = info.bits / 8;
  const uint8_t* p = raw + start_frame * c * bytes_per;
  for (uint64_t i = 0; i < num_frames; ++i) {
    for (uint32_t ch = 0; ch < c; ++ch) {
      const uint8_t* s = p + (i * c + ch) * bytes_per;
      float v;
      if (info.format == 3 && info.bits == 32) {
        memcpy(&v, s, 4);
      } else if (info.format == 1 && info.bits == 16) {
        int16_t x;
        memcpy(&x, s, 2);
        v = (float)x / 32768.0f;
      } else if (info.format == 1 && info.bits == 24) {
        int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                              ((uint32_t)s[2] << 16));
        if (x & 0x800000) x |= (int32_t)0xFF000000;  // sign-extend
        v = (float)x / 8388608.0f;
      } else if (info.format == 1 && info.bits == 32) {
        int32_t x;
        memcpy(&x, s, 4);
        v = (float)x / 2147483648.0f;
      } else {
        return false;
      }
      out[(uint64_t)ch * num_frames + i] = v;
    }
  }
  return true;
}

// Convert interleaved raw samples to planar int16 [channels, frames].
// PCM16 sources copy bits unchanged (lossless passthrough); wider formats
// quantize with round-half-away (matching wav_write's PCM16 quantizer).
bool convert_i16(const uint8_t* raw, const WavInfo& info,
                 uint64_t start_frame, uint64_t num_frames, int16_t* out) {
  const uint32_t c = info.channels;
  const uint32_t bytes_per = info.bits / 8;
  const uint8_t* p = raw + start_frame * c * bytes_per;
  if (info.format == 1 && info.bits == 16) {  // lossless deinterleave
    const int16_t* s = (const int16_t*)p;
    for (uint64_t i = 0; i < num_frames; ++i)
      for (uint32_t ch = 0; ch < c; ++ch)
        out[(uint64_t)ch * num_frames + i] = s[i * c + ch];
    return true;
  }
  for (uint64_t i = 0; i < num_frames; ++i) {
    for (uint32_t ch = 0; ch < c; ++ch) {
      const uint8_t* s = p + (i * c + ch) * bytes_per;
      float v;
      if (info.format == 3 && info.bits == 32) {
        memcpy(&v, s, 4);
      } else if (info.format == 1 && info.bits == 24) {
        int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                              ((uint32_t)s[2] << 16));
        if (x & 0x800000) x |= (int32_t)0xFF000000;
        v = (float)x / 8388608.0f;
      } else if (info.format == 1 && info.bits == 32) {
        int32_t x;
        memcpy(&x, s, 4);
        v = (float)x / 2147483648.0f;
      } else {
        return false;
      }
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      int32_t q = (int32_t)(v * 32767.0f + (v >= 0 ? 0.5f : -0.5f));
      out[(uint64_t)ch * num_frames + i] = (int16_t)q;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Probe a WAV file: fills channels/sample_rate/frames; returns 0 on success.
int wav_probe(const char* path, int32_t* channels, int32_t* sample_rate,
              int64_t* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = read_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  *channels = (int32_t)info.channels;
  *sample_rate = (int32_t)info.sample_rate;
  *frames = (int64_t)(info.data_bytes / (info.channels * (info.bits / 8)));
  return 0;
}

// Extended probe: also reports the sample format (1=PCM, 3=IEEE float) and
// bit depth, so callers can pick the lossless int16 passthrough path for
// PCM16 corpora. Returns 0 on success.
int wav_probe_ex(const char* path, int32_t* channels, int32_t* sample_rate,
                 int64_t* frames, int32_t* bits, int32_t* format) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = read_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  *channels = (int32_t)info.channels;
  *sample_rate = (int32_t)info.sample_rate;
  *frames = (int64_t)(info.data_bytes / (info.channels * (info.bits / 8)));
  *bits = (int32_t)info.bits;
  *format = (int32_t)info.format;
  return 0;
}

// Read [start, start+num_frames) into caller-allocated planar float32
// buffer `out` of size channels*num_frames. Returns 0 on success.
int wav_read(const char* path, int64_t start, int64_t num_frames,
             float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!read_header(f, &info)) { fclose(f); return -2; }
  const uint64_t total =
      info.data_bytes / (info.channels * (info.bits / 8));
  if (start < 0 || (uint64_t)(start + num_frames) > total) {
    fclose(f);
    return -3;
  }
  const uint64_t bytes =
      (uint64_t)num_frames * info.channels * (info.bits / 8);
  uint8_t* raw = (uint8_t*)malloc(bytes);
  if (!raw) { fclose(f); return -4; }
  if (fseek(f, (long)(info.data_offset +
                      (uint64_t)start * info.channels * (info.bits / 8)),
            SEEK_SET) != 0 ||
      fread(raw, 1, bytes, f) != bytes) {
    free(raw);
    fclose(f);
    return -5;
  }
  fclose(f);
  bool ok = convert(raw, info, 0, (uint64_t)num_frames, out);
  free(raw);
  return ok ? 0 : -6;
}

// Assemble a batch of random crops: for each i, read crop_frames samples
// from files[i] starting at starts[i] into out[i] (planar [c, crop]).
// All files must have `channels` channels. Returns 0, or -(i+1)*100-err.
int wav_read_batch(const char** paths, const int64_t* starts,
                   int32_t batch, int32_t channels, int64_t crop_frames,
                   float* out) {
  for (int32_t i = 0; i < batch; ++i) {
    int err = wav_read(paths[i], starts[i], crop_frames,
                       out + (uint64_t)i * channels * crop_frames);
    if (err != 0) return -(i + 1) * 100 + err;
  }
  return 0;
}

// int16 variant of wav_read: decodes [start, start+num_frames) to planar
// int16 [channels, frames]. For PCM16 files this is a lossless bit copy —
// the basis of the 4x-smaller host->device upload path (loader dtype=int16;
// the device dequantizes x/32768, reproducing wav_read's floats exactly).
int wav_read_i16(const char* path, int64_t start, int64_t num_frames,
                 int16_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!read_header(f, &info)) { fclose(f); return -2; }
  const uint64_t total =
      info.data_bytes / (info.channels * (info.bits / 8));
  if (start < 0 || (uint64_t)(start + num_frames) > total) {
    fclose(f);
    return -3;
  }
  const uint64_t bytes =
      (uint64_t)num_frames * info.channels * (info.bits / 8);
  uint8_t* raw = (uint8_t*)malloc(bytes);
  if (!raw) { fclose(f); return -4; }
  if (fseek(f, (long)(info.data_offset +
                      (uint64_t)start * info.channels * (info.bits / 8)),
            SEEK_SET) != 0 ||
      fread(raw, 1, bytes, f) != bytes) {
    free(raw);
    fclose(f);
    return -5;
  }
  fclose(f);
  bool ok = convert_i16(raw, info, 0, (uint64_t)num_frames, out);
  free(raw);
  return ok ? 0 : -6;
}

// Batched int16 crop assembly (see wav_read_batch).
int wav_read_batch_i16(const char** paths, const int64_t* starts,
                       int32_t batch, int32_t channels, int64_t crop_frames,
                       int16_t* out) {
  for (int32_t i = 0; i < batch; ++i) {
    int err = wav_read_i16(paths[i], starts[i], crop_frames,
                           out + (uint64_t)i * channels * crop_frames);
    if (err != 0) return -(i + 1) * 100 + err;
  }
  return 0;
}

// Write planar float32 [channels, frames] as a WAV file.
// bits: 16 (PCM16, values clipped to [-1, 1]) or 32 (IEEE float).
// Returns 0 on success.
int wav_write(const char* path, const float* data, int32_t channels,
              int64_t frames, int32_t sample_rate, int32_t bits) {
  if (channels <= 0 || frames < 0 || (bits != 16 && bits != 32)) return -7;
  // RIFF chunk sizes are uint32: refuse payloads the format cannot
  // represent instead of writing a wrapped (corrupt) header.
  if ((uint64_t)frames * channels * (bits / 8) > 0xFFFFFFFFull - 36)
    return -8;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t bytes_per = (uint32_t)bits / 8;
  const uint64_t data_bytes = (uint64_t)frames * channels * bytes_per;
  const uint16_t format = bits == 32 ? 3 : 1;  // IEEE float / PCM
  const uint32_t byte_rate = (uint32_t)sample_rate * channels * bytes_per;
  const uint16_t block_align = (uint16_t)(channels * bytes_per);
  const uint32_t riff_size = 36 + (uint32_t)data_bytes;

  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  memcpy(hdr + 4, &riff_size, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(hdr + 16, &fmt_size, 4);
  memcpy(hdr + 20, &format, 2);
  uint16_t ch16 = (uint16_t)channels;
  memcpy(hdr + 22, &ch16, 2);
  uint32_t sr = (uint32_t)sample_rate;
  memcpy(hdr + 24, &sr, 4);
  memcpy(hdr + 28, &byte_rate, 4);
  memcpy(hdr + 32, &block_align, 2);
  uint16_t b16 = (uint16_t)bits;
  memcpy(hdr + 34, &b16, 2);
  memcpy(hdr + 36, "data", 4);
  uint32_t db32 = (uint32_t)data_bytes;
  memcpy(hdr + 40, &db32, 4);
  if (fwrite(hdr, 1, 44, f) != 44) { fclose(f); return -5; }

  // Interleave (and quantize for PCM16) in chunks.
  const uint64_t CHUNK = 65536;  // frames per write
  uint8_t* buf = (uint8_t*)malloc(CHUNK * channels * bytes_per);
  if (!buf) { fclose(f); return -4; }
  for (uint64_t off = 0; off < (uint64_t)frames; off += CHUNK) {
    const uint64_t n =
        (uint64_t)frames - off < CHUNK ? (uint64_t)frames - off : CHUNK;
    for (uint64_t i = 0; i < n; ++i) {
      for (int32_t ch = 0; ch < channels; ++ch) {
        float v = data[(uint64_t)ch * frames + off + i];
        uint8_t* dst = buf + (i * channels + ch) * bytes_per;
        if (bits == 32) {
          memcpy(dst, &v, 4);
        } else {
          if (v > 1.0f) v = 1.0f;
          if (v < -1.0f) v = -1.0f;
          int32_t q = (int32_t)(v * 32767.0f + (v >= 0 ? 0.5f : -0.5f));
          int16_t x = (int16_t)q;
          memcpy(dst, &x, 2);
        }
      }
    }
    if (fwrite(buf, 1, n * channels * bytes_per, f) !=
        n * channels * bytes_per) {
      free(buf);
      fclose(f);
      return -5;
    }
  }
  free(buf);
  return fclose(f) == 0 ? 0 : -5;
}

}  // extern "C"
