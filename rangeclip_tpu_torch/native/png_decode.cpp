// Minimal PNG decoder for the dataset hot path (zlib inflate + unfilter), a
// copy of rangeclip_tpu/native/png_decode.cpp.
//
// PIL's decoder holds the Python GIL and measures ~22 ms of the ~26 ms
// per-sample load at 480x640 (three PNGs: RGB image, 16-bit depth, 16-bit
// labels).  This decoder handles exactly the subset the datasets produce —
// 8-bit grayscale/RGB and 16-bit grayscale, non-interlaced (the PNG output
// of PIL 'RGB'/'I' saves and of SUN RGB-D / NYUv2 assets) — and returns
// byte-identical pixels to PIL; every other shape (palette, alpha,
// interlaced) reports unsupported and the Python caller falls back to PIL.
//
// API (ctypes; all return 0 on success, <0 on error/unsupported):
//   png_header(path, &w, &h, &channels, &bit_depth)
//   png_decode(path, out, out_size)   -- out receives row-major samples,
//     uint8 for bit depth 8, host-endian uint16 for bit depth 16.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr int ERR_IO = -1;
constexpr int ERR_FORMAT = -2;
constexpr int ERR_UNSUPPORTED = -3;
constexpr int ERR_ZLIB = -4;
constexpr int ERR_SIZE = -5;

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, channels = 0;
};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int read_file(const char* path, std::vector<unsigned char>& buf,
              long max_bytes = 0) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_IO;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return ERR_IO;
  }
  if (max_bytes > 0 && n > max_bytes) n = max_bytes;
  buf.resize(size_t(n));
  size_t got = std::fread(buf.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n) ? 0 : ERR_IO;
}

// Parse IHDR; optionally collect the concatenated IDAT stream.
int parse(const std::vector<unsigned char>& buf, PngInfo* info,
          std::vector<unsigned char>* idat) {
  static const unsigned char kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 + 25 || std::memcmp(buf.data(), kSig, 8) != 0)
    return ERR_FORMAT;
  size_t pos = 8;
  bool have_ihdr = false;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return ERR_FORMAT;
    const unsigned char* type = &buf[pos + 4];
    const unsigned char* data = &buf[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return ERR_FORMAT;
      info->width = be32(data);
      info->height = be32(data + 4);
      info->bit_depth = data[8];
      info->color_type = data[9];
      int compression = data[10], filter = data[11], interlace = data[12];
      if (compression != 0 || filter != 0) return ERR_FORMAT;
      if (interlace != 0) return ERR_UNSUPPORTED;  // Adam7 -> PIL
      switch (info->color_type) {
        case 0: info->channels = 1; break;  // grayscale
        case 2: info->channels = 3; break;  // RGB
        default: return ERR_UNSUPPORTED;    // palette/alpha -> PIL
      }
      if (info->bit_depth != 8 && info->bit_depth != 16)
        return ERR_UNSUPPORTED;
      if (info->width == 0 || info->height == 0) return ERR_FORMAT;
      // Bound dimensions: corrupt IHDRs otherwise drive a multi-GB
      // std::vector allocation whose bad_alloc would escape the C ABI and
      // terminate the loader process (the contract is "error code ->
      // caller falls back to PIL").  2^15 per side covers every real
      // dataset image and caps raw buffers at ~6 GB/2 = well under
      // allocator limits; the int casts downstream also stay exact.
      if (info->width > 32768 || info->height > 32768) return ERR_UNSUPPORTED;
      have_ihdr = true;
      if (!idat) return 0;  // header-only parse stops here
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!have_ihdr) return ERR_FORMAT;
      if (idat) idat->insert(idat->end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;  // len + type + crc
  }
  if (!have_ihdr) return ERR_FORMAT;
  if (idat && idat->empty()) return ERR_FORMAT;
  return 0;
}

inline unsigned char paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (unsigned char)a;
  if (pb <= pc) return (unsigned char)b;
  return (unsigned char)c;
}

}  // namespace

extern "C" {

int png_header(const char* path, int* w, int* h, int* channels,
               int* bit_depth) {
  // IHDR is required to be the first chunk (signature 8 + chunk header 8 +
  // 13 data + 4 crc = 33 bytes); a 64-byte prefix is plenty — the hot path
  // must not slurp the whole file twice, and non-PNG inputs (JPEG
  // datasets) bail after one tiny read.
  std::vector<unsigned char> buf;
  int rc = read_file(path, buf, 64);
  if (rc) return rc;
  PngInfo info;
  rc = parse(buf, &info, nullptr);
  if (rc) return rc;
  *w = int(info.width);
  *h = int(info.height);
  *channels = info.channels;
  *bit_depth = info.bit_depth;
  return 0;
}

static int png_decode_impl(const char* path, unsigned char* out,
                           long out_size) {
  std::vector<unsigned char> buf;
  int rc = read_file(path, buf);
  if (rc) return rc;
  PngInfo info;
  std::vector<unsigned char> idat;
  rc = parse(buf, &info, &idat);
  if (rc) return rc;

  const size_t bytes_per_sample = info.bit_depth / 8;
  const size_t bpp = size_t(info.channels) * bytes_per_sample;  // per pixel
  const size_t stride = size_t(info.width) * bpp;               // per row
  const size_t raw_size = (stride + 1) * size_t(info.height);
  if (long(stride * info.height) != out_size) return ERR_SIZE;

  std::vector<unsigned char> raw(raw_size);
  {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return ERR_ZLIB;
    zs.next_in = idat.data();
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw.size());
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END || zs.total_out != raw.size()) return ERR_ZLIB;
  }

  // Unfilter scanlines in place into `out`.
  const unsigned char* prev = nullptr;
  for (uint32_t y = 0; y < info.height; ++y) {
    const unsigned char* src = &raw[(stride + 1) * y];
    unsigned char filter = src[0];
    ++src;
    unsigned char* dst = out + stride * y;
    switch (filter) {
      case 0:  // None
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        std::memcpy(dst, src, bpp);
        for (size_t i = bpp; i < stride; ++i)
          dst[i] = (unsigned char)(src[i] + dst[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (size_t i = 0; i < stride; ++i)
            dst[i] = (unsigned char)(src[i] + prev[i]);
        else
          std::memcpy(dst, src, stride);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          dst[i] = (unsigned char)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = (unsigned char)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return ERR_FORMAT;
    }
    prev = dst;
  }

  // PNG 16-bit samples are big-endian; emit host (little-endian) uint16.
  if (info.bit_depth == 16) {
    for (size_t i = 0; i + 1 < stride * info.height; i += 2) {
      unsigned char hi = out[i];
      out[i] = out[i + 1];
      out[i + 1] = hi;
    }
  }
  return 0;
}

int png_decode(const char* path, unsigned char* out, long out_size) {
  // No C++ exception may cross the C ABI into ctypes (std::terminate):
  // a bad_alloc from the file/raw buffers becomes an error code and the
  // caller falls back to PIL.
  try {
    return png_decode_impl(path, out, out_size);
  } catch (...) {
    return ERR_IO;
  }
}

}  // extern "C"
