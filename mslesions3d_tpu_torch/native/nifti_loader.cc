// Native NIfTI-1 loader for the host data path of mslesions3d_tpu_torch.
//
// One C call does gzip inflate -> header parse -> Fortran->C transpose ->
// fp32 cast -> (optional) nonzero intensity normalization, per channel for
// 4-D volumes, writing straight into a caller-provided buffer (no
// Python-side copies). The inflated bytes of the last file read are kept
// per thread, keyed by path, mtime and size, so a file rewritten in place is
// never served stale. The same source as the JAX package's loader
// (mslesions3d_tpu/native/nifti_loader.cc), so the two decode bit for bit.
//
// Exposed through a plain C interface (msl_nifti_shape, msl_nifti_shape4,
// msl_nifti_load) and loaded with ctypes (native.py), which builds it at
// first use: g++ -O3 -shared -fPIC nifti_loader.cc -lz.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <sys/stat.h>
#include <zlib.h>

namespace {

constexpr int kHeaderSize = 348;

struct Header {
  int ndim = 0;
  int shape[7] = {1, 1, 1, 1, 1, 1, 1};
  int16_t datatype = 0;
  float pixdim[7] = {1, 1, 1, 1, 1, 1, 1};
  int vox_offset = 0;
  float scl_slope = 1.0f;
  float scl_inter = 0.0f;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

// Streaming gzip inflate with geometric growth.
bool gunzip(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
  out->resize(in.size() * 6 + (1 << 20));
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  size_t written = 0;
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (written == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + written;
    zs.avail_out = static_cast<uInt>(out->size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    written = out->size() - zs.avail_out;
  }
  out->resize(written);
  inflateEnd(&zs);
  return true;
}

bool parse_header(const uint8_t* raw, size_t size, Header* h) {
  if (size < static_cast<size_t>(kHeaderSize)) return false;
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, raw, 4);
  if (sizeof_hdr != kHeaderSize) return false;  // (big-endian unsupported)
  int16_t dim[8];
  std::memcpy(dim, raw + 40, 16);
  h->ndim = dim[0];
  if (h->ndim < 1 || h->ndim > 7) return false;
  for (int i = 0; i < h->ndim; ++i) h->shape[i] = dim[i + 1];
  std::memcpy(&h->datatype, raw + 70, 2);
  float pixdim[8];
  std::memcpy(pixdim, raw + 76, 32);
  for (int i = 0; i < 7; ++i) h->pixdim[i] = pixdim[i + 1];
  float vox_offset;
  std::memcpy(&vox_offset, raw + 108, 4);
  h->vox_offset = static_cast<int>(vox_offset);
  std::memcpy(&h->scl_slope, raw + 112, 4);
  std::memcpy(&h->scl_inter, raw + 116, 4);
  return true;
}

template <typename T>
void to_f32_c_order(const uint8_t* data, const Header& h, float* out,
                    int n_channels = 1, int channel = 0) {
  // NIfTI stores Fortran order (axis 0 fastest); emit C order (axis 2
  // fastest) to match numpy's default layout. Cache-blocked transpose over
  // the (i, k) plane per j slice. For 4-D multi-contrast volumes the output
  // layout is channels-last (D, H, W, C): ``data`` points at the start of
  // one contiguous Fortran channel block and rows are written with stride
  // ``n_channels`` at offset ``channel``.
  const T* src = reinterpret_cast<const T*>(data);
  const int d0 = h.shape[0], d1 = h.shape[1], d2 = h.shape[2];
  const float slope = (h.scl_slope == 0.0f || h.scl_slope == 1.0f) ? 1.0f : h.scl_slope;
  const float inter = (h.scl_slope == 0.0f) ? 0.0f : h.scl_inter;
  const bool scaled = slope != 1.0f || inter != 0.0f;
  constexpr int kTile = 64;
  const size_t plane = static_cast<size_t>(d0) * d1;
  const size_t stride = static_cast<size_t>(n_channels);
  for (int j = 0; j < d1; ++j) {
    for (int k0 = 0; k0 < d2; k0 += kTile) {
      const int k1 = k0 + kTile < d2 ? k0 + kTile : d2;
      for (int i0 = 0; i0 < d0; i0 += kTile) {
        const int i1 = i0 + kTile < d0 ? i0 + kTile : d0;
        for (int i = i0; i < i1; ++i) {
          float* row = out + (static_cast<size_t>(i) * d1 + j) * d2 * stride +
                       channel;
          const T* col = src + static_cast<size_t>(j) * d0 + i;
          for (int k = k0; k < k1; ++k) {
            float v = static_cast<float>(col[static_cast<size_t>(k) * plane]);
            if (scaled) v = v * slope + inter;
            row[k * stride] = v;
          }
        }
      }
    }
  }
}

// One-entry decompression cache: the Python binding probes the shape and then
// loads the same file, so the gunzip (the dominant cost) must only run once.
// Keyed by (path, mtime, size) so rewritten files are never served stale.
struct FileCache {
  std::string path;
  long mtime = -1;
  long fsize = -1;
  std::vector<uint8_t> plain;
};
thread_local FileCache g_cache;

const uint8_t* load_raw(const char* path, size_t* size) {
  struct stat st;
  if (stat(path, &st) != 0) return nullptr;
  if (g_cache.path == path && g_cache.mtime == static_cast<long>(st.st_mtime) &&
      g_cache.fsize == static_cast<long>(st.st_size) && !g_cache.plain.empty()) {
    *size = g_cache.plain.size();
    return g_cache.plain.data();
  }
  g_cache.mtime = static_cast<long>(st.st_mtime);
  g_cache.fsize = static_cast<long>(st.st_size);
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return nullptr;
  if (file.size() >= 2 && file[0] == 0x1f && file[1] == 0x8b) {
    std::vector<uint8_t> plain;
    if (!gunzip(file, &plain)) return nullptr;
    g_cache.path = path;
    g_cache.plain = std::move(plain);
  } else {
    g_cache.path = path;
    g_cache.plain = std::move(file);
  }
  *size = g_cache.plain.size();
  return g_cache.plain.data();
}

// Channels of a parsed header: product of dims 3..ndim (NIfTI stores
// multi-contrast stacks in dim 4+; 3-D volumes have 1 channel).
int64_t header_channels(const Header& h) {
  int64_t c = 1;
  for (int i = 3; i < h.ndim; ++i) c *= h.shape[i];
  return c;
}

}  // namespace

extern "C" {

// Returns 0 on success. shape_out[3], pixdim_out[3] filled; volume written to
// out (caller allocates d0*d1*d2 floats after calling msl_nifti_shape).
// Multi-channel (4-D) files return error 8: use msl_nifti_shape4, which
// also reports the channel count — loading only channel 0 silently would
// corrupt multi-contrast data.
int msl_nifti_shape(const char* path, int* shape_out, float* pixdim_out) {
  size_t raw_size = 0;
  const uint8_t* raw = load_raw(path, &raw_size);
  if (!raw) return 1;
  Header h;
  if (!parse_header(raw, raw_size, &h)) return 3;
  if (h.ndim < 3) return 4;
  if (header_channels(h) != 1) return 8;
  for (int i = 0; i < 3; ++i) {
    shape_out[i] = h.shape[i];
    pixdim_out[i] = std::fabs(h.pixdim[i]);
  }
  return 0;
}

// 4-D aware shape query: shape_out[4] = {d0, d1, d2, channels} (channels = 1
// for plain 3-D volumes), pixdim_out[3] spatial voxel sizes.
int msl_nifti_shape4(const char* path, int* shape_out, float* pixdim_out) {
  size_t raw_size = 0;
  const uint8_t* raw = load_raw(path, &raw_size);
  if (!raw) return 1;
  Header h;
  if (!parse_header(raw, raw_size, &h)) return 3;
  if (h.ndim < 3) return 4;
  for (int i = 0; i < 3; ++i) {
    shape_out[i] = h.shape[i];
    pixdim_out[i] = std::fabs(h.pixdim[i]);
  }
  int64_t c = header_channels(h);
  if (c < 1 || c > (1 << 20)) return 8;
  shape_out[3] = static_cast<int>(c);
  return 0;
}

// normalize: 0 = raw fp32; 1 = nonzero-mean/std normalization in place
// (MONAI NormalizeIntensityd(nonzero=True) parity). Multi-channel volumes
// come out channels-last (D, H, W, C) and normalize PER CHANNEL — each
// contrast is an independently-scaled acquisition.
int msl_nifti_load(const char* path, float* out, int64_t out_len, int normalize) {
  size_t raw_size = 0;
  const uint8_t* raw = load_raw(path, &raw_size);
  if (!raw) return 1;
  Header h;
  if (!parse_header(raw, raw_size, &h)) return 3;
  if (h.ndim < 3) return 4;
  const int64_t channels = header_channels(h);
  if (channels < 1 || channels > (1 << 20)) return 8;
  const int64_t n =
      static_cast<int64_t>(h.shape[0]) * h.shape[1] * h.shape[2];
  if (n * channels != out_len) return 5;
  // bounds-check before touching voxel data: a truncated/corrupt file must
  // produce a clean error code, not an out-of-bounds heap read
  if (h.shape[0] <= 0 || h.shape[1] <= 0 || h.shape[2] <= 0) return 7;
  if (h.vox_offset < kHeaderSize) return 7;
  size_t elem_size = 0;
  switch (h.datatype) {
    case 2: case 256:          elem_size = 1; break;
    case 4: case 512:          elem_size = 2; break;
    case 8: case 16:           elem_size = 4; break;
    case 64:                   elem_size = 8; break;
    default:                   return 6;
  }
  if (raw_size < static_cast<size_t>(h.vox_offset) +
                     static_cast<size_t>(n) * channels * elem_size) {
    return 7;  // decompressed buffer shorter than the declared volume
  }

  const int nc = static_cast<int>(channels);
  for (int c = 0; c < nc; ++c) {
    // each Fortran channel block is contiguous: n voxels of channel c start
    // at vox_offset + c * n * elem_size
    const uint8_t* data = raw + h.vox_offset + static_cast<size_t>(c) * n * elem_size;
    switch (h.datatype) {
      case 2:    to_f32_c_order<uint8_t>(data, h, out, nc, c); break;
      case 4:    to_f32_c_order<int16_t>(data, h, out, nc, c); break;
      case 8:    to_f32_c_order<int32_t>(data, h, out, nc, c); break;
      case 16:   to_f32_c_order<float>(data, h, out, nc, c); break;
      case 64:   to_f32_c_order<double>(data, h, out, nc, c); break;
      case 256:  to_f32_c_order<int8_t>(data, h, out, nc, c); break;
      case 512:  to_f32_c_order<uint16_t>(data, h, out, nc, c); break;
      default:   return 6;
    }
  }

  if (normalize) {
    for (int c = 0; c < nc; ++c) {
      double sum = 0.0, sq = 0.0;
      int64_t count = 0;
      for (int64_t i = 0; i < n; ++i) {
        const float v = out[i * nc + c];
        if (v != 0.0f) {
          sum += v;
          sq += static_cast<double>(v) * v;
          ++count;
        }
      }
      if (count > 0) {
        const double mean = sum / count;
        double var = sq / count - mean * mean;
        if (var < 0) var = 0;
        const double std_ = std::sqrt(var);
        const float inv = static_cast<float>(1.0 / (std_ > 1e-8 ? std_ : 1e-8));
        const float m = static_cast<float>(mean);
        for (int64_t i = 0; i < n; ++i) {
          float* v = out + i * nc + c;
          if (*v != 0.0f) *v = (*v - m) * inv;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
