// paris_io — native I/O runtime for the paris_tpu framework.
//
// TPU-native counterpart of the reference's C++ host-I/O subsystem
// (reference: src/his.cpp byte layout, src/ddbvf.cpp byte layout,
// src/sink.cpp write path).  The Python layer keeps orchestration;
// this library does the byte-level hot work without the GIL:
//
//   * HIS frame decode: all five detector dtypes converted to f32 with
//     a threaded striped loop (the decode of a multi-MB frame is the
//     CPU-bound part of projection streaming);
//   * ddbvf block write/read: positional pwrite/pread, threaded in
//     stripes so multiple slices land in the page cache in parallel —
//     disjoint-range writers need no lock (unlike the reference's
//     global sink mutex, sink.cpp:79-81).
//
// Build: native/build.sh  ->  libparis_io.so  (loaded via ctypes from
// paris_tpu/io/native.py; every entry point has a Python fallback).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr std::uint16_t kHisMagic = 0x7000;
constexpr int kHisFileHeaderSize = 68;

#pragma pack(push, 1)
struct HisHeader {
  std::uint16_t file_type;
  std::uint16_t header_size;
  std::uint16_t header_version;
  std::uint32_t file_size;
  std::uint16_t image_header_size;
  std::uint16_t ulx, uly, brx, bry;
  std::uint16_t frame_number;
  std::uint16_t correction;
  double integration_time;
  std::uint16_t number_type;
  std::uint8_t pad[34];
};
#pragma pack(pop)

static_assert(sizeof(HisHeader) == kHisFileHeaderSize, "HIS header layout");

int dtype_size(std::uint16_t number_type) {
  switch (number_type) {
    case 2: return 1;    // uchar
    case 4: return 2;    // ushort
    case 32: return 4;   // dword
    case 64: return 8;   // double
    case 128: return 4;  // float
    default: return -1;
  }
}

template <typename T>
void convert_span(const unsigned char* src, float* dst, long n) {
  const T* s = reinterpret_cast<const T*>(src);
  for (long i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
}

void convert(const unsigned char* src, float* dst, long n,
             std::uint16_t number_type) {
  switch (number_type) {
    case 2: convert_span<std::uint8_t>(src, dst, n); break;
    case 4: convert_span<std::uint16_t>(src, dst, n); break;
    case 32: convert_span<std::uint32_t>(src, dst, n); break;
    case 64: convert_span<double>(src, dst, n); break;
    case 128: std::memcpy(dst, src, n * sizeof(float)); break;
  }
}

int num_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 2 : static_cast<int>(hw);
}

bool read_exact(int fd, void* buf, long n, long offset) {
  unsigned char* p = static_cast<unsigned char*>(buf);
  long done = 0;
  while (done < n) {
    ssize_t r = ::pread(fd, p + done, n - done, offset + done);
    if (r <= 0) return false;
    done += r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, long n, long offset) {
  const unsigned char* p = static_cast<const unsigned char*>(buf);
  long done = 0;
  while (done < n) {
    ssize_t r = ::pwrite(fd, p + done, n - done, offset + done);
    if (r < 0) return false;
    done += r;
  }
  return true;
}

}  // namespace

extern "C" {

// Error codes shared with the ctypes wrapper.
enum : int {
  PARIS_IO_OK = 0,
  PARIS_IO_EOPEN = -1,
  PARIS_IO_EFORMAT = -2,
  PARIS_IO_ETRUNC = -3,
  PARIS_IO_ESPACE = -4,
  PARIS_IO_EIO = -5,
};

struct HisInfo {
  std::int32_t width;
  std::int32_t height;
  std::int32_t frames;
  std::int32_t number_type;
  std::int32_t image_header_size;
};

// Parse the 68-byte header; returns PARIS_IO_OK or an error code.
int paris_his_info(const char* path, HisInfo* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return PARIS_IO_EOPEN;
  HisHeader h;
  bool ok = read_exact(fd, &h, sizeof(h), 0);
  ::close(fd);
  if (!ok) return PARIS_IO_ETRUNC;
  if (h.file_type != kHisMagic || h.header_size != kHisFileHeaderSize)
    return PARIS_IO_EFORMAT;
  if (dtype_size(h.number_type) < 0) return PARIS_IO_EFORMAT;
  out->width = h.brx - h.ulx + 1;
  out->height = h.bry - h.uly + 1;
  out->frames = h.frame_number;
  out->number_type = h.number_type;
  out->image_header_size = h.image_header_size;
  return PARIS_IO_OK;
}

// Decode every frame to f32 into out (capacity frames*height*width).
int paris_his_read(const char* path, float* out, std::int64_t capacity) {
  HisInfo info;
  int rc = paris_his_info(path, &info);
  if (rc != PARIS_IO_OK) return rc;
  const long px = static_cast<long>(info.width) * info.height;
  const long total = px * info.frames;
  if (total > capacity) return PARIS_IO_ESPACE;

  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return PARIS_IO_EOPEN;
  const int esz = dtype_size(static_cast<std::uint16_t>(info.number_type));
  const long frame_bytes = px * esz;
  const long stride = info.image_header_size + frame_bytes;

  const int nthreads = num_threads();
  std::vector<std::thread> pool;
  std::vector<int> status(nthreads, PARIS_IO_OK);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t]() {
      std::vector<unsigned char> buf(frame_bytes);
      for (int f = t; f < info.frames; f += nthreads) {
        long off = kHisFileHeaderSize + static_cast<long>(f) * stride +
                   info.image_header_size;
        if (!read_exact(fd, buf.data(), frame_bytes, off)) {
          status[t] = PARIS_IO_ETRUNC;
          return;
        }
        convert(buf.data(), out + static_cast<long>(f) * px, px,
                static_cast<std::uint16_t>(info.number_type));
      }
    });
  }
  for (auto& th : pool) th.join();
  ::close(fd);
  for (int s : status)
    if (s != PARIS_IO_OK) return s;
  return PARIS_IO_OK;
}

// ---------------------------------------------------------------- ddbvf

constexpr std::uint32_t kDdbvfMagic = 0xEFDDDAFA;
constexpr std::uint16_t kDdbvfVersion = 0x0010;
constexpr long kDdbvfDataStart = 32;

#pragma pack(push, 1)
struct DdbvfHeader {
  std::uint32_t magic;
  std::uint16_t version;
  std::uint32_t dim_x, dim_y, dim_z;
  std::uint32_t offset;
};
#pragma pack(pop)

int paris_ddbvf_create(const char* path, std::uint32_t dim_x,
                       std::uint32_t dim_y, std::uint32_t dim_z) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return PARIS_IO_EOPEN;
  DdbvfHeader h{kDdbvfMagic, kDdbvfVersion, dim_x, dim_y, dim_z,
                static_cast<std::uint32_t>(kDdbvfDataStart - sizeof(DdbvfHeader))};
  unsigned char block[kDdbvfDataStart] = {0};
  std::memcpy(block, &h, sizeof(h));
  bool ok = write_exact(fd, block, kDdbvfDataStart, 0);
  long total = kDdbvfDataStart +
               4L * dim_x * dim_y * static_cast<long>(dim_z);
  ok = ok && ::ftruncate(fd, total) == 0;
  ::close(fd);
  return ok ? PARIS_IO_OK : PARIS_IO_EIO;
}

int paris_ddbvf_open(const char* path, std::uint32_t* dims /* [3] */) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return PARIS_IO_EOPEN;
  DdbvfHeader h;
  bool ok = read_exact(fd, &h, sizeof(h), 0);
  ::close(fd);
  if (!ok) return PARIS_IO_ETRUNC;
  if (h.magic != kDdbvfMagic || h.version != kDdbvfVersion)
    return PARIS_IO_EFORMAT;
  dims[0] = h.dim_x;
  dims[1] = h.dim_y;
  dims[2] = h.dim_z;
  return PARIS_IO_OK;
}

// Write a (dz, dim_y, dim_x) f32 block at slice `first`, striped over
// threads (disjoint ranges: lock-free).
int paris_ddbvf_write(const char* path, const float* data,
                      std::uint32_t dz, std::uint32_t first) {
  std::uint32_t dims[3];
  int rc = paris_ddbvf_open(path, dims);
  if (rc != PARIS_IO_OK) return rc;
  if (first + dz > dims[2]) return PARIS_IO_ESPACE;
  const long slice_bytes = 4L * dims[0] * dims[1];
  int fd = ::open(path, O_WRONLY);
  if (fd < 0) return PARIS_IO_EOPEN;

  const int nthreads = num_threads();
  std::vector<std::thread> pool;
  std::vector<int> status(nthreads, PARIS_IO_OK);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t]() {
      for (std::uint32_t z = t; z < dz; z += nthreads) {
        long off = kDdbvfDataStart +
                   slice_bytes * (static_cast<long>(first) + z);
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(data) + slice_bytes * z;
        if (!write_exact(fd, src, slice_bytes, off)) {
          status[t] = PARIS_IO_EIO;
          return;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  ::close(fd);
  for (int s : status)
    if (s != PARIS_IO_OK) return s;
  return PARIS_IO_OK;
}

// Per-FRAME affine-u16 wire quantization of an (n_frames, frame_elems)
// f32 chunk (the fast-mode h2d staging, pipeline.quantize_chunk_u16):
// out[f] = rint((in[f] - lo_f) / scale_f), qparams[f] = {scale_f, lo_f}
// with scale_f = (max_f - min_f)/65535 (1.0 for constant frames).
// Fused min/max + transform in two passes per frame (NumPy needs ~4
// full-array passes), threaded across frames — this runs on the
// streaming critical path feeding the chip.
// n_threads <= 0 selects hardware_concurrency; callers that run several
// quantize calls concurrently (pipeline.stage_stream's worker pool)
// pass their share to avoid oversubscribing the host.
int paris_quantize_u16(const float* in, std::int64_t n_frames,
                       std::int64_t frame_elems, std::uint16_t* out,
                       float* qparams, int n_threads) {
  if (n_frames <= 0 || frame_elems <= 0) return PARIS_IO_ESPACE;
  unsigned nt = n_threads > 0 ? (unsigned)n_threads
                              : std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if ((std::int64_t)nt > n_frames) nt = (unsigned)n_frames;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (unsigned t = 0; t < nt; ++t) {
    pool.emplace_back([=] {
      for (std::int64_t f = t; f < n_frames; f += nt) {
        const float* src = in + f * frame_elems;
        float lo = src[0], hi = src[0];
        for (std::int64_t i = 1; i < frame_elems; ++i) {
          const float v = src[i];
          lo = v < lo ? v : lo;
          hi = v > hi ? v : hi;
        }
        float scale = (hi - lo) / 65535.0f;
        std::uint16_t* dst = out + f * frame_elems;
        if (!(scale > 0.0f)) {
          // constant frame (notably the zero-filled placeholder rows of
          // other hosts' multi-host chunk shards): skip the transform
          // pass — q=0, scale=1 dequantizes to exactly lo
          std::memset(dst, 0, (size_t)frame_elems * sizeof(std::uint16_t));
          qparams[2 * f] = 1.0f;
          qparams[2 * f + 1] = lo;
          continue;
        }
        const float inv = 1.0f / scale;
        for (std::int64_t i = 0; i < frame_elems; ++i)
          // int32 round-to-nearest-even (vectorizes to cvtps2dq; the
          // i64 lrintf form blocks vectorization)
          dst[i] = (std::uint16_t)(std::int32_t)__builtin_rintf(
              (src[i] - lo) * inv);
        qparams[2 * f] = scale;
        qparams[2 * f + 1] = lo;
      }
    });
  }
  for (auto& th : pool) th.join();
  return PARIS_IO_OK;
}

// Read `count` slices starting at `first` into out.
int paris_ddbvf_read(const char* path, float* out, std::uint32_t first,
                     std::uint32_t count) {
  std::uint32_t dims[3];
  int rc = paris_ddbvf_open(path, dims);
  if (rc != PARIS_IO_OK) return rc;
  if (first + count > dims[2]) return PARIS_IO_ESPACE;
  const long slice_bytes = 4L * dims[0] * dims[1];
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return PARIS_IO_EOPEN;
  bool ok = read_exact(fd, out, slice_bytes * count,
                       kDdbvfDataStart + slice_bytes * first);
  ::close(fd);
  return ok ? PARIS_IO_OK : PARIS_IO_ETRUNC;
}

}  // extern "C"
