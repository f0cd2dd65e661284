// paris_ingest — the raw HIS reader of the port's ingest stage.
//
// Reads HIS frames in the number type they were stored in (u8, u16 and
// f32 as stored; u32 and f64, rare, converted to f32) into a caller's
// buffer, a pinned staging slot, so that the page-cache copy is the only
// host copy of a frame before its copy to the card, where it is converted
// to float32.  Threaded across frames.  The byte layout is the reference
// reader's (src/his.cpp:46-67,105-198), as in paris_io.cpp, which decodes
// to float32 and stays a copy of native/paris_io.cpp.
//
// Build: paris_tpu_torch/_build.py (the host compiler, the flags of
// native/build.sh); loaded through ctypes by paris_tpu_torch/io/native.py.

#include <cstdint>
#include <fcntl.h>
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

// Error codes of paris_io.cpp, which io/native.py names.
enum : int {
  kOk = 0,
  kOpen = -1,
  kFormat = -2,
  kTrunc = -3,
  kSpace = -4,
};

// Bytes per stored pixel, or -1 for an unknown number type.
int stored_size(std::uint16_t number_type) {
  switch (number_type) {
    case 2: return 1;    // uchar
    case 4: return 2;    // ushort
    case 32: return 4;   // dword
    case 64: return 8;   // double
    case 128: return 4;  // float
    default: return -1;
  }
}

// Bytes per pixel as the raw read returns it: u8, u16, f32 as stored,
// u32 and f64 as f32.
int raw_size(std::uint16_t number_type) {
  switch (number_type) {
    case 2: return 1;
    case 4: return 2;
    case 32: case 64: case 128: return 4;
    default: return -1;
  }
}

template <typename T>
void to_float(const unsigned char* src, float* dst, long n) {
  const T* s = reinterpret_cast<const T*>(src);
  for (long i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
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

}  // namespace

extern "C" {

// Read frames [first, first + count) of a HIS file whose header the
// caller has parsed (number type, image header bytes, pixels per frame)
// into out (capacity_bytes), frame after frame, in the raw type.  Types
// kept as stored are read straight into out; u32 and f64 go through a
// per-thread buffer.  n_threads <= 0 selects hardware_concurrency.
int paris_his_read_frames(const char* path, int number_type,
                          int image_header_size, std::int64_t px, int first,
                          int count, void* out, std::int64_t capacity_bytes,
                          int n_threads) {
  const auto type = static_cast<std::uint16_t>(number_type);
  const int esz = stored_size(type);
  const int osz = raw_size(type);
  if (esz < 0 || osz < 0 || first < 0 || count < 0 || px <= 0 ||
      image_header_size < 0)
    return kFormat;
  if (static_cast<std::int64_t>(count) * px * osz > capacity_bytes)
    return kSpace;
  if (count == 0) return kOk;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return kOpen;
  const long frame_bytes = px * esz;
  const long stride = image_header_size + frame_bytes;
  const bool direct = type != 32 && type != 64;   // kept as stored
  int nthreads = n_threads > 0 ? n_threads
                               : static_cast<int>(
                                     std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > count) nthreads = count;
  unsigned char* dst = static_cast<unsigned char*>(out);
  std::vector<std::thread> pool;
  std::vector<int> status(nthreads, kOk);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t]() {
      std::vector<unsigned char> buf(direct ? 0 : frame_bytes);
      for (int f = t; f < count; f += nthreads) {
        const long off = kHisFileHeaderSize +
                         static_cast<long>(first + f) * stride +
                         image_header_size;
        unsigned char* row = dst + static_cast<long>(f) * px * osz;
        if (!read_exact(fd, direct ? row : buf.data(), frame_bytes, off)) {
          status[t] = kTrunc;
          return;
        }
        if (type == 32)
          to_float<std::uint32_t>(buf.data(), reinterpret_cast<float*>(row),
                                  px);
        else if (type == 64)
          to_float<double>(buf.data(), reinterpret_cast<float*>(row), px);
      }
    });
  }
  for (auto& th : pool) th.join();
  ::close(fd);
  for (int s : status)
    if (s != kOk) return s;
  return kOk;
}

// Every frame of a HIS file into out (capacity_bytes), in the raw type.
int paris_his_read_raw(const char* path, void* out,
                       std::int64_t capacity_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return kOpen;
  HisHeader h;
  const bool ok = read_exact(fd, &h, sizeof(h), 0);
  ::close(fd);
  if (!ok) return kTrunc;
  if (h.file_type != kHisMagic || h.header_size != kHisFileHeaderSize ||
      stored_size(h.number_type) < 0)
    return kFormat;
  const std::int64_t px = static_cast<std::int64_t>(h.brx - h.ulx + 1) *
                          (h.bry - h.uly + 1);
  return paris_his_read_frames(path, h.number_type, h.image_header_size, px,
                               0, h.frame_number, out, capacity_bytes, 0);
}

}  // extern "C"
