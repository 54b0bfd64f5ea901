// vslam_loader: native frame-ingest runtime for the SLAM pipeline.
//
// Native replacement for the reference's data path (cv2.imread /
// cv2.VideoCapture in visual_slam/source.py:60,85,125,205): a C++ decode +
// prefetch engine so the Python shell never blocks on image IO while the
// device is tracking. Components:
//   * PNG decoder (zlib inflate + per-row unfiltering; 8-bit gray/RGB/RGBA,
//     non-interlaced — covers KITTI/TUM/EuRoC data),
//   * PGM/PPM (binary P5/P6) decoder,
//   * BMP (24/32-bit uncompressed) decoder,
//   * grayscale conversion (BT.601, matching utils/source.py::to_gray),
//   * a bounded multi-worker prefetch queue that decodes ahead of the
//     consumer and hands frames out in order.
//
// C ABI only (consumed via ctypes — no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;  // 1 = gray, 3 = rgb
  std::vector<uint8_t> data;
  bool ok = false;
};

// ---------------------------------------------------------------------------
// File slurp
// ---------------------------------------------------------------------------
static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = fread(out.data(), 1, out.size(), f);
  fclose(f);
  return got == out.size();
}

// ---------------------------------------------------------------------------
// PNG decode (8-bit, non-interlaced, gray / gray+alpha / RGB / RGBA / palette)
// ---------------------------------------------------------------------------
static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

static Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (buf.size() < 8 || memcmp(buf.data(), sig, 8) != 0) return img;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples

  size_t off = 8;
  while (off + 8 <= buf.size()) {
    uint32_t len = be32(&buf[off]);
    if (off + 12 + len > buf.size()) break;
    const uint8_t* type = &buf[off + 4];
    const uint8_t* data = &buf[off + 8];
    if (!memcmp(type, "IHDR", 4) && len >= 13) {
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(data, data + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return img;

  int src_ch;
  switch (color_type) {
    case 0: src_ch = 1; break;  // gray
    case 2: src_ch = 3; break;  // rgb
    case 3: src_ch = 1; break;  // palette index
    case 4: src_ch = 2; break;  // gray+alpha
    case 6: src_ch = 4; break;  // rgba
    default: return img;
  }

  size_t stride = size_t(w) * src_ch;
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK) return img;
  if (raw_len < raw.size()) return img;

  // Unfilter in place into `recon`.
  std::vector<uint8_t> recon(size_t(h) * stride);
  const int bpp = src_ch;
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &recon[size_t(y) * stride];
    const uint8_t* prev = y ? &recon[size_t(y - 1) * stride] : nullptr;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x) dst[x] = src[x] + (prev ? prev[x] : 0);
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = src[x] + uint8_t((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
          dst[x] = src[x] + uint8_t(paeth(a, b, c));
        }
        break;
      default:
        return img;
    }
  }

  // Convert to gray or rgb output.
  int out_ch = (color_type == 0 || color_type == 4) ? 1 : 3;
  if (color_type == 3 && palette.empty()) return img;
  img.width = int(w);
  img.height = int(h);
  img.channels = out_ch;
  img.data.resize(size_t(w) * h * out_ch);
  for (size_t i = 0; i < size_t(w) * h; ++i) {
    const uint8_t* px = &recon[i * src_ch];
    uint8_t* o = &img.data[i * out_ch];
    switch (color_type) {
      case 0: o[0] = px[0]; break;
      case 4: o[0] = px[0]; break;
      case 2: o[0] = px[0]; o[1] = px[1]; o[2] = px[2]; break;
      case 6: o[0] = px[0]; o[1] = px[1]; o[2] = px[2]; break;
      case 3: {
        size_t pi = size_t(px[0]) * 3;
        if (pi + 2 < palette.size()) {
          o[0] = palette[pi];
          o[1] = palette[pi + 1];
          o[2] = palette[pi + 2];
        }
        break;
      }
    }
  }
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------------------
// PGM / PPM (binary)
// ---------------------------------------------------------------------------
static Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) return img;
  int ch = buf[1] == '5' ? 1 : 3;
  size_t pos = 2;
  auto next_int = [&](int& out) -> bool {
    // skip whitespace + comments
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else if (isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
    int v = 0;
    bool any = false;
    while (pos < buf.size() && isdigit(buf[pos])) {
      v = v * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    out = v;
    return any;
  };
  int w, h, maxv;
  if (!next_int(w) || !next_int(h) || !next_int(maxv) || maxv > 255) return img;
  ++pos;  // single whitespace after maxval
  size_t need = size_t(w) * h * ch;
  if (buf.size() < pos + need) return img;
  img.width = w;
  img.height = h;
  img.channels = ch;
  img.data.assign(buf.begin() + pos, buf.begin() + pos + need);
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------------------
// BMP (24/32-bit uncompressed, bottom-up)
// ---------------------------------------------------------------------------
static Image decode_bmp(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 54 || buf[0] != 'B' || buf[1] != 'M') return img;
  uint32_t data_off = *reinterpret_cast<const uint32_t*>(&buf[10]);
  int32_t w = *reinterpret_cast<const int32_t*>(&buf[18]);
  int32_t h = *reinterpret_cast<const int32_t*>(&buf[22]);
  uint16_t bpp = *reinterpret_cast<const uint16_t*>(&buf[28]);
  uint32_t comp = *reinterpret_cast<const uint32_t*>(&buf[30]);
  if (comp != 0 || (bpp != 24 && bpp != 32) || w <= 0 || h == 0) return img;
  bool flip = h > 0;
  int ah = std::abs(h);
  int src_ch = bpp / 8;
  size_t row = (size_t(w) * src_ch + 3) & ~size_t(3);
  if (buf.size() < data_off + row * ah) return img;
  img.width = w;
  img.height = ah;
  img.channels = 3;
  img.data.resize(size_t(w) * ah * 3);
  for (int y = 0; y < ah; ++y) {
    const uint8_t* src = &buf[data_off + row * (flip ? (ah - 1 - y) : y)];
    uint8_t* dst = &img.data[size_t(y) * w * 3];
    for (int x = 0; x < w; ++x) {
      dst[x * 3 + 0] = src[x * src_ch + 2];  // BGR -> RGB
      dst[x * 3 + 1] = src[x * src_ch + 1];
      dst[x * 3 + 2] = src[x * src_ch + 0];
    }
  }
  img.ok = true;
  return img;
}

static Image decode_any(const std::vector<uint8_t>& buf) {
  if (buf.size() >= 8 && buf[0] == 0x89 && buf[1] == 'P') return decode_png(buf);
  if (buf.size() >= 2 && buf[0] == 'P' && (buf[1] == '5' || buf[1] == '6'))
    return decode_pnm(buf);
  if (buf.size() >= 2 && buf[0] == 'B' && buf[1] == 'M') return decode_bmp(buf);
  return Image{};
}

static void to_gray_f32(const Image& img, float* out) {
  size_t n = size_t(img.width) * img.height;
  if (img.channels == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = float(img.data[i]);
  } else {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = &img.data[i * 3];
      out[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  }
}

// ---------------------------------------------------------------------------
// Prefetching dataset
// ---------------------------------------------------------------------------
struct Dataset {
  std::vector<std::string> paths;
  int width = 0, height = 0;  // fixed frame geometry (from first frame)
  bool gray = true;

  // slot ring: decoded frames waiting for the consumer, in order.
  struct Slot {
    std::vector<float> gray_data;
    std::vector<uint8_t> rgb_data;
    int index = -1;
    bool ready = false;
  };
  std::vector<Slot> ring;
  size_t capacity = 0;

  std::mutex mu;
  std::condition_variable cv_producer;
  std::condition_variable cv_consumer;
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  std::atomic<int> decode_errors{0};

  ~Dataset() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_producer.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  void worker() {
    while (!stop.load()) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= int(paths.size())) return;
      std::vector<uint8_t> buf;
      Image im;
      if (read_file(paths[idx].c_str(), buf)) im = decode_any(buf);
      // Wait until the ring slot for idx is free (consumer caught up).
      std::unique_lock<std::mutex> lk(mu);
      cv_producer.wait(lk, [&] {
        return stop.load() || idx < next_to_consume + int(capacity);
      });
      if (stop.load()) return;
      Slot& s = ring[idx % capacity];
      s.index = idx;
      if (im.ok && im.width == width && im.height == height) {
        if (gray) {
          s.gray_data.resize(size_t(width) * height);
          to_gray_f32(im, s.gray_data.data());
        } else {
          s.rgb_data.resize(size_t(width) * height * 3);
          if (im.channels == 3) {
            memcpy(s.rgb_data.data(), im.data.data(), s.rgb_data.size());
          } else {
            for (size_t i = 0; i < size_t(width) * height; ++i)
              s.rgb_data[i * 3] = s.rgb_data[i * 3 + 1] = s.rgb_data[i * 3 + 2] =
                  im.data[i];
          }
        }
        s.ready = true;
      } else {
        decode_errors.fetch_add(1);
        s.ready = true;  // consumer sees zeros/flagged frame
        if (gray) {
          s.gray_data.assign(size_t(width) * height, 0.0f);
        } else {
          s.rgb_data.assign(size_t(width) * height * 3, 0);
        }
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one image file. Returns 0 on success; fills w/h/ch. `out` must hold
// w*h*ch bytes (call with out=null first to query dims via probe).
int vslam_decode(const char* path, uint8_t* out, int out_cap, int* w, int* h, int* ch) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  Image im = decode_any(buf);
  if (!im.ok) return -2;
  *w = im.width;
  *h = im.height;
  *ch = im.channels;
  if (out) {
    if (out_cap < int(im.data.size())) return -3;
    memcpy(out, im.data.data(), im.data.size());
  }
  return 0;
}

// Create a prefetching dataset over `n` '\n'-separated paths.
void* vslam_dataset_open(const char* joined_paths, int gray, int n_workers, int prefetch) {
  auto* ds = new Dataset();
  ds->gray = gray != 0;
  const char* p = joined_paths;
  while (*p) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    if (e > p) ds->paths.emplace_back(p, e - p);
    p = (*e) ? e + 1 : e;
  }
  if (ds->paths.empty()) {
    delete ds;
    return nullptr;
  }
  // Probe first frame for geometry.
  std::vector<uint8_t> buf;
  if (!read_file(ds->paths[0].c_str(), buf)) {
    delete ds;
    return nullptr;
  }
  Image im = decode_any(buf);
  if (!im.ok) {
    delete ds;
    return nullptr;
  }
  ds->width = im.width;
  ds->height = im.height;
  ds->capacity = size_t(std::max(prefetch, 2));
  ds->ring.resize(ds->capacity);
  int nw = std::max(n_workers, 1);
  for (int i = 0; i < nw; ++i) ds->workers.emplace_back(&Dataset::worker, ds);
  return ds;
}

int vslam_dataset_width(void* h) { return static_cast<Dataset*>(h)->width; }
int vslam_dataset_height(void* h) { return static_cast<Dataset*>(h)->height; }
int vslam_dataset_size(void* h) { return int(static_cast<Dataset*>(h)->paths.size()); }
int vslam_dataset_errors(void* h) { return static_cast<Dataset*>(h)->decode_errors.load(); }

// Blocking in-order fetch of the next frame as float32 grayscale (or uint8
// RGB when opened with gray=0). Returns the frame index, or -1 at end.
int vslam_dataset_next(void* h, void* out) {
  auto* ds = static_cast<Dataset*>(h);
  if (ds->next_to_consume >= int(ds->paths.size())) return -1;
  int idx = ds->next_to_consume;
  std::unique_lock<std::mutex> lk(ds->mu);
  Dataset::Slot& s = ds->ring[idx % ds->capacity];
  ds->cv_consumer.wait(lk, [&] { return ds->stop.load() || (s.ready && s.index == idx); });
  if (ds->stop.load()) return -1;
  if (ds->gray) {
    memcpy(out, s.gray_data.data(), s.gray_data.size() * sizeof(float));
  } else {
    memcpy(out, s.rgb_data.data(), s.rgb_data.size());
  }
  s.ready = false;
  s.index = -1;
  ds->next_to_consume = idx + 1;
  ds->cv_producer.notify_all();
  return idx;
}

void vslam_dataset_close(void* h) { delete static_cast<Dataset*>(h); }

}  // extern "C"
