// Native IO runtime: image decoding + threaded prefetch.
//
// The reference's runtime around the compute path is C++ (cv::imread in the
// Examples/ drivers, std::thread pipelines); this is the equivalent for the
// TPU build: a dependency-free grayscale PNG/PGM decoder (zlib only) and a
// background prefetcher that decodes ahead of the tracking loop, exposed
// through a plain C ABI for ctypes.
//
// Formats: PGM (P2/P5, 8/16-bit), PNG (8/16-bit grayscale, 8-bit RGB/RGBA
// converted to luma) — covering TUM RGB-D, KITTI odometry and EuRoC assets.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  // always float32 grayscale, 16-bit sources keep raw counts (e.g. TUM depth)
  std::vector<float> data;
  bool ok = false;
};

// ---------------------------------------------------------------- PGM ------

Image load_pgm(FILE* f) {
  Image img;
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return img;
  bool ascii = strcmp(magic, "P2") == 0;
  if (!ascii && strcmp(magic, "P5") != 0) return img;

  auto next_int = [&]() -> long {
    int c;
    // skip whitespace + comments
    for (;;) {
      c = fgetc(f);
      if (c == '#') {
        while (c != '\n' && c != EOF) c = fgetc(f);
      } else if (!isspace(c)) {
        break;
      }
    }
    long v = 0;
    while (isdigit(c)) {
      v = v * 10 + (c - '0');
      c = fgetc(f);
    }
    return v;
  };

  long w = next_int(), h = next_int(), maxval = next_int();
  if (w <= 0 || h <= 0 || maxval <= 0) return img;
  img.width = (int)w;
  img.height = (int)h;
  img.data.resize((size_t)w * h);
  if (ascii) {
    for (size_t i = 0; i < img.data.size(); ++i) img.data[i] = (float)next_int();
  } else if (maxval < 256) {
    std::vector<uint8_t> buf(img.data.size());
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return img;
    for (size_t i = 0; i < buf.size(); ++i) img.data[i] = buf[i];
  } else {
    std::vector<uint8_t> buf(img.data.size() * 2);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return img;
    for (size_t i = 0; i < img.data.size(); ++i)
      img.data[i] = (float)((buf[2 * i] << 8) | buf[2 * i + 1]);  // big-endian
  }
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------- PNG ------

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image load_png(FILE* f) {
  Image img;
  uint8_t sig[8];
  static const uint8_t png_sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (fread(sig, 1, 8, f) != 8 || memcmp(sig, png_sig, 8) != 0) return img;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  for (;;) {
    uint8_t head[8];
    if (fread(head, 1, 8, f) != 8) break;
    uint32_t len = be32(head);
    char type[5] = {0};
    memcpy(type, head + 4, 4);
    std::vector<uint8_t> payload(len);
    if (len && fread(payload.data(), 1, len, f) != len) return img;
    fseek(f, 4, SEEK_CUR);  // CRC
    if (strcmp(type, "IHDR") == 0 && len >= 13) {
      w = be32(&payload[0]);
      h = be32(&payload[4]);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (strcmp(type, "IDAT") == 0) {
      idat.insert(idat.end(), payload.begin(), payload.end());
    } else if (strcmp(type, "IEND") == 0) {
      break;
    }
  }
  if (!w || !h || interlace != 0) return img;  // Adam7 unsupported
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return img;          // palette unsupported
  }
  if (bit_depth != 8 && bit_depth != 16) return img;

  size_t bpp = (size_t)channels * bit_depth / 8;        // bytes per pixel
  size_t stride = bpp * w;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf out_len = raw.size();
  if (uncompress(raw.data(), &out_len, idat.data(), idat.size()) != Z_OK)
    return img;

  // unfilter in place into `recon`
  std::vector<uint8_t> recon(stride * h);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &recon[y * stride];
    const uint8_t* up = y ? &recon[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return img;
      }
      dst[x] = (uint8_t)v;
    }
  }

  img.width = (int)w;
  img.height = (int)h;
  img.data.resize((size_t)w * h);
  size_t px_stride = bpp;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = &recon[y * stride];
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* p = row + x * px_stride;
      float v;
      if (bit_depth == 16) {
        // 16-bit: use the first channel's raw counts (depth maps)
        v = (float)((p[0] << 8) | p[1]);
      } else if (channels >= 3) {
        // ITU-R BT.601 luma like cv::cvtColor (reference drivers convert
        // RGB inputs to gray before tracking)
        v = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      } else {
        v = (float)p[0];
      }
      img.data[(size_t)y * w + x] = v;
    }
  }
  img.ok = true;
  return img;
}

Image load_any(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  int c0 = fgetc(f);
  int c1 = fgetc(f);
  fseek(f, 0, SEEK_SET);
  Image img;
  if (c0 == 'P' && (c1 == '2' || c1 == '5')) {
    img = load_pgm(f);
  } else {
    img = load_png(f);
  }
  fclose(f);
  return img;
}

// ---------------------------------------------------------- prefetcher -----

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<Image> queue;
  size_t next_submit = 0;
  size_t capacity = 4;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return stop.load() || (queue.size() < capacity && next_submit < paths.size()); });
        if (stop.load() || next_submit >= paths.size()) {
          if (next_submit >= paths.size()) return;
          continue;
        }
        idx = next_submit++;
      }
      Image img = load_any(paths[idx].c_str());
      {
        std::lock_guard<std::mutex> lk(mu);
        queue.push_back(std::move(img));
      }
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Decode one image. Returns a malloc'd float32 buffer (caller frees with
// slamio_free) and fills width/height; null on failure.
float* slamio_load_gray(const char* path, int* width, int* height) {
  Image img = load_any(path);
  if (!img.ok) return nullptr;
  float* out = (float*)malloc(img.data.size() * sizeof(float));
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  *width = img.width;
  *height = img.height;
  return out;
}

void slamio_free(float* p) { free(p); }

void* slamio_prefetch_start(const char** paths, int n, int capacity) {
  auto* pf = new Prefetcher();
  pf->paths.assign(paths, paths + n);
  pf->capacity = capacity > 0 ? (size_t)capacity : 4;
  pf->worker = std::thread([pf] { pf->run(); });
  return pf;
}

// Pop the next decoded image in submission order (blocking).
float* slamio_prefetch_next(void* handle, int* width, int* height) {
  auto* pf = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(pf->mu);
  pf->cv_pop.wait(lk, [&] { return !pf->queue.empty() || pf->stop.load(); });
  if (pf->queue.empty()) return nullptr;
  Image img = std::move(pf->queue.front());
  pf->queue.pop_front();
  lk.unlock();
  pf->cv_push.notify_one();
  if (!img.ok) {
    *width = *height = 0;
    return nullptr;
  }
  float* out = (float*)malloc(img.data.size() * sizeof(float));
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  *width = img.width;
  *height = img.height;
  return out;
}

void slamio_prefetch_stop(void* handle) {
  auto* pf = (Prefetcher*)handle;
  pf->stop.store(true);
  pf->cv_push.notify_all();
  pf->cv_pop.notify_all();
  if (pf->worker.joinable()) pf->worker.join();
  delete pf;
}

}  // extern "C"
