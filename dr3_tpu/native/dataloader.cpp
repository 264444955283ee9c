// Native image-sequence loader: threaded PNG/JPEG decode with ordered
// prefetch.
//
// Runtime role: the reference's pipelines read frames synchronously on the
// processing thread (reference tests/slam/test_slam.cc:15-44 loads every
// KITTI frame with cv::imread inline; src/utils.cpp:91-109 load_image).
// The decode must overlap device compute, so this loader runs
// a worker pool that decodes ahead into a bounded ring of slots and hands
// frames to Python strictly in order, as float32 grayscale in [0, 1].
//
// C API (ctypes-friendly):
//   dl_open(paths, n_paths, n_threads, capacity) -> handle
//   dl_next(handle, &data_ptr, &h, &w)           -> frame index or -1 at end
//   dl_release(handle)                            (frees the slot just read)
//   dl_close(handle)
//
// Build: make -C dr3_tpu/native   (g++ + libpng + libjpeg + zlib)

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int h = 0, w = 0;
  bool ok = false;
};

struct CsvReader;  // unused; placeholder to keep headers minimal

bool decode_png(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit grayscale
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_PALETTE ||
      color_type == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<uint8_t> row(w);
  out->data.resize(size_t(w) * h);
  out->h = int(h);
  out->w = int(w);
  const float scale = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + size_t(y) * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = row[x] * scale;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  out->ok = true;
  return true;
}

bool decode_jpeg(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  out->data.resize(size_t(w) * h);
  out->h = h;
  out->w = w;
  std::vector<uint8_t> row(w);
  uint8_t* rowp = row.data();
  const float scale = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->data.data() + size_t(y) * w;
    for (int x = 0; x < w; ++x) dst[x] = row[x] * scale;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  out->ok = true;
  return true;
}

bool decode_any(const std::string& path, Frame* out) {
  auto dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot);
  for (auto& c : ext) c = char(tolower(c));
  if (ext == ".jpg" || ext == ".jpeg") return decode_jpeg(path.c_str(), out);
  return decode_png(path.c_str(), out);
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<Frame> slots;         // capacity-bounded ring, slot i holds
  std::vector<std::atomic<int>> state;  // frame state: 0 empty, 1 ready
  size_t capacity;
  std::atomic<size_t> next_to_decode{0};
  size_t next_to_read = 0;
  Frame current;                    // frame handed to Python
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};

  Loader(std::vector<std::string> p, int n_threads, int cap)
      : paths(std::move(p)),
        slots(cap),
        state(cap),
        capacity(size_t(cap)) {
    for (auto& s : state) s.store(0);
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    while (!stop.load()) {
      size_t idx = next_to_decode.fetch_add(1);
      if (idx >= paths.size()) return;
      Frame f;
      decode_any(paths[idx], &f);
      size_t slot = idx % capacity;
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until the consumer has drained this slot's previous round
        cv_space.wait(lk, [&] {
          return stop.load() || idx < next_to_read + capacity;
        });
        if (stop.load()) return;
        slots[slot] = std::move(f);
        state[slot].store(1);
      }
      cv_ready.notify_all();
    }
  }

  // returns frame index, or -1 when the sequence is exhausted
  long next(const float** data, int* h, int* w) {
    if (next_to_read >= paths.size()) return -1;
    size_t idx = next_to_read;
    size_t slot = idx % capacity;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return state[slot].load() == 1; });
      current = std::move(slots[slot]);
      state[slot].store(0);
      next_to_read = idx + 1;
    }
    cv_space.notify_all();
    if (!current.ok) {
      *data = nullptr;
      *h = *w = 0;
    } else {
      *data = current.data.data();
      *h = current.h;
      *w = current.w;
    }
    return long(idx);
  }

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

void* dl_open(const char** paths, int n_paths, int n_threads, int capacity) {
  std::vector<std::string> p(paths, paths + n_paths);
  if (capacity < 2) capacity = 2;
  if (n_threads < 1) n_threads = 1;
  return new Loader(std::move(p), n_threads, capacity);
}

long dl_next(void* handle, const float** data, int* h, int* w) {
  return static_cast<Loader*>(handle)->next(data, h, w);
}

void dl_close(void* handle) { delete static_cast<Loader*>(handle); }

// single-image synchronous decode (load_image parity)
int dl_decode(const char* path, float* out, int max_elems, int* h, int* w) {
  Frame f;
  if (!decode_any(path, &f)) return -1;
  if (int(f.data.size()) > max_elems) return -2;
  memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  *h = f.h;
  *w = f.w;
  return 0;
}

}  // extern "C"
