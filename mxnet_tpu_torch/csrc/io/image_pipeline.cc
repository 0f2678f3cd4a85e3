/* The port's own copy of native/image_pipeline.cc (mxnet_tpu_torch/_native.py builds it). */
/* ImageRecordIter native pipeline — threaded decode/augment/batch.
 *
 * Native equivalent of the reference's C++ data path
 * (ref behavior: src/io/iter_image_recordio_2.cc ImageRecordIOParser2 —
 * parallel JPEG decode + per-thread augmenters; src/io/iter_batchloader.h
 * BatchLoader; src/io/iter_prefetcher.h PrefetcherIter double buffering).
 *
 * Architecture: a pool of worker threads pulls record indices from an
 * atomic cursor, reads the record via its own file handle (seek-based
 * random access over the .rec file), JPEG-decodes with libjpeg, augments
 * (resize / crop / mirror / normalize), and writes float32 CHW pixels
 * directly into one of a small ring of pinned host batch buffers.  The
 * consumer (Python) pops completed batches in batch order; at most
 * `n_buffers` batches are in flight, giving the same bounded prefetch as
 * the reference's ThreadedIter.
 *
 * Record payload layout (ref: python/mxnet/recordio.py IRHeader, struct
 * 'IfQQ'): [flag:u32][label:f32][id:u64][id2:u64] then, if flag>0,
 * flag extra f32 labels, then the image bytes (JPEG, or raw HWC u8 whose
 * size is exactly h*w*c).
 */
#include <cstddef>
#include <cstdio>

/* Built with -DMXTPU_IO_NO_JPEG where libjpeg's headers are missing:
 * then only raw HWC u8 payloads decode (mxnet_tpu_torch/_native.py). */
#ifndef MXTPU_IO_NO_JPEG
#include <jpeglib.h>
#include <setjmp.h>
#endif

#include <atomic>
#include <algorithm>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "recordio.h"

namespace {

thread_local std::string g_iter_error;

/* ------------------------------------------------------------------ */
/* jpeg decode                                                         */
/* ------------------------------------------------------------------ */
#ifndef MXTPU_IO_NO_JPEG
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void JpegErrExit(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(err->jmp, 1);
}

// decode to RGB u8, returns false on corrupt data
bool DecodeJpeg(const unsigned char *buf, size_t size,
                std::vector<unsigned char> *out, int *w, int *h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrExit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char *>(buf),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char *row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif  // MXTPU_IO_NO_JPEG

/* bilinear resize RGB u8 (src HWC) into dst of (dw, dh) */
void ResizeBilinear(const unsigned char *src, int sw, int sh,
                    unsigned char *dst, int dw, int dh) {
  const float sx = dw > 1 ? float(sw - 1) / (dw - 1) : 0.f;
  const float sy = dh > 1 ? float(sh - 1) / (dh - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * sy;
    int y0 = int(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * sx;
      int x0 = int(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(size_t(y0) * sw + x0) * 3 + c];
        float v01 = src[(size_t(y0) * sw + x1) * 3 + c];
        float v10 = src[(size_t(y1) * sw + x0) * 3 + c];
        float v11 = src[(size_t(y1) * sw + x1) * 3 + c];
        float v0 = v00 * (1 - wx) + v01 * wx;
        float v1 = v10 * (1 - wx) + v11 * wx;
        dst[(size_t(y) * dw + x) * 3 + c] =
            static_cast<unsigned char>(v0 * (1 - wy) + v1 * wy + 0.5f);
      }
    }
  }
}

/* ------------------------------------------------------------------ */
/* the iterator                                                        */
/* ------------------------------------------------------------------ */
struct ImageIterCfg {
  int batch, c, h, w;
  int shuffle, rand_crop, rand_mirror;
  float mean[3], std[3];
  int nthreads, seed, label_width;
  int resize_shorter;  // 0 = crop when source >= target, else resize
  int round_batch;
  int out_u8;  // emit raw uint8 CHW (normalization deferred to device)
};

struct BatchBuf {
  std::vector<float> data;      // batch*c*h*w (float path)
  std::vector<uint8_t> data_u8; // batch*c*h*w (uint8 path)
  std::vector<float> label;     // batch*label_width
  int filled = 0;
  bool ready = false;
};

struct ImageIter {
  ImageIterCfg cfg;
  std::string rec_path;
  std::string idx_path;
  std::vector<size_t> offsets;  // record start offsets
  std::vector<size_t> order;    // epoch order (item -> record id)
  size_t n_items = 0;           // items this epoch (incl. padded tail)
  size_t last_pad = 0;          // pad count of the final batch

  int n_buffers = 0;
  std::vector<BatchBuf> buffers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<size_t> cursor{0};
  size_t consumed = 0;   // batches handed to the consumer
  size_t n_batches = 0;
  int handed_out = -1;   // buffer the consumer currently reads
  bool abort_flag = false;
  std::string worker_error;
  std::vector<std::thread> workers;
  int epoch = 0;

  ~ImageIter() { StopWorkers(); }

  void StopWorkers() {
    {
      std::lock_guard<std::mutex> l(mu);
      abort_flag = true;
    }
    cv_free.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    abort_flag = false;
  }

  bool LoadIndex() {
    // .idx sidecar: "key\tpos\n" per record (tools/im2rec format); avoids a
    // full sequential scan of the .rec at construction
    FILE *fp = fopen(idx_path.c_str(), "r");
    if (!fp) return false;
    offsets.clear();
    char line[256];
    while (fgets(line, sizeof(line), fp)) {
      // skip blank trailing line only; any other malformed line means a
      // truncated/corrupt index — fail so ScanOffsets falls back to the .rec
      if (line[0] == '\n' || line[0] == '\0') continue;
      char *tab = strchr(line, '\t');
      if (!tab) {
        fclose(fp);
        return false;
      }
      char *endp = nullptr;
      unsigned long long off = strtoull(tab + 1, &endp, 10);
      if (endp == tab + 1 || (*endp != '\n' && *endp != '\r' &&
                              *endp != '\0')) {
        fclose(fp);
        return false;
      }
      offsets.push_back(off);
    }
    fclose(fp);
    std::sort(offsets.begin(), offsets.end());
    return !offsets.empty();
  }

  bool ScanOffsets() {
    if (!idx_path.empty() && LoadIndex()) return true;
    RecordIOHandle r;
    if (MXTPURecordIOReaderCreate(rec_path.c_str(), &r) != 0) return false;
    offsets.clear();
    for (;;) {
      size_t pos;
      MXTPURecordIOReaderTell(r, &pos);
      const char *buf;
      size_t size;
      int rc = MXTPURecordIOReaderRead(r, &buf, &size);
      if (rc < 0) {
        MXTPURecordIOReaderFree(r);
        return false;
      }
      if (rc == 0) break;
      offsets.push_back(pos);
    }
    MXTPURecordIOReaderFree(r);
    return true;
  }

  void BuildOrder() {
    size_t n = offsets.size();
    order.resize(n);
    for (size_t i = 0; i < n; ++i) order[i] = i;
    if (cfg.shuffle) {
      std::mt19937_64 rng(uint64_t(cfg.seed) * 2654435761u + epoch);
      std::shuffle(order.begin(), order.end(), rng);
    }
    last_pad = 0;
    if (n == 0) {
      n_items = n_batches = 0;
      return;
    }
    if (n % cfg.batch) {
      // every record is emitted exactly once per epoch; the short tail is
      // padded and the pad count reported so the consumer can mask it
      // (ref: iter_batchloader.h num_batch_padd)
      size_t pad = cfg.batch - n % cfg.batch;
      last_pad = pad;
      for (size_t i = 0; i < pad; ++i) {
        // round_batch wraps with records from the epoch start; otherwise
        // repeat the final record (pure padding)
        order.push_back(cfg.round_batch ? order[i % n] : order[n - 1]);
      }
    }
    n_items = order.size();
    n_batches = n_items / cfg.batch;
  }

  void Start() {
    BuildOrder();
    cursor = 0;
    consumed = 0;
    handed_out = -1;
    worker_error.clear();
    for (auto &b : buffers) {
      b.filled = 0;
      b.ready = false;
    }
    int nt = std::max(1, cfg.nthreads);
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([this] { WorkerLoop(); });
  }

  void WorkerLoop() {
    RecordIOHandle reader = nullptr;
    if (MXTPURecordIOReaderCreate(rec_path.c_str(), &reader) != 0) {
      std::lock_guard<std::mutex> l(mu);
      worker_error = MXTPURecordIOGetLastError();
      cv_ready.notify_all();
      return;
    }
    std::vector<unsigned char> pixels, resized, cropped;
    for (;;) {
      size_t i = cursor.fetch_add(1);
      if (i >= n_items) break;
      size_t batch_id = i / cfg.batch;
      int slot = int(batch_id % n_buffers);
      {
        std::unique_lock<std::mutex> l(mu);
        cv_free.wait(l, [&] {
          return abort_flag || batch_id < consumed + size_t(n_buffers);
        });
        if (abort_flag) break;
      }
      std::string err;
      if (!ProcessItem(reader, i, slot, &pixels, &resized, &cropped, &err)) {
        std::lock_guard<std::mutex> l(mu);
        if (worker_error.empty()) worker_error = err;
        cv_ready.notify_all();
        break;
      }
      {
        std::lock_guard<std::mutex> l(mu);
        if (++buffers[slot].filled == cfg.batch) {
          buffers[slot].ready = true;
          cv_ready.notify_all();
        }
      }
    }
    if (reader) MXTPURecordIOReaderFree(reader);
  }

  bool ProcessItem(RecordIOHandle reader, size_t item, int slot,
                   std::vector<unsigned char> *pixels,
                   std::vector<unsigned char> *resized,
                   std::vector<unsigned char> *cropped, std::string *err) {
    size_t rec_id = order[item];
    if (MXTPURecordIOReaderSeek(reader, offsets[rec_id]) != 0 ||
        [&] {
          const char *buf;
          size_t size;
          if (MXTPURecordIOReaderRead(reader, &buf, &size) != 1 || size == 0)
            return false;
          return ParseAndDecode(buf, size, item, slot, pixels, resized,
                                cropped, err);
        }() == false) {
      if (err->empty()) *err = "record read failed";
      return false;
    }
    return true;
  }

  bool ParseAndDecode(const char *buf, size_t size, size_t item, int slot,
                      std::vector<unsigned char> *pixels,
                      std::vector<unsigned char> *resized,
                      std::vector<unsigned char> *cropped, std::string *err) {
    if (size < 24) {
      *err = "record too small for IRHeader";
      return false;
    }
    uint32_t flag;
    float label0;
    memcpy(&flag, buf, 4);
    memcpy(&label0, buf + 4, 4);
    size_t off = 24;
    BatchBuf &bb = buffers[slot];
    size_t in_batch = item % cfg.batch;
    float *lab = bb.label.data() + in_batch * cfg.label_width;
    if (flag > 0) {
      if (size < off + 4 * size_t(flag)) {
        *err = "record too small for extra labels";
        return false;
      }
      for (int j = 0; j < cfg.label_width; ++j) {
        if (j < int(flag))
          memcpy(&lab[j], buf + off + 4 * j, 4);
        else
          lab[j] = 0.f;
      }
      off += 4 * size_t(flag);
    } else {
      lab[0] = label0;
      for (int j = 1; j < cfg.label_width; ++j) lab[j] = 0.f;
    }

    const unsigned char *img =
        reinterpret_cast<const unsigned char *>(buf) + off;
    size_t img_size = size - off;
    int sw, sh;
    int src_ch = 3;  // jpeg decodes to RGB; raw payloads carry cfg.c planes
    const unsigned char *src;
    if (img_size == size_t(cfg.h) * cfg.w * cfg.c) {
      // raw passthrough (HWC u8, already target shape)
      src = img;
      sw = cfg.w;
      sh = cfg.h;
      src_ch = cfg.c;
    } else if (img_size >= 2 && img[0] == 0xFF && img[1] == 0xD8) {
#ifdef MXTPU_IO_NO_JPEG
      *err = "jpeg decode not built: libjpeg's headers were missing at "
             "build time (raw h*w*c payloads only)";
      return false;
#else
      if (!DecodeJpeg(img, img_size, pixels, &sw, &sh)) {
        *err = "jpeg decode failed";
        return false;
      }
#endif
      src = pixels->data();
    } else {
      *err = "unsupported image payload (expect JPEG or raw h*w*c bytes)";
      return false;
    }

    // per-item deterministic rng: seed x epoch x record
    std::mt19937 rng(uint32_t(cfg.seed) ^ (uint32_t(epoch) << 20) ^
                     uint32_t(order[item]));

    // geometry to (h, w).  When no shorter-side resize is requested and
    // the source is at least target-sized, CROP directly from the
    // decoded pixels (random or center) — this is both the reference
    // augmenter's semantic (rand_crop crops, it does not squash) and
    // ~10x cheaper than the bilinear resample it replaces: the resample
    // is only paid when the geometry actually requires one.
    int tw = cfg.w, th = cfg.h;
    const unsigned char *plane = src;
    if (cfg.resize_shorter == 0 && sw >= tw && sh >= th && src_ch == 3) {
      if (sw != tw || sh != th) {
        int x0, y0;
        if (cfg.rand_crop) {
          x0 = sw > tw ? int(rng() % uint32_t(sw - tw + 1)) : 0;
          y0 = sh > th ? int(rng() % uint32_t(sh - th + 1)) : 0;
        } else {
          x0 = (sw - tw) / 2;
          y0 = (sh - th) / 2;
        }
        cropped->resize(size_t(tw) * th * 3);
        for (int y = 0; y < th; ++y)
          memcpy(cropped->data() + size_t(y) * tw * 3,
                 src + (size_t(y + y0) * sw + x0) * 3, size_t(tw) * 3);
        plane = cropped->data();
      }
    } else if (sw != tw || sh != th) {
      int rw, rh;
      if (cfg.resize_shorter > 0) {
        // scale shorter side to resize_shorter, keep aspect
        if (sw < sh) {
          rw = cfg.resize_shorter;
          rh = std::max(th, int(float(sh) * rw / sw + 0.5f));
        } else {
          rh = cfg.resize_shorter;
          rw = std::max(tw, int(float(sw) * rh / sh + 0.5f));
        }
        rw = std::max(rw, tw);
        rh = std::max(rh, th);
      } else {
        rw = tw;
        rh = th;
      }
      resized->resize(size_t(rw) * rh * 3);
      ResizeBilinear(src, sw, sh, resized->data(), rw, rh);
      if (rw != tw || rh != th) {
        int x0, y0;
        if (cfg.rand_crop) {
          x0 = rw > tw ? int(rng() % uint32_t(rw - tw + 1)) : 0;
          y0 = rh > th ? int(rng() % uint32_t(rh - th + 1)) : 0;
        } else {
          x0 = (rw - tw) / 2;
          y0 = (rh - th) / 2;
        }
        cropped->resize(size_t(tw) * th * 3);
        for (int y = 0; y < th; ++y)
          memcpy(cropped->data() + size_t(y) * tw * 3,
                 resized->data() + (size_t(y + y0) * rw + x0) * 3,
                 size_t(tw) * 3);
        plane = cropped->data();
      } else {
        plane = resized->data();
      }
    }

    bool mirror = cfg.rand_mirror && (rng() & 1u);

    if (cfg.out_u8) {
      // HWC u8 → CHW u8, no float math: normalization happens on the
      // accelerator where the cast fuses into the first conv (and the
      // host->device transfer is 4x smaller than float32)
      uint8_t *dst8 = bb.data_u8.data() + in_batch * size_t(cfg.c) * th * tw;
      if (cfg.c == 1 && src_ch >= 3) {
        // same BT.601 luma as the float path: dtype must never change
        // what pixels a grayscale pipeline sees
        for (int y = 0; y < th; ++y) {
          for (int x = 0; x < tw; ++x) {
            int sx = mirror ? tw - 1 - x : x;
            const uint8_t *px = plane + (size_t(y) * tw + sx) * src_ch;
            float luma = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
            dst8[size_t(y) * tw + x] = uint8_t(luma + 0.5f);
          }
        }
        return true;
      }
      for (int ch = 0; ch < cfg.c; ++ch) {
        int sc = std::min(ch, src_ch - 1);
        for (int y = 0; y < th; ++y) {
          const uint8_t *row = plane + size_t(y) * tw * src_ch;
          uint8_t *orow = dst8 + (size_t(ch) * th + y) * tw;
          if (mirror) {
            for (int x = 0; x < tw; ++x)
              orow[x] = row[size_t(tw - 1 - x) * src_ch + sc];
          } else {
            for (int x = 0; x < tw; ++x)
              orow[x] = row[size_t(x) * src_ch + sc];
          }
        }
      }
      return true;
    }

    // HWC u8 → CHW f32 normalized into the batch buffer
    float *dst = bb.data.data() + in_batch * size_t(cfg.c) * th * tw;
    if (cfg.c == 1 && src_ch >= 3) {
      // grayscale target from a color decode: BT.601 luma, matching the
      // reference's grayscale imdecode path (iter_image_recordio_2.cc)
      float mean = cfg.mean[0], inv = cfg.std[0] != 0.f ? 1.f / cfg.std[0] : 1.f;
      for (int y = 0; y < th; ++y) {
        for (int x = 0; x < tw; ++x) {
          int sx = mirror ? tw - 1 - x : x;
          const uint8_t *px = plane + (size_t(y) * tw + sx) * src_ch;
          float luma = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
          dst[size_t(y) * tw + x] = (luma - mean) * inv;
        }
      }
      return true;
    }
    for (int ch = 0; ch < cfg.c; ++ch) {
      int sc = std::min(ch, src_ch - 1);
      float mean = cfg.mean[ch % 3], stdv = cfg.std[ch % 3];
      float inv = stdv != 0.f ? 1.f / stdv : 1.f;
      for (int y = 0; y < th; ++y) {
        for (int x = 0; x < tw; ++x) {
          int sx = mirror ? tw - 1 - x : x;
          dst[(size_t(ch) * th + y) * tw + x] =
              (float(plane[(size_t(y) * tw + sx) * src_ch + sc]) - mean) * inv;
        }
      }
    }
    return true;
  }

  /* returns 1 with pointers, 0 at epoch end, -1 error */
  int Next(void **data, float **label, int *pad) {
    std::unique_lock<std::mutex> l(mu);
    // release the buffer from the previous Next()
    if (handed_out >= 0) {
      buffers[handed_out].filled = 0;
      buffers[handed_out].ready = false;
      handed_out = -1;
      ++consumed;
      cv_free.notify_all();
    }
    if (consumed == n_batches) return 0;
    int slot = int(consumed % n_buffers);
    cv_ready.wait(l, [&] {
      return buffers[slot].ready || !worker_error.empty();
    });
    if (!worker_error.empty()) {
      g_iter_error = worker_error;
      return -1;
    }
    handed_out = slot;
    *data = cfg.out_u8 ? static_cast<void *>(buffers[slot].data_u8.data())
                       : static_cast<void *>(buffers[slot].data.data());
    *label = buffers[slot].label.data();
    *pad = (consumed + 1 == n_batches) ? int(last_pad) : 0;
    return 1;
  }

  void Reset() {
    StopWorkers();
    ++epoch;
    Start();
  }
};

}  // namespace

extern "C" {

typedef void *ImageIterHandle;

const char *MXTPUImageIterGetLastError(void) { return g_iter_error.c_str(); }

/* 1 when this build decodes JPEG payloads, 0 for a raw-only build */
int MXTPUImageIterHasJpeg(void) {
#ifdef MXTPU_IO_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

int MXTPUImageIterCreateEx(const char *rec_path, const char *idx_path,
                           int batch, int c, int h, int w,
                           int shuffle, int rand_crop, int rand_mirror,
                           const float *mean, const float *std_, int nthreads,
                           int seed, int label_width, int resize_shorter,
                           int round_batch, int prefetch_buffers,
                           int out_u8, ImageIterHandle *out) {
  if (out_u8) {
    for (int i = 0; i < 3; ++i) {
      if (mean[i] != 0.f || std_[i] != 1.f) {
        g_iter_error = "uint8 output requires identity normalization "
                       "(mean=0, std=1): normalize on the accelerator";
        return -1;
      }
    }
  }
  auto *it = new ImageIter();
  it->cfg = ImageIterCfg{batch,     c,         h,
                         w,         shuffle,   rand_crop,
                         rand_mirror, {mean[0], mean[1], mean[2]},
                         {std_[0], std_[1], std_[2]},
                         nthreads,  seed,      label_width,
                         resize_shorter, round_batch, out_u8};
  it->rec_path = rec_path;
  it->idx_path = idx_path ? idx_path : "";
  if (!it->ScanOffsets()) {
    g_iter_error = MXTPURecordIOGetLastError();
    delete it;
    return -1;
  }
  it->n_buffers = std::max(2, prefetch_buffers);
  it->buffers.resize(it->n_buffers);
  for (auto &b : it->buffers) {
    if (out_u8)
      b.data_u8.resize(size_t(batch) * c * h * w);
    else
      b.data.resize(size_t(batch) * c * h * w);
    b.label.resize(size_t(batch) * label_width);
  }
  it->Start();
  *out = it;
  return 0;
}

int MXTPUImageIterCreate(const char *rec_path, const char *idx_path,
                         int batch, int c, int h, int w,
                         int shuffle, int rand_crop, int rand_mirror,
                         const float *mean, const float *std_, int nthreads,
                         int seed, int label_width, int resize_shorter,
                         int round_batch, int prefetch_buffers,
                         ImageIterHandle *out) {
  return MXTPUImageIterCreateEx(rec_path, idx_path, batch, c, h, w, shuffle,
                                rand_crop, rand_mirror, mean, std_, nthreads,
                                seed, label_width, resize_shorter, round_batch,
                                prefetch_buffers, /*out_u8=*/0, out);
}

int MXTPUImageIterNumRecords(ImageIterHandle h, size_t *n) {
  *n = static_cast<ImageIter *>(h)->offsets.size();
  return 0;
}

int MXTPUImageIterNext(ImageIterHandle h, float **data, float **label,
                       int *pad) {
  return static_cast<ImageIter *>(h)->Next(
      reinterpret_cast<void **>(data), label, pad);
}

/* like Next but typeless data pointer (uint8 pipelines) */
int MXTPUImageIterNextEx(ImageIterHandle h, void **data, float **label,
                         int *pad) {
  return static_cast<ImageIter *>(h)->Next(data, label, pad);
}

int MXTPUImageIterReset(ImageIterHandle h) {
  static_cast<ImageIter *>(h)->Reset();
  return 0;
}

int MXTPUImageIterFree(ImageIterHandle h) {
  delete static_cast<ImageIter *>(h);
  return 0;
}

}  // extern "C"
