// Threaded image-record pipeline — the host-side data engine.
//
// The port's copy of the JAX package's pipeline (the reference's C++
// ImageRecordIter stack: `src/io/iter_image_recordio_2.cc`,
// `image_aug_default.cc`, `iter_prefetcher.h`): sequential RecordIO
// read, multithreaded JPEG decode + augment (resize-shorter-side,
// random or center crop, horizontal mirror, mean/std normalize), and a
// double-buffered prefetch thread so the NEXT batch decodes while the
// trainer consumes the current one.  Output is a host batch that the
// Python side stages into pinned memory and copies to the card.
//
// Record payload layout: IRHeader (uint32 flag, float label, uint64 id,
// uint64 id2) followed by JPEG bytes — `recordio.pack_img` format.
//
// C ABI via ctypes.  The JPEG decode is libjpeg's by default, the same
// code and bits as the JAX package's build.  Built with -DMXT_NVJPEG it
// is nvJPEG's instead (the CUDA toolkit's decoder: Huffman decode on
// the host thread, IDCT and color conversion on the card, the RGB
// pixels copied back); everything after the decode is the same code.
// nvJPEG's IDCT and chroma upsampling round differently from libjpeg's,
// so its pixels differ from libjpeg's by a few levels.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#ifdef MXT_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#include <setjmp.h>
#endif

#include "recordio_core.h"

namespace {

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

struct Config {
  int batch, h, w, c;
  int threads;
  int shuffle;
  uint64_t seed;
  int rand_crop, rand_mirror;
  float mean[3], std[3];
  float scale;    // multiply raw pixel (e.g. 1/255)
  int layout;     // 0 = NCHW, 1 = NHWC
  int resize;     // shorter-side resize target; 0 = none
  int round_batch;  // 1 = wrap partial tail to epoch start (report pad)
};

#ifdef MXT_NVJPEG
// the card the decoders run on (`ImRecIterSetDevice`, before Create)
std::atomic<int> g_device{0};

// one decoder per worker thread: nvJPEG state, stream and device buffer
struct Decoder {
  nvjpegHandle_t handle = nullptr;   // shared, thread-safe
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t cap = 0;
  int device = 0;

  Decoder() = default;
  Decoder(const Decoder&) = delete;
  Decoder& operator=(const Decoder&) = delete;
  ~Decoder() {
    if (!handle) return;
    cudaSetDevice(device);
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }
};

// decode JPEG → RGB uint8 (h, w, 3) on the card, copied back to the
// host. Returns false on failure.
bool DecodeJpeg(Decoder* d, const unsigned char* buf, size_t size,
                std::vector<unsigned char>* out, int* oh, int* ow) {
  cudaSetDevice(d->device);
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(d->handle, buf, size, &nc, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  int w = widths[0], h = heights[0];
  size_t need = static_cast<size_t>(h) * w * 3;
  if (need > d->cap) {
    if (d->dbuf) cudaFree(d->dbuf);
    d->dbuf = nullptr;
    d->cap = 0;
    if (cudaMalloc(&d->dbuf, need) != cudaSuccess) return false;
    d->cap = need;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = d->dbuf;
  img.pitch[0] = static_cast<size_t>(w) * 3;
  if (nvjpegDecode(d->handle, d->state, buf, size, NVJPEG_OUTPUT_RGBI, &img,
                   d->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  out->resize(need);
  if (cudaMemcpyAsync(out->data(), d->dbuf, need, cudaMemcpyDeviceToHost,
                      d->stream) != cudaSuccess ||
      cudaStreamSynchronize(d->stream) != cudaSuccess)
    return false;
  *oh = h;
  *ow = w;
  return true;
}
#else
struct Decoder {};

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void ErrExit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jb, 1);
}

// decode JPEG → RGB uint8 (h, w, 3). Returns false on failure.
bool DecodeJpeg(Decoder*, const unsigned char* buf, size_t size,
                std::vector<unsigned char>* out, int* oh, int* ow) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = ErrExit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *oh = cinfo.output_height;
  *ow = cinfo.output_width;
  out->resize(static_cast<size_t>(*oh) * *ow * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->data() +
        static_cast<size_t>(cinfo.output_scanline) * *ow * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif

// bilinear resize RGB uint8
void Resize(const unsigned char* src, int sh, int sw,
            unsigned char* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    float fy = (dh > 1) ? static_cast<float>(y) * (sh - 1) / (dh - 1) : 0.f;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (dw > 1) ? static_cast<float>(x) * (sw - 1) / (dw - 1) : 0.f;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int ch = 0; ch < 3; ++ch) {
        float v =
            (1 - wy) * ((1 - wx) * src[(y0 * sw + x0) * 3 + ch] +
                        wx * src[(y0 * sw + x1) * 3 + ch]) +
            wy * ((1 - wx) * src[(y1 * sw + x0) * 3 + ch] +
                  wx * src[(y1 * sw + x1) * 3 + ch]);
        dst[(y * dw + x) * 3 + ch] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

// splitmix64 finalizer — decorrelates per-sample RNG seeds.
inline uint64_t Mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Iter {
  Config cfg;
  std::string path;              // .rec file; records are re-read per batch
  std::vector<int64_t> offsets;  // byte offset of each logical record
  std::vector<size_t> order;
  uint64_t epoch = 0;            // bumped on Reset: fresh augs per epoch
  int64_t slot_errors[2] = {0, 0};  // read failures per fill (mutex-ordered)
  std::atomic<int64_t> decode_failures{0};  // since Create, every epoch
  int slot_pad[2] = {0, 0};      // wrapped-sample count of a tail batch
  size_t cursor = 0;  // next record index (into order)
  std::mt19937_64 rng;
  std::vector<Decoder> decoders;  // one a worker thread
#ifdef MXT_NVJPEG
  nvjpegHandle_t nv_handle = nullptr;
#endif

  // double buffering
  std::vector<float> bufs[2];
  std::vector<float> label_bufs[2];
  int ready[2] = {0, 0};        // 1 = batch ready, -1 = epoch end
  int consumed_slot = 1;        // slot the consumer will read next (flip)
  std::thread prefetcher;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;
  bool filling = false;   // prefetcher is inside FillBatch
  bool exhausted = false; // epoch end observed; Next returns 0 until Reset
  int pending_slot = -1;  // slot the prefetcher should fill next

  ~Iter() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    if (prefetcher.joinable()) prefetcher.join();
#ifdef MXT_NVJPEG
    decoders.clear();  // their states before the handle they came from
    if (nv_handle) nvjpegDestroy(nv_handle);
#endif
  }

  // decode+augment one record into batch position i of dst; false when
  // the JPEG did not decode (the sample is zero-filled)
  bool Sample(const std::vector<char>& rec, float* dst, float* label,
              std::mt19937_64* lrng, Decoder* dec) {
    const auto* hdr = reinterpret_cast<const IRHeader*>(rec.data());
    size_t off = sizeof(IRHeader);
    *label = hdr->label;
    if (hdr->flag > 0) {  // multi-label: first label only in this path
      *label = *reinterpret_cast<const float*>(rec.data() + off);
      off += static_cast<size_t>(hdr->flag) * 4;
    }
    const auto* jpg = reinterpret_cast<const unsigned char*>(rec.data() + off);
    size_t jpg_size = rec.size() - off;
    std::vector<unsigned char> rgb;
    int ih = 0, iw = 0;
    if (!DecodeJpeg(dec, jpg, jpg_size, &rgb, &ih, &iw)) {
      std::memset(dst, 0, sizeof(float) * cfg.h * cfg.w * cfg.c);
      return false;
    }
    // shorter-side resize
    std::vector<unsigned char> resized;
    if (cfg.resize > 0 && (ih < iw ? ih : iw) != cfg.resize) {
      int nh, nw;
      if (ih < iw) { nh = cfg.resize; nw = static_cast<int>(1.0 * iw * cfg.resize / ih); }
      else { nw = cfg.resize; nh = static_cast<int>(1.0 * ih * cfg.resize / iw); }
      resized.resize(static_cast<size_t>(nh) * nw * 3);
      Resize(rgb.data(), ih, iw, resized.data(), nh, nw);
      rgb.swap(resized);
      ih = nh; iw = nw;
    }
    // pad up if still smaller than crop
    if (ih < cfg.h || iw < cfg.w) {
      int nh = ih < cfg.h ? cfg.h : ih, nw = iw < cfg.w ? cfg.w : iw;
      std::vector<unsigned char> padded(static_cast<size_t>(nh) * nw * 3, 0);
      for (int y = 0; y < ih; ++y)
        std::memcpy(&padded[static_cast<size_t>(y) * nw * 3],
                    &rgb[static_cast<size_t>(y) * iw * 3], iw * 3);
      rgb.swap(padded);
      ih = nh; iw = nw;
    }
    // crop
    int y0, x0;
    if (cfg.rand_crop) {
      y0 = static_cast<int>((*lrng)() % (ih - cfg.h + 1));
      x0 = static_cast<int>((*lrng)() % (iw - cfg.w + 1));
    } else {
      y0 = (ih - cfg.h) / 2;
      x0 = (iw - cfg.w) / 2;
    }
    bool mirror = cfg.rand_mirror && ((*lrng)() & 1);
    // normalize + layout
    for (int y = 0; y < cfg.h; ++y) {
      for (int x = 0; x < cfg.w; ++x) {
        int sx = mirror ? (cfg.w - 1 - x) : x;
        const unsigned char* px =
            &rgb[(static_cast<size_t>(y0 + y) * iw + (x0 + sx)) * 3];
        for (int ch = 0; ch < cfg.c; ++ch) {
          float v = px[ch % 3] * cfg.scale;
          v = (v - cfg.mean[ch % 3]) / cfg.std[ch % 3];
          size_t di = cfg.layout == 0
              ? (static_cast<size_t>(ch) * cfg.h + y) * cfg.w + x
              : (static_cast<size_t>(y) * cfg.w + x) * cfg.c + ch;
          dst[di] = v;
        }
      }
    }
    return true;
  }

  // fill one batch into slot; returns false at epoch end.
  // Streaming: each worker re-reads its records from disk (own FILE*,
  // seek to the indexed offset) — host RAM stays O(batch), not O(file),
  // unlike a load-everything design which OOMs on ImageNet-scale .rec.
  // round_batch: a partial tail wraps to the epoch start and reports
  // the wrapped count via slot_pad (ref round-robin overflow handling);
  // otherwise the tail is dropped.
  bool FillBatch(int slot) {
    size_t remaining = order.size() - cursor;
    if (remaining == 0) return false;
    int pad = 0;
    if (remaining < static_cast<size_t>(cfg.batch)) {
      if (!cfg.round_batch) return false;  // drop tail
      pad = cfg.batch - static_cast<int>(remaining);
    }
    // batch index list: tail wraps round-robin to the order[] start
    std::vector<size_t> batch_idx(cfg.batch);
    for (int i = 0; i < cfg.batch; ++i)
      batch_idx[i] = order[(cursor + i) % order.size()];
    cursor += cfg.batch - pad;
    float* data = bufs[slot].data();
    float* labels = label_bufs[slot].data();
    size_t sample_sz = static_cast<size_t>(cfg.h) * cfg.w * cfg.c;
    int nthreads = cfg.threads > 1 ? cfg.threads : 1;
    std::vector<std::thread> ts;
    std::atomic<int> next(0);
    std::atomic<int64_t> errs(0);
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        Decoder* dec = &decoders[t];
        FILE* f = fopen(path.c_str(), "rb");
        std::vector<char> rec;
        int i;
        while ((i = next.fetch_add(1)) < cfg.batch) {
          size_t ridx = batch_idx[i];
          // per-sample RNG: augmentation is a pure function of
          // (seed, record index, epoch) — independent of thread
          // scheduling, but fresh each epoch.
          std::mt19937_64 lrng(Mix64(cfg.seed ^ Mix64(ridx) ^
                                     Mix64(epoch * 0xA5A5A5A5ULL + 1)));
          if (!f || fseeko(f, static_cast<off_t>(offsets[ridx]), SEEK_SET) != 0 ||
              recio::ReadRecord(f, &rec) < 0) {
            std::memset(data + i * sample_sz, 0, sizeof(float) * sample_sz);
            labels[i] = 0.f;
            errs.fetch_add(1);
            continue;
          }
          if (!Sample(rec, data + i * sample_sz, labels + i, &lrng, dec)) {
            decode_failures.fetch_add(1);
#ifdef MXT_NVJPEG
            // nvJPEG fails on the card's state too (memory, stream),
            // not only on a corrupt record: never a silent black image
            errs.fetch_add(1);
#endif
          }
        }
        if (f) fclose(f);
      });
    }
    for (auto& th : ts) th.join();
    slot_errors[slot] = errs.load();  // published under mu with ready flag
    slot_pad[slot] = pad;
    return true;
  }

  void PrefetchLoop() {
    while (true) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || pending_slot >= 0; });
        if (stop) return;
        slot = pending_slot;
        pending_slot = -1;
        filling = true;
      }
      bool ok = FillBatch(slot);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[slot] = ok ? 1 : -1;
        filling = false;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ImRecIterCreate(const char* rec_path, int batch, int h, int w, int c,
                      int threads, int shuffle, uint64_t seed, int rand_crop,
                      int rand_mirror, const float* mean, const float* stdv,
                      float scale, int layout, int resize, int round_batch) {
  auto* it = new Iter();
  it->cfg = Config{batch, h, w, c, threads, shuffle, seed, rand_crop,
                   rand_mirror, {mean[0], mean[1], mean[2]},
                   {stdv[0], stdv[1], stdv[2]}, scale, layout, resize,
                   round_batch};
  it->rng.seed(seed);
  it->path = rec_path;
  FILE* f = fopen(rec_path, "rb");
  if (!f) {
    delete it;
    return nullptr;
  }
  // Index pass: record byte offsets only (O(16B/record) host RAM);
  // payloads are streamed back in per batch by the decode workers.
  std::vector<char> buf;
  while (true) {
    off_t pos = ftello(f);
    int64_t n = recio::ReadRecord(f, &buf);
    if (n == -1) break;  // clean EOF
    if (n < 0 || pos < 0) {  // corrupt stream (Python path raises too)
      fclose(f);
      delete it;
      return nullptr;
    }
    it->offsets.push_back(static_cast<int64_t>(pos));
  }
  fclose(f);
  it->order.resize(it->offsets.size());
  for (size_t i = 0; i < it->order.size(); ++i) it->order[i] = i;
  if (shuffle) std::shuffle(it->order.begin(), it->order.end(), it->rng);
  it->decoders = std::vector<Decoder>(threads > 1 ? threads : 1);
#ifdef MXT_NVJPEG
  {
    int dev = g_device.load(), prev = 0;
    cudaGetDevice(&prev);  // the caller's current card, restored below
    bool ok = cudaSetDevice(dev) == cudaSuccess &&
              nvjpegCreateSimple(&it->nv_handle) == NVJPEG_STATUS_SUCCESS;
    for (auto& d : it->decoders) {
      if (!ok) break;
      d.handle = it->nv_handle;
      d.device = dev;
      ok = nvjpegJpegStateCreate(d.handle, &d.state) ==
               NVJPEG_STATUS_SUCCESS &&
           cudaStreamCreateWithFlags(&d.stream, cudaStreamNonBlocking) ==
               cudaSuccess;
    }
    cudaSetDevice(prev);
    if (!ok) {
      delete it;
      return nullptr;
    }
  }
#endif
  size_t sample_sz = static_cast<size_t>(h) * w * c;
  for (int s = 0; s < 2; ++s) {
    it->bufs[s].resize(sample_sz * batch);
    it->label_bufs[s].resize(batch);
  }
  it->prefetcher = std::thread([it] { it->PrefetchLoop(); });
  // kick off the first batch
  {
    std::lock_guard<std::mutex> lk(it->mu);
    it->pending_slot = 0;
  }
  it->cv.notify_all();
  return it;
}

int64_t ImRecIterNumRecords(void* handle) {
  return static_cast<Iter*>(handle)->offsets.size();
}

// Copy next ready batch into out buffers.  Returns 1 ok, 0 epoch end,
// -1 streaming read failure in THIS batch, or in the nvJPEG build a
// decode failure (zero-filled samples — caller should raise rather
// than train on garbage).  *pad_out = number
// of wrapped samples when round_batch filled a tail batch.
int ImRecIterNext(void* handle, float* data_out, float* label_out,
                  int* pad_out) {
  auto* it = static_cast<Iter*>(handle);
  int slot = 1 - it->consumed_slot;
  {
    std::unique_lock<std::mutex> lk(it->mu);
    if (it->exhausted) return 0;  // repeated Next past epoch end: no hang
    it->cv.wait(lk, [&] { return it->ready[slot] != 0; });
    if (it->ready[slot] < 0) {
      it->ready[slot] = 0;
      it->exhausted = true;
      return 0;
    }
    it->ready[slot] = 0;
    if (it->slot_errors[slot] > 0) {
      // consume the bad batch and keep the pipeline moving — otherwise a
      // caller that catches the error and retries Next() waits forever on
      // a slot nothing will ever refill
      it->slot_errors[slot] = 0;
      if (pad_out) *pad_out = 0;
      it->consumed_slot = slot;
      it->pending_slot = 1 - slot;
      lk.unlock();
      it->cv.notify_all();
      return -1;
    }
    if (pad_out) *pad_out = it->slot_pad[slot];
  }
  std::memcpy(data_out, it->bufs[slot].data(),
              it->bufs[slot].size() * sizeof(float));
  std::memcpy(label_out, it->label_bufs[slot].data(),
              it->label_bufs[slot].size() * sizeof(float));
  it->consumed_slot = slot;
  // schedule the other slot
  {
    std::lock_guard<std::mutex> lk(it->mu);
    it->pending_slot = 1 - slot;
  }
  it->cv.notify_all();
  return 1;
}

void ImRecIterReset(void* handle) {
  auto* it = static_cast<Iter*>(handle);
  {
    std::unique_lock<std::mutex> lk(it->mu);
    // drain: no pending request and no fill in flight
    it->cv.wait(lk, [&] { return it->pending_slot < 0 && !it->filling; });
    it->cursor = 0;
    it->epoch += 1;
    it->ready[0] = it->ready[1] = 0;
    it->slot_errors[0] = it->slot_errors[1] = 0;
    it->slot_pad[0] = it->slot_pad[1] = 0;
    it->exhausted = false;
    if (it->cfg.shuffle) std::shuffle(it->order.begin(), it->order.end(), it->rng);
    it->consumed_slot = 1;
    it->pending_slot = 0;
  }
  it->cv.notify_all();
}

void ImRecIterFree(void* handle) { delete static_cast<Iter*>(handle); }

// Samples whose JPEG did not decode since Create (zero-filled; in the
// nvJPEG build their batch also fails, `ImRecIterNext` returning -1).
int64_t ImRecIterDecodeFailures(void* handle) {
  return static_cast<Iter*>(handle)->decode_failures.load();
}

// Which decoder this build holds: 0 libjpeg, 1 nvJPEG.
int ImRecIterDecoder() {
#ifdef MXT_NVJPEG
  return 1;
#else
  return 0;
#endif
}

#ifdef MXT_NVJPEG
// The card later iterators decode on (default 0).
void ImRecIterSetDevice(int device) { g_device.store(device); }
#endif

}  // extern "C"
