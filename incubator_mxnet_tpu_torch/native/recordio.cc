// RecordIO codec — C++ implementation of the dmlc RecordIO container.
//
// The port's copy of the JAX package's codec (the dmlc-core RecordIO
// container).  Byte-compatible with the reference .rec format and with
// ../recordio.py (the Python implementation):
//
//   uint32 kMagic = 0xced7230a
//   uint32 lrec   = (cflag << 29) | length
//   bytes  data[length] zero-padded to 4 bytes
//
// cflag: 0=whole 1=start 2=middle 3=end; payloads containing the magic
// are split into continuation records at each embedded magic.
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in image).

#include "recordio_core.h"

namespace {

struct Writer {
  FILE* f = nullptr;
};

struct Reader {
  FILE* f = nullptr;
  std::vector<char> buf;  // last assembled record
};

}  // namespace

extern "C" {

void* RecordIOWriterCreate(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int RecordIOWriterWrite(void* handle, const char* data, uint64_t size) {
  return recio::WriteRecord(static_cast<Writer*>(handle)->f, data, size);
}

int64_t RecordIOWriterTell(void* handle) {
  return ftell(static_cast<Writer*>(handle)->f);
}

void RecordIOWriterFree(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (w->f) fclose(w->f);
  delete w;
}

void* RecordIOReaderCreate(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  return r;
}

void RecordIOReaderSeek(void* handle, int64_t pos) {
  fseek(static_cast<Reader*>(handle)->f, pos, SEEK_SET);
}

int64_t RecordIOReaderTell(void* handle) {
  return ftell(static_cast<Reader*>(handle)->f);
}

// Read next logical record; returns length (>=0), -1 on EOF, -2 on
// corrupt stream. *out points into reader-owned storage valid until the
// next call.
int64_t RecordIOReaderNext(void* handle, const char** out) {
  auto* r = static_cast<Reader*>(handle);
  int64_t n = recio::ReadRecord(r->f, &r->buf);
  if (n >= 0) *out = r->buf.data();
  return n;
}

void RecordIOReaderFree(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->f) fclose(r->f);
  delete r;
}

}  // extern "C"
