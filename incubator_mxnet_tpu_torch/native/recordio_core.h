// Header-only RecordIO core shared by recordio.cc (C ABI codec) and
// image_pipeline.cc (threaded data pipeline).  Format notes in
// recordio.cc.  The JAX package carries the same file; the .rec files
// both write are byte-identical.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace recio {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

inline size_t Pad4(size_t n) { return (4 - n % 4) % 4; }

inline size_t FindMagic(const char* data, size_t size, size_t start) {
  const char m[4] = {static_cast<char>(0x0a), static_cast<char>(0x23),
                     static_cast<char>(0xd7), static_cast<char>(0xce)};
  for (size_t i = start; i + 4 <= size; ++i) {
    if (memcmp(data + i, m, 4) == 0) return i;
  }
  return static_cast<size_t>(-1);
}

// Append-one-logical-record (with embedded-magic splitting). 0 on ok.
inline int WriteRecord(FILE* f, const char* data, uint64_t size) {
  std::vector<std::pair<size_t, size_t>> parts;
  size_t start = 0;
  while (true) {
    size_t i = FindMagic(data, size, start);
    if (i == static_cast<size_t>(-1)) {
      parts.emplace_back(start, size - start);
      break;
    }
    parts.emplace_back(start, i - start);
    start = i + 4;
  }
  size_t n = parts.size();
  for (size_t i = 0; i < n; ++i) {
    uint32_t cflag = 0;
    if (n > 1) cflag = (i == 0) ? 1 : (i == n - 1 ? 3 : 2);
    uint32_t len = static_cast<uint32_t>(parts[i].second);
    uint32_t lrec = (cflag << 29) | len;
    if (fwrite(&kMagic, 4, 1, f) != 1) return -1;
    if (fwrite(&lrec, 4, 1, f) != 1) return -1;
    if (len && fwrite(data + parts[i].first, 1, len, f) != len) return -1;
    static const char zeros[4] = {0, 0, 0, 0};
    size_t pad = Pad4(len);
    if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  }
  return 0;
}

// Read next logical record into buf. Returns length >=0, -1 EOF, -2 corrupt.
inline int64_t ReadRecord(FILE* f, std::vector<char>* buf) {
  buf->clear();
  bool in_continuation = false;
  while (true) {
    uint32_t header[2];
    if (fread(header, 4, 2, f) != 2) {
      if (buf->empty()) return -1;
      return static_cast<int64_t>(buf->size());
    }
    if (header[0] != kMagic) return -2;
    uint32_t cflag = header[1] >> 29;
    uint32_t len = header[1] & kLenMask;
    size_t off = buf->size();
    if (in_continuation) {
      const char m[4] = {static_cast<char>(0x0a), static_cast<char>(0x23),
                         static_cast<char>(0xd7), static_cast<char>(0xce)};
      buf->insert(buf->end(), m, m + 4);
      off = buf->size();
    }
    buf->resize(off + len);
    if (len && fread(buf->data() + off, 1, len, f) != len) return -2;
    size_t pad = Pad4(len);
    if (pad) fseek(f, static_cast<long>(pad), SEEK_CUR);
    if (cflag == 0 || cflag == 3) return static_cast<int64_t>(buf->size());
    in_continuation = true;
  }
}

}  // namespace recio
