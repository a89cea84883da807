// Copy of paddle_tpu/native/src/recordio.cc (the port keeps its own).
// RecordIO: chunked, CRC-checked record file format.
//
// Reference: paddle/fluid/recordio/{header,chunk,writer,scanner}.{h,cc} —
// same layout concepts: a file is a sequence of chunks; each chunk has a
// header {magic, num_records, compressor, checksum, payload_size} followed
// by the payload of length-prefixed records.  Compression (snappy/gzip in
// the reference) is declared in the header; this implementation writes
// kNoCompress and rejects compressed chunks it cannot decode (the data
// path feeds from local uncompressed shards).
//
// C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagicNumber = 0x01020304;  // header.h:23
constexpr uint32_t kNoCompress = 0;

// CRC32 (IEEE, zlib-compatible), small table implementation.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_update(uint32_t crc, const unsigned char* buf, size_t len) {
  crc_init();
  crc = crc ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<std::string> records;
  size_t pending_bytes = 0;
  size_t max_chunk_records;
  size_t max_chunk_bytes;

  bool flush_chunk() {
    if (records.empty()) return true;
    std::string payload;
    payload.reserve(pending_bytes + records.size() * 4);
    for (const auto& r : records) {
      uint32_t len = static_cast<uint32_t>(r.size());
      payload.append(reinterpret_cast<const char*>(&len), 4);
      payload.append(r);
    }
    uint32_t crc = crc32_update(
        0, reinterpret_cast<const unsigned char*>(payload.data()),
        payload.size());
    uint32_t header[5] = {kMagicNumber,
                          static_cast<uint32_t>(records.size()), kNoCompress,
                          crc, static_cast<uint32_t>(payload.size())};
    if (fwrite(header, sizeof(header), 1, f) != 1) return false;
    if (!payload.empty() &&
        fwrite(payload.data(), payload.size(), 1, f) != 1)
      return false;
    records.clear();
    pending_bytes = 0;
    return true;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<std::string> chunk_records;  // records of the current chunk
  size_t cursor = 0;                       // next record within chunk
  bool error = false;

  // loads the next chunk; returns false on eof or error
  bool load_chunk() {
    uint32_t header[5];
    size_t got = fread(header, sizeof(uint32_t), 5, f);
    if (got == 0) return false;  // clean EOF
    if (got != 5 || header[0] != kMagicNumber || header[2] != kNoCompress) {
      error = true;
      return false;
    }
    uint32_t num = header[1], crc = header[3], size = header[4];
    std::string payload(size, '\0');
    if (size > 0 && fread(&payload[0], 1, size, f) != size) {
      error = true;
      return false;
    }
    uint32_t actual = crc32_update(
        0, reinterpret_cast<const unsigned char*>(payload.data()),
        payload.size());
    if (actual != crc) {
      error = true;
      return false;
    }
    chunk_records.clear();
    chunk_records.reserve(num);
    size_t pos = 0;
    for (uint32_t i = 0; i < num; ++i) {
      if (pos + 4 > payload.size()) { error = true; return false; }
      uint32_t len;
      memcpy(&len, payload.data() + pos, 4);
      pos += 4;
      if (pos + len > payload.size()) { error = true; return false; }
      chunk_records.emplace_back(payload.data() + pos, len);
      pos += len;
    }
    cursor = 0;
    return true;
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, int max_chunk_records,
                      int max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->max_chunk_records = max_chunk_records > 0 ? max_chunk_records : 1000;
  w->max_chunk_bytes =
      max_chunk_bytes > 0 ? max_chunk_bytes : (32u << 20);
  return w;
}

int rio_write(void* handle, const char* data, long len) {
  Writer* w = static_cast<Writer*>(handle);
  w->records.emplace_back(data, static_cast<size_t>(len));
  w->pending_bytes += static_cast<size_t>(len);
  if (w->records.size() >= w->max_chunk_records ||
      w->pending_bytes >= w->max_chunk_bytes) {
    return w->flush_chunk() ? 0 : -1;
  }
  return 0;
}

int rio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  bool ok = w->flush_chunk();
  fclose(w->f);
  delete w;
  return ok ? 0 : -1;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// size of the next record, -1 on EOF, -2 on corruption
long rio_next_size(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  while (s->cursor >= s->chunk_records.size()) {
    if (!s->load_chunk()) return s->error ? -2 : -1;
  }
  return static_cast<long>(s->chunk_records[s->cursor].size());
}

// copies the next record into out (caller sized it via rio_next_size) and
// advances; returns 0 ok
int rio_next_copy(void* handle, char* out) {
  Scanner* s = static_cast<Scanner*>(handle);
  if (s->cursor >= s->chunk_records.size()) return -1;
  const std::string& r = s->chunk_records[s->cursor++];
  memcpy(out, r.data(), r.size());
  return 0;
}

void rio_scanner_close(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
