// Copy of paddle_tpu/native/src/multislot.cc (the port keeps its own).
// MultiSlot text parser: the CTR ingest hot loop.
//
// Reference: paddle/fluid/framework/data_feed.cc
// MultiSlotDataFeed::ParseOneInstance (:525) — each line holds, per slot,
// "<count> v1 v2 ..." where values are float or uint64 feasigns, parsed
// with strtof/strtoull.  The reference runs one DataFeed per worker thread
// over a shared filelist; here one call parses a whole file with a thread
// pool over line ranges and returns dense, zero-padded [N, slot_len]
// buffers ready to become device arrays (the port's step wants rectangular
// batches, not LoD).
//
// C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ParsedFile {
  int num_slots = 0;
  long num_examples = 0;
  std::vector<int> slot_types;  // 0 = float, 1 = uint64
  std::vector<int> slot_lens;   // padded length per slot
  // per-slot dense buffer [num_examples * slot_len]
  std::vector<std::vector<float>> fbuf;
  std::vector<std::vector<int64_t>> ibuf;
};

// parse lines in [begin, end) of `text` into per-slot vectors
void parse_range(const char* text, size_t begin, size_t end, int num_slots,
                 const int* slot_types, const int* slot_lens,
                 std::vector<std::vector<float>>* fout,
                 std::vector<std::vector<int64_t>>* iout, long* count,
                 int* errors) {
  size_t pos = begin;
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && text[eol] != '\n') ++eol;
    if (eol > pos) {  // non-empty line
      const char* p = text + pos;
      const char* line_end = text + eol;
      char* endp = const_cast<char*>(p);
      bool ok = true;
      for (int s = 0; s < num_slots && ok; ++s) {
        char* before = endp;
        long n = strtol(endp, &endp, 10);
        // the reference enforces a nonzero count per slot
        // (data_feed.cc:538); no-progress parse = non-numeric line
        if (endp == before || endp > line_end || n <= 0) {
          ok = false;
          break;
        }
        int L = slot_lens[s];
        if (slot_types[s] == 0) {
          auto& v = (*fout)[s];
          size_t base = v.size();
          v.resize(base + L, 0.0f);
          for (long j = 0; j < n; ++j) {
            before = endp;
            float val = strtof(endp, &endp);
            // bail on malformed/short lines instead of spinning n times
            // or eating tokens of the next line (strto* skip newlines)
            if (endp == before || endp > line_end) { ok = false; break; }
            if (j < L) v[base + j] = val;
          }
        } else {
          auto& v = (*iout)[s];
          size_t base = v.size();
          v.resize(base + L, 0);
          for (long j = 0; j < n; ++j) {
            before = endp;
            int64_t val = static_cast<int64_t>(strtoull(endp, &endp, 10));
            if (endp == before || endp > line_end) { ok = false; break; }
            if (j < L) v[base + j] = val;
          }
        }
      }
      if (ok) {
        ++*count;
      } else {
        ++*errors;
        // roll back partially written slots to keep buffers rectangular
        for (int s = 0; s < num_slots; ++s) {
          size_t want = static_cast<size_t>(*count) * slot_lens[s];
          if (slot_types[s] == 0) (*fout)[s].resize(want);
          else (*iout)[s].resize(want);
        }
      }
    }
    pos = eol + 1;
  }
}

}  // namespace

extern "C" {

// Parse `path` with the given schema.  threads <= 0 → hardware default.
void* ms_parse_file(const char* path, const int* slot_types,
                    const int* slot_lens, int num_slots, int threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string text(fsize, '\0');
  if (fsize > 0 && fread(&text[0], 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  int nthreads = threads > 0
                     ? threads
                     : static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  // split at line boundaries
  std::vector<size_t> starts{0};
  for (int t = 1; t < nthreads; ++t) {
    size_t pos = fsize * t / nthreads;
    while (pos < (size_t)fsize && text[pos] != '\n') ++pos;
    if (pos < (size_t)fsize) ++pos;
    starts.push_back(pos);
  }
  starts.push_back(fsize);

  int actual = static_cast<int>(starts.size()) - 1;
  std::vector<std::vector<std::vector<float>>> fparts(actual);
  std::vector<std::vector<std::vector<int64_t>>> iparts(actual);
  std::vector<long> counts(actual, 0);
  std::vector<int> errors(actual, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < actual; ++t) {
    fparts[t].resize(num_slots);
    iparts[t].resize(num_slots);
    pool.emplace_back(parse_range, text.data(), starts[t], starts[t + 1],
                      num_slots, slot_types, slot_lens, &fparts[t],
                      &iparts[t], &counts[t], &errors[t]);
  }
  for (auto& th : pool) th.join();
  // release the raw text before merging: bounds peak memory to roughly
  // two copies of the parsed data (per-thread parts + merged buffers)
  std::string().swap(text);

  ParsedFile* out = new ParsedFile();
  out->num_slots = num_slots;
  out->slot_types.assign(slot_types, slot_types + num_slots);
  out->slot_lens.assign(slot_lens, slot_lens + num_slots);
  out->fbuf.resize(num_slots);
  out->ibuf.resize(num_slots);
  for (int t = 0; t < actual; ++t) out->num_examples += counts[t];
  for (int s = 0; s < num_slots; ++s) {
    if (slot_types[s] == 0) {
      auto& dst = out->fbuf[s];
      dst.reserve(out->num_examples * slot_lens[s]);
      for (int t = 0; t < actual; ++t) {
        dst.insert(dst.end(), fparts[t][s].begin(), fparts[t][s].end());
        std::vector<float>().swap(fparts[t][s]);  // free as we merge
      }
    } else {
      auto& dst = out->ibuf[s];
      dst.reserve(out->num_examples * slot_lens[s]);
      for (int t = 0; t < actual; ++t) {
        dst.insert(dst.end(), iparts[t][s].begin(), iparts[t][s].end());
        std::vector<int64_t>().swap(iparts[t][s]);
      }
    }
  }
  return out;
}

long ms_num_examples(void* handle) {
  return static_cast<ParsedFile*>(handle)->num_examples;
}

// copy slot s ([num_examples, slot_len], float32 or int64) into out
int ms_copy_slot(void* handle, int s, void* out) {
  ParsedFile* p = static_cast<ParsedFile*>(handle);
  if (s < 0 || s >= p->num_slots) return -1;
  size_t n = static_cast<size_t>(p->num_examples) * p->slot_lens[s];
  if (p->slot_types[s] == 0)
    memcpy(out, p->fbuf[s].data(), n * sizeof(float));
  else
    memcpy(out, p->ibuf[s].data(), n * sizeof(int64_t));
  return 0;
}

void ms_free(void* handle) { delete static_cast<ParsedFile*>(handle); }

}  // extern "C"
