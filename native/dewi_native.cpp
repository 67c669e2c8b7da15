// DEWI native runtime: high-throughput host-side codecs.
//
// The accelerator owns all numeric compute (JAX/XLA); this library owns the
// host-side hot paths around it — the reference delegated those to
// third-party C++ wheels (hnswlib/faiss serde, reference backends.py:104-163,
// 358-383), which this framework replaces in-repo.
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in the image):
//
//   * payloads.jsonl encode/decode  — one {"doc_id": ..., "payload": {...}}
//     object per line.  Python's json round-trip is the bottleneck when
//     saving/loading million-document indexes; this codec uses
//     std::to_chars/from_chars and a single buffered write.
//   * minhash signatures            — shingle hashing for the text-dedup
//     path (signals/redundancy.py), the other Python-side hot loop.
//
// Build: make -C native   (g++ -O3 -shared; no external dependencies)

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Append a float with shortest round-trip formatting.
inline void append_float(std::string& out, float v) {
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr);
}

// Minimal JSON string escape for doc ids (quotes, backslash, control chars).
inline void append_escaped(std::string& out, const char* s, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    unsigned char c = s[i];
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char esc[8];
          snprintf(esc, sizeof(esc), "\\u%04x", c);
          out += esc;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
}

// Split a comma-separated key list.
std::vector<std::string> split_keys(const char* keys_csv) {
  std::vector<std::string> keys;
  const char* p = keys_csv;
  while (*p) {
    const char* comma = strchr(p, ',');
    if (!comma) {
      keys.emplace_back(p);
      break;
    }
    keys.emplace_back(p, comma - p);
    p = comma + 1;
  }
  return keys;
}

// Find `"key"` then parse the number after the following ':'.
// Returns true and writes *val on success.  `hint` is an optional position
// to try first (keys usually appear in a fixed order per file).
bool parse_key_value(const char* line, size_t len, const std::string& key,
                     float* val) {
  std::string needle = "\"" + key + "\"";
  const char* p = static_cast<const char*>(
      memmem(line, len, needle.data(), needle.size()));
  if (!p) return false;
  p += needle.size();
  const char* end = line + len;
  while (p < end && (*p == ':' || *p == ' ' || *p == '\t')) ++p;
  if (p >= end) return false;
  auto res = std::from_chars(p, end, *val);
  return res.ec == std::errc();
}

// Extract the JSON string value following `"key"` into out (unescaping the
// common escapes).  Returns false if absent.
bool parse_key_string(const char* line, size_t len, const char* key,
                      std::string* out) {
  std::string needle = std::string("\"") + key + "\"";
  const char* p = static_cast<const char*>(
      memmem(line, len, needle.data(), needle.size()));
  if (!p) return false;
  p += needle.size();
  const char* end = line + len;
  while (p < end && (*p == ':' || *p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p != '"') return false;
  ++p;
  out->clear();
  while (p < end && *p != '"') {
    if (*p == '\\' && p + 1 < end) {
      ++p;
      switch (*p) {
        case 'n': *out += '\n'; break;
        case 'r': *out += '\r'; break;
        case 't': *out += '\t'; break;
        case 'u': {
          if (p + 4 < end) {
            unsigned code = 0;
            std::from_chars(p + 1, p + 5, code, 16);
            *out += static_cast<char>(code);  // BMP->byte best effort
            p += 4;
          }
          break;
        }
        default: *out += *p;
      }
    } else {
      *out += *p;
    }
    ++p;
  }
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// payloads.jsonl writer
// ---------------------------------------------------------------------------
//
// ids_nl: doc ids joined by '\n' (n of them).
// data:   [n, n_keys] row-major floats.
// Returns bytes written, or -1 on IO error.
int64_t dewi_write_payloads_jsonl(const char* path, const char* ids_nl,
                                  const float* data, int64_t n,
                                  const char* keys_csv) {
  std::vector<std::string> keys = split_keys(keys_csv);
  const int64_t n_keys = static_cast<int64_t>(keys.size());
  FILE* f = fopen(path, "wb");
  if (!f) return -1;

  std::string buf;
  buf.reserve(1 << 22);
  const char* id_p = ids_nl;
  int64_t written = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* id_end = strchr(id_p, '\n');
    size_t id_len = id_end ? static_cast<size_t>(id_end - id_p) : strlen(id_p);
    buf += "{\"doc_id\": \"";
    append_escaped(buf, id_p, id_len);
    buf += "\", \"payload\": {";
    for (int64_t k = 0; k < n_keys; ++k) {
      if (k) buf += ", ";
      buf += '"';
      buf += keys[k];
      buf += "\": ";
      append_float(buf, data[i * n_keys + k]);
    }
    buf += "}}\n";
    id_p = id_end ? id_end + 1 : id_p + id_len;
    if (buf.size() > (1 << 21)) {
      if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return -1;
      }
      written += static_cast<int64_t>(buf.size());
      buf.clear();
    }
  }
  if (!buf.empty() && fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -1;
  }
  written += static_cast<int64_t>(buf.size());
  fclose(f);
  return written;
}

// ---------------------------------------------------------------------------
// payloads.jsonl reader
// ---------------------------------------------------------------------------
//
// Parses up to max_rows lines into out[row, n_keys]; missing keys read 0.
// Doc ids are written '\n'-joined into ids_out (capacity ids_cap bytes).
// Returns the number of rows parsed; -1 on IO error, -2 if ids_out too small.
int64_t dewi_read_payloads_jsonl(const char* path, const char* keys_csv,
                                 float* out, int64_t max_rows, char* ids_out,
                                 int64_t ids_cap) {
  std::vector<std::string> keys = split_keys(keys_csv);
  const int64_t n_keys = static_cast<int64_t>(keys.size());
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string content(static_cast<size_t>(size), '\0');
  if (size > 0 && fread(content.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);

  int64_t row = 0;
  int64_t ids_len = 0;
  const char* p = content.data();
  const char* end = p + content.size();
  std::string id;
  while (p < end && row < max_rows) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t line_len = nl ? static_cast<size_t>(nl - p)
                         : static_cast<size_t>(end - p);
    if (line_len > 2) {
      if (!parse_key_string(p, line_len, "doc_id", &id) &&
          !parse_key_string(p, line_len, "id", &id)) {
        id.clear();
      }
      int64_t need = static_cast<int64_t>(id.size()) + 1;
      if (ids_len + need > ids_cap) return -2;
      memcpy(ids_out + ids_len, id.data(), id.size());
      ids_len += static_cast<int64_t>(id.size());
      ids_out[ids_len++] = '\n';
      for (int64_t k = 0; k < n_keys; ++k) {
        float v = 0.0f;
        parse_key_value(p, line_len, keys[k], &v);
        out[row * n_keys + k] = v;
      }
      ++row;
    }
    p = nl ? nl + 1 : end;
  }
  if (ids_len > 0) ids_out[ids_len - 1] = '\0';
  else if (ids_cap > 0) ids_out[0] = '\0';
  return row;
}

// ---------------------------------------------------------------------------
// minhash signatures
// ---------------------------------------------------------------------------
//
// texts_nl: documents joined by '\x1e' (record separator); n docs.
// a, b:     [h] odd multipliers / offsets for universal hashing.
// sigs:     [n, h] uint64 output (min over shingles of (a*x+b) mod p).
// k:        word-shingle size (char 4-grams for docs with < k words).
// Hash of a shingle is FNV-1a 64-bit over its bytes (lowercased words joined
// by single spaces), matching the Python fallback in signals/redundancy.py
// only in spirit — the two paths are never mixed within one corpus.
int64_t dewi_minhash(const char* texts_rs, int64_t n, const uint64_t* a,
                     const uint64_t* b, int64_t h, int64_t k, uint64_t* sigs) {
  const uint64_t P = (1ULL << 61) - 1;
  const char* p = texts_rs;
  for (int64_t doc = 0; doc < n; ++doc) {
    const char* docend = strchr(p, '\x1e');
    if (!docend) docend = p + strlen(p);

    // Tokenize into lowercased words.
    std::vector<std::pair<const char*, size_t>> words;
    std::string lowered(p, docend - p);
    for (auto& c : lowered) c = static_cast<char>(tolower(c));
    {
      const char* w = lowered.data();
      const char* wend = w + lowered.size();
      while (w < wend) {
        while (w < wend && isspace(static_cast<unsigned char>(*w))) ++w;
        const char* start = w;
        while (w < wend && !isspace(static_cast<unsigned char>(*w))) ++w;
        if (w > start) words.emplace_back(start, w - start);
      }
    }

    // Shingle hashes (FNV-1a over the joined shingle bytes).
    std::vector<uint64_t> hashes;
    auto fnv = [](const char* s, size_t len, uint64_t hash) {
      for (size_t i = 0; i < len; ++i) {
        hash ^= static_cast<unsigned char>(s[i]);
        hash *= 1099511628211ULL;
      }
      return hash;
    };
    const uint64_t FNV_INIT = 1469598103934665603ULL;
    if (static_cast<int64_t>(words.size()) >= k) {
      for (size_t i = 0; i + k <= words.size(); ++i) {
        uint64_t hv = FNV_INIT;
        for (int64_t j = 0; j < k; ++j) {
          if (j) hv = fnv(" ", 1, hv);
          hv = fnv(words[i + j].first, words[i + j].second, hv);
        }
        hashes.push_back(hv);
      }
    } else {
      size_t len = lowered.size();
      for (size_t i = 0; i + 1 <= (len > 4 ? len - 3 : 1); ++i) {
        size_t g = len - i < 4 ? len - i : 4;
        hashes.push_back(fnv(lowered.data() + i, g, FNV_INIT));
      }
    }

    for (int64_t j = 0; j < h; ++j) {
      uint64_t best = UINT64_MAX;
      for (uint64_t x : hashes) {
        // (a*x + b) mod p with 128-bit intermediate.
        unsigned __int128 prod =
            static_cast<unsigned __int128>(a[j]) * (x % P) + b[j];
        uint64_t v = static_cast<uint64_t>(prod % P);
        if (v < best) best = v;
      }
      sigs[doc * h + j] = best;
    }
    p = (*docend) ? docend + 1 : docend;
  }
  return n;
}

const char* dewi_native_version() { return "0.1.0"; }

}  // extern "C"
