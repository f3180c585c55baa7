// Native data loader: FASTA/FASTQ(.gz) record framing + sanitization.
//
// Counterpart of the reference's C++ ingest stack
// (FileReader, Utilities.hpp:449-550; gzstream, zlib/gzstream.cpp;
// searchAndReplaceLettersOfRead, Read.hpp:657-675).  The Python layer
// (host/fastx.py) calls this through ctypes and falls back to its pure
// Python parser when the shared library is unavailable.
//
// C ABI, two-call protocol (no ownership crosses the boundary except
// the opaque handle):
//   kasa_load_fastx(path, is_gz, is_fastq, &n, &seq_bytes, &name_bytes)
//   kasa_fill(handle, seq, seq_off, names, name_off, nlines)   // caller-
//   kasa_release(handle)                                       // allocated

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

struct Parsed {
  std::vector<uint8_t> seq;      // concatenated sequence bytes
  std::vector<int64_t> seq_off;  // n+1
  std::vector<char> names;       // concatenated headers (no '>'/'@')
  std::vector<int64_t> name_off; // n+1
  std::vector<int32_t> nlines;   // sequence lines per record
  int64_t n = 0;
};

// Read a whole file, transparently inflating gzip via zlib.
bool read_file(const char* path, bool is_gz, std::vector<uint8_t>& out) {
  if (is_gz) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    const size_t chunk = 1 << 22;
    size_t used = 0;
    for (;;) {
      out.resize(used + chunk);
      int got = gzread(f, out.data() + used, chunk);
      if (got < 0) { gzclose(f); return false; }
      used += static_cast<size_t>(got);
      if (static_cast<size_t>(got) < chunk) break;
    }
    out.resize(used);
    gzclose(f);
    return true;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(len));
  size_t got = fread(out.data(), 1, out.size(), f);
  fclose(f);
  return got == out.size();
}

// Advance past one line; *line_end points past the content (sans \r\n).
inline const uint8_t* next_line(const uint8_t* p, const uint8_t* end,
                                const uint8_t** line_end) {
  const uint8_t* nl = static_cast<const uint8_t*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
  const uint8_t* stop = nl ? nl : end;
  while (stop > p && stop[-1] == '\r') --stop;
  *line_end = stop;
  return nl ? nl + 1 : end;
}

void parse_fasta(const std::vector<uint8_t>& buf, Parsed& out) {
  const uint8_t* p = buf.data();
  const uint8_t* end = p + buf.size();
  bool open_rec = false;
  int32_t lines = 0;
  while (p < end) {
    const uint8_t* le;
    const uint8_t* next = next_line(p, end, &le);
    if (le > p) {
      if (*p == '>') {
        if (open_rec) {
          out.seq_off.push_back(static_cast<int64_t>(out.seq.size()));
          out.nlines.push_back(lines > 0 ? lines : 1);
          ++out.n;
        }
        out.names.insert(out.names.end(), p + 1, le);
        out.name_off.push_back(static_cast<int64_t>(out.names.size()));
        open_rec = true;
        lines = 0;
      } else if (open_rec) {
        out.seq.insert(out.seq.end(), p, le);
        ++lines;
      }
    }
    p = next;
  }
  if (open_rec) {
    out.seq_off.push_back(static_cast<int64_t>(out.seq.size()));
    out.nlines.push_back(lines > 0 ? lines : 1);
    ++out.n;
  }
}

void parse_fastq(const std::vector<uint8_t>& buf, Parsed& out) {
  const uint8_t* p = buf.data();
  const uint8_t* end = p + buf.size();
  while (p < end) {
    const uint8_t* le;
    const uint8_t* next = next_line(p, end, &le);
    if (le == p) { p = next; continue; }            // skip blank lines
    const uint8_t* h0 = p + (*p == '@' ? 1 : 0);    // header
    out.names.insert(out.names.end(), h0, le);
    out.name_off.push_back(static_cast<int64_t>(out.names.size()));
    p = next;
    if (p < end) {                                  // sequence
      const uint8_t* sstart = p;
      p = next_line(p, end, &le);
      out.seq.insert(out.seq.end(), sstart, le);
    }
    out.seq_off.push_back(static_cast<int64_t>(out.seq.size()));
    out.nlines.push_back(1);
    ++out.n;
    if (p < end) p = next_line(p, end, &le);        // '+' line
    if (p < end) p = next_line(p, end, &le);        // quality line
  }
}

}  // namespace

extern "C" {

// Returns a handle or nullptr on IO failure; writes array sizes so the
// caller can allocate before kasa_fill.
void* kasa_load_fastx(const char* path, int is_gz, int is_fastq,
                      int64_t* n_records, int64_t* seq_bytes,
                      int64_t* name_bytes) {
  std::vector<uint8_t> buf;
  if (!read_file(path, is_gz != 0, buf)) return nullptr;
  Parsed* out = new Parsed();
  out->seq_off.push_back(0);
  out->name_off.push_back(0);
  if (is_fastq) {
    parse_fastq(buf, *out);
  } else {
    parse_fasta(buf, *out);
  }
  *n_records = out->n;
  *seq_bytes = static_cast<int64_t>(out->seq.size());
  *name_bytes = static_cast<int64_t>(out->names.size());
  return out;
}

void kasa_fill(void* handle, uint8_t* seq, int64_t* seq_off, char* names,
               int64_t* name_off, int32_t* nlines) {
  Parsed* p = static_cast<Parsed*>(handle);
  memcpy(seq, p->seq.data(), p->seq.size());
  memcpy(seq_off, p->seq_off.data(), p->seq_off.size() * sizeof(int64_t));
  memcpy(names, p->names.data(), p->names.size());
  memcpy(name_off, p->name_off.data(), p->name_off.size() * sizeof(int64_t));
  memcpy(nlines, p->nlines.data(), p->nlines.size() * sizeof(int32_t));
}

void kasa_release(void* handle) { delete static_cast<Parsed*>(handle); }

// In-place sanitize: DNA keeps ACGTacgt, everything else -> 'Z';
// protein maps '*' -> '[' (searchAndReplaceLettersOfRead,
// Read.hpp:657-675).  Returns the number of space/tab bytes seen
// (an input error in the reference).
int64_t kasa_sanitize(uint8_t* seq, int64_t n, int protein) {
  static uint8_t dna_lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) dna_lut[i] = 'Z';
    for (const char* c = "ACGTacgt"; *c; ++c)
      dna_lut[static_cast<uint8_t>(*c)] = static_cast<uint8_t>(*c);
    init = true;
  }
  int64_t bad_ws = 0;
  if (protein) {
    for (int64_t i = 0; i < n; ++i) {
      if (seq[i] == ' ' || seq[i] == '\t') ++bad_ws;
      if (seq[i] == '*') seq[i] = '[';
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      if (seq[i] == ' ' || seq[i] == '\t') ++bad_ws;
      seq[i] = dna_lut[seq[i]];
    }
  }
  return bad_ws;
}

// Byte size of an unordered_map<uint32_t,uint32_t> holding `keys`,
// computed exactly as the reference's memory accounting does
// (calculateSizeInByteOfUnorderedMap, Utilities.hpp:1028-1040): 8 bytes
// per occupied slot plus 8 per empty bucket.  Built with the same
// libstdc++ container so bucket counts and hashing match the binary.
int64_t kasa_umap_bytes(const uint32_t* keys, int64_t n) {
  std::unordered_map<uint32_t, uint32_t> m;
  for (int64_t i = 0; i < n; ++i) m.emplace(keys[i], (uint32_t)i);
  int64_t bytes = 0;
  for (size_t b = 0; b < m.bucket_count(); ++b) {
    const size_t sz = m.bucket_size(b);
    bytes += 8 * (sz == 0 ? 1 : (int64_t)sz);
  }
  return bytes;
}

}  // extern "C"
