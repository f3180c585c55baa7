// Native per-read rank + format for the throughput (--engine tpu) path.
//
// Given the (R, S) float32 score matrix a classify batch produced, this
// ranks every read's hits and emits the per-read output text in any of
// the four formats -- the work the reference does in scoringFunc
// (Compare.hpp:1485-1890) and the Python pipeline does per read in
// match/score.py rank_read + host/output.py ReadResultWriter.  The
// Python path stays the bit-parity reference; this module must produce
// the SAME BYTES given the same scores (tested against it), just ~100x
// faster, so the fast engine's end-to-end throughput is not bounded by
// per-read Python.
//
// Float formatting is a C++ port of host/dtoa.py (Grisu2 with milo-
// compatible rounding, including the reference's kPow10 out-of-bounds
// quirk: no rounding once more than 9 fractional digits were emitted).
// The cached-powers table is generated from exact integer arithmetic
// (tools note in dtoa.py): entry i = nearest-rounded 64-bit normalized
// significand of 10^(-348+8i).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- dtoa

struct CachedPow { uint64_t f; int e; int dec_exp; };

const CachedPow kCachedPowers[87] = {
  {0xfa8fd5a0081c0288ULL, -1220, -348},
  {0xbaaee17fa23ebf76ULL, -1193, -340},
  {0x8b16fb203055ac76ULL, -1166, -332},
  {0xcf42894a5dce35eaULL, -1140, -324},
  {0x9a6bb0aa55653b2dULL, -1113, -316},
  {0xe61acf033d1a45dfULL, -1087, -308},
  {0xab70fe17c79ac6caULL, -1060, -300},
  {0xff77b1fcbebcdc4fULL, -1034, -292},
  {0xbe5691ef416bd60cULL, -1007, -284},
  {0x8dd01fad907ffc3cULL, -980, -276},
  {0xd3515c2831559a83ULL, -954, -268},
  {0x9d71ac8fada6c9b5ULL, -927, -260},
  {0xea9c227723ee8bcbULL, -901, -252},
  {0xaecc49914078536dULL, -874, -244},
  {0x823c12795db6ce57ULL, -847, -236},
  {0xc21094364dfb5637ULL, -821, -228},
  {0x9096ea6f3848984fULL, -794, -220},
  {0xd77485cb25823ac7ULL, -768, -212},
  {0xa086cfcd97bf97f4ULL, -741, -204},
  {0xef340a98172aace5ULL, -715, -196},
  {0xb23867fb2a35b28eULL, -688, -188},
  {0x84c8d4dfd2c63f3bULL, -661, -180},
  {0xc5dd44271ad3cdbaULL, -635, -172},
  {0x936b9fcebb25c996ULL, -608, -164},
  {0xdbac6c247d62a584ULL, -582, -156},
  {0xa3ab66580d5fdaf6ULL, -555, -148},
  {0xf3e2f893dec3f126ULL, -529, -140},
  {0xb5b5ada8aaff80b8ULL, -502, -132},
  {0x87625f056c7c4a8bULL, -475, -124},
  {0xc9bcff6034c13053ULL, -449, -116},
  {0x964e858c91ba2655ULL, -422, -108},
  {0xdff9772470297ebdULL, -396, -100},
  {0xa6dfbd9fb8e5b88fULL, -369, -92},
  {0xf8a95fcf88747d94ULL, -343, -84},
  {0xb94470938fa89bcfULL, -316, -76},
  {0x8a08f0f8bf0f156bULL, -289, -68},
  {0xcdb02555653131b6ULL, -263, -60},
  {0x993fe2c6d07b7facULL, -236, -52},
  {0xe45c10c42a2b3b06ULL, -210, -44},
  {0xaa242499697392d3ULL, -183, -36},
  {0xfd87b5f28300ca0eULL, -157, -28},
  {0xbce5086492111aebULL, -130, -20},
  {0x8cbccc096f5088ccULL, -103, -12},
  {0xd1b71758e219652cULL, -77, -4},
  {0x9c40000000000000ULL, -50, 4},
  {0xe8d4a51000000000ULL, -24, 12},
  {0xad78ebc5ac620000ULL, 3, 20},
  {0x813f3978f8940984ULL, 30, 28},
  {0xc097ce7bc90715b3ULL, 56, 36},
  {0x8f7e32ce7bea5c70ULL, 83, 44},
  {0xd5d238a4abe98068ULL, 109, 52},
  {0x9f4f2726179a2245ULL, 136, 60},
  {0xed63a231d4c4fb27ULL, 162, 68},
  {0xb0de65388cc8ada8ULL, 189, 76},
  {0x83c7088e1aab65dbULL, 216, 84},
  {0xc45d1df942711d9aULL, 242, 92},
  {0x924d692ca61be758ULL, 269, 100},
  {0xda01ee641a708deaULL, 295, 108},
  {0xa26da3999aef774aULL, 322, 116},
  {0xf209787bb47d6b85ULL, 348, 124},
  {0xb454e4a179dd1877ULL, 375, 132},
  {0x865b86925b9bc5c2ULL, 402, 140},
  {0xc83553c5c8965d3dULL, 428, 148},
  {0x952ab45cfa97a0b3ULL, 455, 156},
  {0xde469fbd99a05fe3ULL, 481, 164},
  {0xa59bc234db398c25ULL, 508, 172},
  {0xf6c69a72a3989f5cULL, 534, 180},
  {0xb7dcbf5354e9beceULL, 561, 188},
  {0x88fcf317f22241e2ULL, 588, 196},
  {0xcc20ce9bd35c78a5ULL, 614, 204},
  {0x98165af37b2153dfULL, 641, 212},
  {0xe2a0b5dc971f303aULL, 667, 220},
  {0xa8d9d1535ce3b396ULL, 694, 228},
  {0xfb9b7cd9a4a7443cULL, 720, 236},
  {0xbb764c4ca7a44410ULL, 747, 244},
  {0x8bab8eefb6409c1aULL, 774, 252},
  {0xd01fef10a657842cULL, 800, 260},
  {0x9b10a4e5e9913129ULL, 827, 268},
  {0xe7109bfba19c0c9dULL, 853, 276},
  {0xac2820d9623bf429ULL, 880, 284},
  {0x80444b5e7aa7cf85ULL, 907, 292},
  {0xbf21e44003acdd2dULL, 933, 300},
  {0x8e679c2f5e44ff8fULL, 960, 308},
  {0xd433179d9c8cb841ULL, 986, 316},
  {0x9e19db92b4e31ba9ULL, 1013, 324},
  {0xeb96bf6ebadf77d9ULL, 1039, 332},
  {0xaf87023b9bf0ee6bULL, 1066, 340},
};

struct DiyFp { uint64_t f; int e; };

inline DiyFp diy_mul(DiyFp a, DiyFp b) {
  unsigned __int128 p = (unsigned __int128)a.f * b.f;
  uint64_t h = (uint64_t)(p >> 64);
  if ((uint64_t)(p >> 63) & 1ULL) h += 1;   // round
  return {h, a.e + b.e + 64};
}

inline DiyFp normalize(uint64_t f, int e) {
  while (!(f & 0x8000000000000000ULL)) { f <<= 1; --e; }
  return {f, e};
}

inline CachedPow get_cached_power(int e, int* K) {
  double dk = (-61 - e) * 0.30102999566398114 + 347;
  int k = (int)dk;
  if (dk - k > 0.0) ++k;
  int index = (k >> 3) + 1;
  *K = -(-348 + (index << 3));
  return kCachedPowers[index];
}

inline void grisu_round(char* buf, int len, uint64_t delta, uint64_t rest,
                        uint64_t ten_kappa, uint64_t wp_w) {
  while (rest < wp_w && delta - rest >= ten_kappa &&
         (rest + ten_kappa < wp_w || wp_w - rest > rest + ten_kappa - wp_w)) {
    buf[len - 1]--;
    rest += ten_kappa;
  }
}

inline int count_digits(uint32_t n) {
  int d = 1;
  while (n >= 10) { n /= 10; ++d; }
  return d;
}

const uint64_t kTen[] = {1ULL, 10ULL, 100ULL, 1000ULL, 10000ULL, 100000ULL,
                         1000000ULL, 10000000ULL, 100000000ULL, 1000000000ULL};

inline void digit_gen(DiyFp W, DiyFp Mp, uint64_t delta, char* buffer,
                      int* len, int* K) {
  uint64_t one_f = 1ULL << (-Mp.e);
  uint64_t wp_w = Mp.f - W.f;
  uint32_t p1 = (uint32_t)(Mp.f >> (-Mp.e));
  uint64_t p2 = Mp.f & (one_f - 1);
  int kappa = count_digits(p1);
  *len = 0;
  while (kappa > 0) {
    uint32_t pw = (uint32_t)kTen[kappa - 1];
    uint32_t d = p1 / pw;
    p1 %= pw;
    if (d || *len) buffer[(*len)++] = (char)('0' + d);
    --kappa;
    uint64_t tmp = ((uint64_t)p1 << (-Mp.e)) + p2;
    if (tmp <= delta) {
      *K += kappa;
      grisu_round(buffer, *len, delta, tmp, kTen[kappa] << (-Mp.e), wp_w);
      return;
    }
  }
  for (;;) {
    p2 *= 10;
    delta *= 10;
    char d = (char)(p2 >> (-Mp.e));
    if (d || *len) buffer[(*len)++] = (char)('0' + d);
    p2 &= one_f - 1;
    --kappa;
    if (p2 < delta) {
      *K += kappa;
      // kPow10 OOB quirk (host/dtoa.py:115-122): no rounding once more
      // than 9 fractional digits were produced
      if (-kappa <= 9) {
        grisu_round(buffer, *len, delta, p2, one_f, wp_w * kTen[-kappa]);
      }
      return;
    }
  }
}

inline void grisu2(double value, char* buffer, int* length, int* K) {
  uint64_t u64;
  std::memcpy(&u64, &value, 8);
  const uint64_t kHidden = 1ULL << 52;
  int biased_e = (int)((u64 >> 52) & 0x7FF);
  uint64_t significand = u64 & (kHidden - 1);
  uint64_t f; int e;
  if (biased_e != 0) { f = significand + kHidden; e = biased_e - 0x3FF - 52; }
  else { f = significand; e = -0x3FF - 52 + 1; }

  // normalized boundaries
  uint64_t pl_f = (f << 1) + 1; int pl_e = e - 1;
  while (!(pl_f & (kHidden << 1))) { pl_f <<= 1; --pl_e; }
  pl_f <<= 64 - 54; pl_e -= 64 - 54;
  uint64_t mi_f; int mi_e;
  if (f == kHidden) { mi_f = (f << 2) - 1; mi_e = e - 2; }
  else { mi_f = (f << 1) - 1; mi_e = e - 1; }
  mi_f <<= mi_e - pl_e;

  CachedPow c = get_cached_power(pl_e, K);
  DiyFp cfp = {c.f, c.e};
  DiyFp W = diy_mul(normalize(f, e), cfp);
  DiyFp Wp = diy_mul({pl_f, pl_e}, cfp);
  DiyFp Wm = diy_mul({mi_f, pl_e}, cfp);
  Wm.f += 1;
  Wp.f -= 1;
  digit_gen(W, Wp, Wp.f - Wm.f, buffer, length, K);
}

inline void write_exponent(int K, std::string& out) {
  if (K < 0) { out += '-'; K = -K; }
  char tmp[8]; int n = 0;
  do { tmp[n++] = (char)('0' + K % 10); K /= 10; } while (K);
  while (n) out += tmp[--n];
}

inline void prettify(const char* digits, int length, int k, std::string& out) {
  int kk = length + k;
  if (length <= kk && kk <= 21) {
    out.append(digits, length);
    out.append(kk - length, '0');
    out += ".0";
  } else if (0 < kk && kk <= 21) {
    out.append(digits, kk);
    out += '.';
    out.append(digits + kk, length - kk);
  } else if (-6 < kk && kk <= 0) {
    out += "0.";
    out.append(-kk, '0');
    out.append(digits, length);
  } else if (length == 1) {
    out.append(digits, 1);
    out += 'e';
    write_exponent(kk - 1, out);
  } else {
    out += digits[0];
    out += '.';
    out.append(digits + 1, length - 1);
    out += 'e';
    write_exponent(kk - 1, out);
  }
}

void dtoa_milo(double value, std::string& out) {
  if (std::isnan(value)) { out += "NaN"; return; }
  if (std::isinf(value)) { out += "inf"; return; }
  if (value == 0) { out += "0.0"; return; }
  if (value < 0) { out += '-'; value = -value; }
  char digits[32];
  int length, K = 0;
  grisu2(value, digits, &length, &K);
  prettify(digits, length, K, out);
}

inline void itoa64(int64_t v, std::string& out) {
  if (v < 0) { out += '-'; v = -v; }
  char tmp[24]; int n = 0;
  do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
  while (n) out += tmp[--n];
}

// ------------------------------------------------------------- scoring

// calculateBestScore (match/score.py:20-38; Compare.hpp:1452-1480):
// float32 accumulation, size_t wraparound for short reads.
float best_score(uint32_t read_len, int min_k, int max_k, int protein,
                 int num_frames) {
  float best = 0.f;
  for (int i = min_k; i <= max_k; ++i) {
    float w = (float)(i * i) / 625.f;
    uint64_t n;
    uint64_t len = read_len;
    if (protein) n = len - i + 1;
    else if (num_frames == 1) n = len / 3 - i + 1;
    else if (num_frames == 6) n = 2 * (len - (uint64_t)i * 3 + 1);
    else n = len - (uint64_t)i * 3 + 1;
    best += (float)n * w;
  }
  return best;
}

// relative_score (match/score.py:41-56): double, uint32 length wrap.
double rel_score(float kmer_score, uint32_t read_len, double freq_max_k,
                 int highest_k, int protein) {
  uint32_t term = protein ? (read_len - highest_k + 1)
                          : (read_len - (uint32_t)highest_k * 3 + 1);
  double x = freq_max_k * (double)term;
  double denom;
  if (x > 0) denom = 1.0 + std::log2(x);
  else if (x == 0) denom = -INFINITY;
  else denom = NAN;
  return (double)kmer_score / denom;
}

struct Hit { int32_t spec; float ksc; double rsc; };

struct OutBuf { std::string text; };

// Shared rank+format body; `collect(r, length, hits)` fills the
// threshold-filtered hits of read r in ascending species order (the
// order the dense row scan produces); everything after is identical
// for the dense and sparse entry points.
template <class Collect>
void* rank_format_impl(
    Collect collect, int64_t R,
    const char* names, const int64_t* name_off,
    const uint32_t* lengths, const float* coherence,
    const char* taxids, const int64_t* tax_off,
    const char* orgs, const int64_t* org_off,
    int64_t read_num_start, int min_k, int max_k, int highest_k,
    int protein, int num_frames, int num_beasts,
    int fmt, int coherence_on,
    int filter_on, float error_threshold, float coherence_threshold,
    uint8_t* filtered_out,
    int64_t* out_len) {
  OutBuf* ob = new OutBuf();
  std::string& w = ob->text;
  w.reserve((size_t)R * 256);
  std::vector<Hit> hits;
  hits.reserve(64);

  for (int64_t r = 0; r < R; ++r) {
    int64_t read_num = read_num_start + r;
    const char* name = names + name_off[r];
    size_t name_len = (size_t)(name_off[r + 1] - name_off[r]);
    uint32_t length = lengths[r];
    float best = best_score(length, min_k, max_k, protein, num_frames);
    double coh = coherence ? (double)coherence[r] : 0.0;

    hits.clear();
    collect(r, length, hits);
    std::stable_sort(hits.begin(), hits.end(),
                     [](const Hit& a, const Hit& b) { return a.rsc > b.rsc; });
    int n = (int)hits.size();

    if (n == 0) {
      if (filter_on) filtered_out[r] = 0;
      switch (fmt) {
        case 2:  // tsv
          itoa64(read_num, w); w += '\t';
          w.append(name, name_len);
          w += "\t-\t-\t-\t-";
          if (coherence_on) w += "\t-";
          w += '\n';
          break;
        case 0:  // json
          w += (read_num == 0) ? "{\n" : ",\n{\n";
          w += "\t\"Read number\": "; itoa64(read_num, w);
          w += ",\n\t\"Specifier from input file\": \"";
          w.append(name, name_len);
          w += "\",\n\t\"Length\": "; itoa64(length, w);
          w += ",\n\t\"Top hits\": [\n\t],\n\t\"Further hits\": [\n\t]\n}";
          break;
        case 1:  // jsonl
          w += "{ \"Read number\": "; itoa64(read_num, w);
          w += ", \"Specifier from input file\": \"";
          w.append(name, name_len);
          w += "\", \"Length\": "; itoa64(length, w);
          w += ", \"Top hits\": [], \"Further hits\": [] }\n";
          break;
        case 3:  // kraken: length%256 as a raw byte (Compare.hpp:1568)
          w += "U\t";
          w.append(name, name_len);
          w += "\t0\t";
          w += (char)(length & 0xFF);
          w += "\tA:00\n";
          break;
      }
      continue;
    }

    float max_ksc = hits[0].ksc;
    for (int i = 1; i < n; ++i) max_ksc = std::max(max_ksc, hits[i].ksc);
    int top = 1;
    for (int i = 1; i < n && i < num_beasts; ++i) {
      if (hits[i].ksc / max_ksc > 0.8f) ++top;
      else break;
    }

    if (filter_on) {
      uint8_t f = 0;
      if ((best - max_ksc) / best < error_threshold) f = 1;
      else if (coherence_on && (float)coh >= coherence_threshold) f = 1;
      filtered_out[r] = f;
    }

    auto emit_err = [&](int i) {
      float e = (best - hits[i].ksc) / best;
      dtoa_milo((double)e, w);
    };
    auto spec_tax = [&](int i) {
      int32_t s = hits[i].spec;
      w.append(taxids + tax_off[s], (size_t)(tax_off[s + 1] - tax_off[s]));
    };
    auto spec_org = [&](int i) {
      int32_t s = hits[i].spec;
      w.append(orgs + org_off[s], (size_t)(org_off[s + 1] - org_off[s]));
    };

    if (fmt == 2) {  // tsv: up to num_beasts distinct k-mer scores
      std::string taxa, orgn, scor, errs;
      int j = 0; float val_before = 0.f; int i = 0;
      bool first = true;
      for (; i < n && j < num_beasts; ++i) {
        if (!first) { taxa += ';'; orgn += ';'; scor += ';'; errs += ';'; }
        first = false;
        int32_t s = hits[i].spec;
        taxa.append(taxids + tax_off[s], (size_t)(tax_off[s + 1] - tax_off[s]));
        orgn.append(orgs + org_off[s], (size_t)(org_off[s + 1] - org_off[s]));
        dtoa_milo(hits[i].rsc, scor); scor += ',';
        dtoa_milo((double)hits[i].ksc, scor);
        float e = (best - hits[i].ksc) / best;
        dtoa_milo((double)e, errs);
        if (val_before != hits[i].ksc) { val_before = hits[i].ksc; ++j; }
      }
      if (!first) {   // num_beasts == 0 emits nothing (host/output.py:86)
        itoa64(read_num, w); w += '\t';
        w.append(name, name_len); w += '\t';
        w += taxa; w += '\t'; w += orgn; w += '\t'; w += scor; w += '\t';
        w += errs;
        if (coherence_on) { w += '\t'; dtoa_milo(coh, w); }
        w += '\n';
      }
      continue;
    }

    if (fmt == 0 || fmt == 1) {
      bool pretty = fmt == 0;
      if (pretty) {
        w += (read_num == 0) ? "{\n" : ",\n{\n";
        w += "\t\"Read number\": "; itoa64(read_num, w);
        w += ",\n\t\"Specifier from input file\": \"";
        w.append(name, name_len);
        w += "\",\n\t\"Length\": "; itoa64(length, w);
        w += ",\n\t\"Top hits\": [\n";
      } else {
        w += "{ \"Read number\": "; itoa64(read_num, w);
        w += ", \"Specifier from input file\": \"";
        w.append(name, name_len);
        w += "\", \"Length\": "; itoa64(length, w);
        w += ", \"Top hits\": [";
      }
      auto emit_hit = [&](int i, bool first, bool top_section) {
        if (pretty) {
          w += first ? "\t{\n" : ",\n\t{\n";
          w += "\t\t\"tax ID\": \""; spec_tax(i);
          w += "\",\n\t\t\"Name\": \""; spec_org(i);
          w += "\",\n\t\t\"k-mer Score\": "; dtoa_milo((double)hits[i].ksc, w);
          w += ",\n\t\t\"Relative Score\": "; dtoa_milo(hits[i].rsc, w);
          w += ",\n\t\t\"Error\": "; emit_err(i);
          if (coherence_on) { w += ",\n\t\t\"Coherence\": "; dtoa_milo(coh, w); }
          w += "\n\t}";
        } else {
          // jsonl quirk: further-hit separator is ", {" (host/output.py)
          if (first) w += "{";
          else w += top_section ? ",{" : ", {";
          w += " \"tax ID\": \""; spec_tax(i);
          w += "\", \"Name\": \""; spec_org(i);
          w += "\", \"k-mer Score\": "; dtoa_milo((double)hits[i].ksc, w);
          w += ", \"Relative Score\": "; dtoa_milo(hits[i].rsc, w);
          w += ", \"Error\": "; emit_err(i);
          if (coherence_on) { w += ",\"Coherence\": "; dtoa_milo(coh, w); }
          w += "}";
        }
      };
      int it = 0;
      for (int i = 0; i < top; ++i) emit_hit(it++, i == 0, true);
      if (pretty) w += "\n\t],\n\t\"Further hits\": [\n";
      else w += "], \"Further hits\": [";
      int j = top; float val_before = 0.f; bool first_further = true;
      while (it < n && j < num_beasts) {
        emit_hit(it, first_further, false);
        first_further = false;
        if (val_before != hits[it].ksc) { val_before = hits[it].ksc; ++j; }
        ++it;
      }
      if (pretty) w += "\n\t]\n}";
      else w += "] }\n";
      continue;
    }

    // kraken
    w += "C\t";
    w.append(name, name_len);
    w += '\t'; spec_tax(0);
    w += '\t'; itoa64(length, w); w += '\t';
    int it = 0;
    for (int i = 0; i < top; ++i) {
      spec_tax(it); w += ':'; dtoa_milo((double)hits[it].ksc, w); w += ' ';
      ++it;
    }
    int j = top; float val_before = 0.f;
    while (it < n && j < num_beasts) {
      spec_tax(it); w += ':'; dtoa_milo((double)hits[it].ksc, w); w += ' ';
      if (val_before != hits[it].ksc) { val_before = hits[it].ksc; ++j; }
      ++it;
    }
    w += '\n';
  }

  *out_len = (int64_t)w.size();
  return ob;
}

}  // namespace

extern "C" {

// Rank + format reads [0, R) of a batch.  See module comment.
// fmt: 0 json, 1 jsonl, 2 tsv, 3 kraken.  Strings are concatenated
// blobs with (len+1) int64 offset arrays.  filtered_out: per-read 0/1
// flags for --filter (may be NULL when filter_on == 0).
void* kasa_rank_format(
    const float* scores, int64_t R, int64_t S,
    const char* names, const int64_t* name_off,
    const uint32_t* lengths, const float* coherence,
    const char* taxids, const int64_t* tax_off,
    const char* orgs, const int64_t* org_off,
    const double* freqs,
    int64_t read_num_start, int min_k, int max_k, int highest_k,
    int protein, int num_frames, float threshold, int num_beasts,
    int fmt, int coherence_on,
    int filter_on, float error_threshold, float coherence_threshold,
    uint8_t* filtered_out,
    int64_t* out_len) {
  auto collect = [&](int64_t r, uint32_t length, std::vector<Hit>& hits) {
    const float* row = scores + r * S;
    for (int64_t s = 1; s < S; ++s) {
      if (row[s] > 0.f) {
        double rs = rel_score(row[s], length, freqs[s], highest_k, protein);
        if (rs >= threshold) hits.push_back({(int32_t)s, row[s], rs});
      }
    }
  };
  return rank_format_impl(
      collect, R, names, name_off, lengths, coherence, taxids, tax_off,
      orgs, org_off, read_num_start, min_k, max_k, highest_k, protein,
      num_frames, num_beasts, fmt, coherence_on, filter_on,
      error_threshold, coherence_threshold, filtered_out, out_len);
}

// Sparse variant: per read a compact hit list instead of a dense
// species row -- hit_tax/hit_ksc are (R, W) with hit_cnt[r] valid
// entries in ascending species order (the device kernel emits them
// that way, matching the dense scan's iteration order).
void* kasa_rank_format_sparse(
    const int32_t* hit_tax, const float* hit_ksc, const int32_t* hit_cnt,
    int64_t R, int64_t W,
    const char* names, const int64_t* name_off,
    const uint32_t* lengths, const float* coherence,
    const char* taxids, const int64_t* tax_off,
    const char* orgs, const int64_t* org_off,
    const double* freqs,
    int64_t read_num_start, int min_k, int max_k, int highest_k,
    int protein, int num_frames, float threshold, int num_beasts,
    int fmt, int coherence_on,
    int filter_on, float error_threshold, float coherence_threshold,
    uint8_t* filtered_out,
    int64_t* out_len) {
  auto collect = [&](int64_t r, uint32_t length, std::vector<Hit>& hits) {
    const int32_t* taxs = hit_tax + r * W;
    const float* kscs = hit_ksc + r * W;
    int32_t cnt = hit_cnt[r];
    for (int32_t i = 0; i < cnt; ++i) {
      int32_t s = taxs[i];
      if (s <= 0 || kscs[i] <= 0.f) continue;
      double rs = rel_score(kscs[i], length, freqs[s], highest_k, protein);
      if (rs >= threshold) hits.push_back({s, kscs[i], rs});
    }
  };
  return rank_format_impl(
      collect, R, names, name_off, lengths, coherence, taxids, tax_off,
      orgs, org_off, read_num_start, min_k, max_k, highest_k, protein,
      num_frames, num_beasts, fmt, coherence_on, filter_on,
      error_threshold, coherence_threshold, filtered_out, out_len);
}

const char* kasa_buf_ptr(void* h) {
  return static_cast<OutBuf*>(h)->text.data();
}

void kasa_buf_free(void* h) { delete static_cast<OutBuf*>(h); }

}  // extern "C"
