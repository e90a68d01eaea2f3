// Native caption-metric kernels: PTB-style tokenizer, corpus BLEU, CIDEr.
//
// TPU-native replacement for the reference's Java subprocesses (Stanford PTB
// tokenizer jar + METEOR jar, both absent from the reference checkout) and
// its pure-Python BLEU/CIDEr scorers: the evaluation loop tokenizes and
// scores thousands of captions per epoch, and this library keeps that
// host-side work off the Python interpreter.
//
// C API (ctypes-friendly): every function returns a malloc'd C string the
// caller releases with navc_free. Corpus inputs are arrays of UTF-8 strings.
//
// Algorithms mirror navc_tpu/metrics/{tokenizer,bleu,cider}.py exactly; the
// Python test suite cross-checks both backends on the same corpora.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Tokenizer
// ---------------------------------------------------------------------------

const std::unordered_set<std::string>& punctuations() {
  static const std::unordered_set<std::string> kPunct = {
      "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
      ".", "?", "!", ",", ":", "-", "--", "...", ";"};
  return kPunct;
}

// Python str.split() whitespace, ASCII subset (non-ASCII inputs are routed
// to the Python scorers by lib.py): space, \t-\r, and the \x1c-\x1f
// separators str.isspace() accepts. Including \x1c-\x1f also guarantees no
// token can contain the \x1f n-gram key separator.
bool is_space(char c) {
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= '\x1c' && c <= '\x1f');
}

bool word_char(char c) {
  return isalnum(static_cast<unsigned char>(c)) != 0 || c == '_';
}

// The passes below mirror metrics/tokenizer.py RULE BY RULE, in the same
// order. The ordering is load-bearing: each earlier substitution creates the
// spaces later rules key on (e.g. "is'?" splits its quote only because rule
// 4 spaced the '?' first, while "don't," stays whole because the n't rule
// runs before the comma is spaced). A single-pass tokenizer cannot reproduce
// these sequential-rewrite semantics — verified by the randomized parity
// fuzz (tests/test_native_metrics_fuzz.py).

// _CONTRACTIONS: \b(can)(not)\b | (d')(ye) | (gim)(me) | (gon)(na) |
// (got)(ta) | (lem)(me) | (wan)(na), case-insensitive.
std::string split_contractions(const std::string& s) {
  struct Pair { const char* w; size_t cut; };
  static const Pair kPairs[] = {{"cannot", 3}, {"d'ye", 2}, {"gimme", 3},
                                {"gonna", 3},  {"gotta", 3}, {"lemme", 3},
                                {"wanna", 3}};
  std::string out;
  out.reserve(s.size() + 4);
  size_t i = 0, n = s.size();
  while (i < n) {
    bool matched = false;
    if (i == 0 || !word_char(s[i - 1])) {
      for (const auto& p : kPairs) {
        size_t m = strlen(p.w);
        if (i + m > n) continue;
        bool eq = true;
        for (size_t k = 0; k < m; ++k) {
          if (tolower(static_cast<unsigned char>(s[i + k])) != p.w[k]) {
            eq = false;
            break;
          }
        }
        if (eq && (i + m == n || !word_char(s[i + m]))) {
          out.append(s, i, p.cut);
          out += ' ';
          out.append(s, i + p.cut, m - p.cut);
          i += m;
          matched = true;
          break;
        }
      }
    }
    if (!matched) {
      out += s[i];
      ++i;
    }
  }
  return out;
}

// rule 1: (\.\.\.) -> " ... "
std::string space_ellipsis(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (size_t i = 0; i < s.size();) {
    if (s[i] == '.' && i + 2 < s.size() && s[i + 1] == '.' &&
        s[i + 2] == '.') {
      out += " ... ";
      i += 3;
    } else {
      out += s[i];
      ++i;
    }
  }
  return out;
}

// rules 2/4/5: space every char in `set`
std::string space_chars(const std::string& s, const char* set) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    if (strchr(set, c) != nullptr) {
      out += ' ';
      out += c;
      out += ' ';
    } else {
      out += c;
    }
  }
  return out;
}

// rule 3: ([^.])(\.)([\])}>"']*)\s*$ -> \1 " " \2\3 " " — the sentence-final
// period (keeps "u.s.a." whole mid-line, splits its last dot at line end)
std::string split_final_period(const std::string& s) {
  size_t j = s.size();
  while (j > 0 && is_space(s[j - 1])) --j;
  size_t close_end = j;
  while (j > 0 && strchr("])}>\"'", s[j - 1]) != nullptr) --j;
  if (j < 2 || s[j - 1] != '.' || s[j - 2] == '.') return s;
  size_t dot = j - 1;
  std::string out = s.substr(0, dot);
  out += ' ';
  out.append(s, dot, close_end - dot);
  out += ' ';
  out.append(s, close_end, s.size() - close_end);
  return out;
}

// rule 6: (--) -> " -- "
std::string space_double_dash(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (size_t i = 0; i < s.size();) {
    if (s[i] == '-' && i + 1 < s.size() && s[i + 1] == '-') {
      out += " -- ";
      i += 2;
    } else {
      out += s[i];
      ++i;
    }
  }
  return out;
}

// rule 7: ([^'])' " " -> \1 " ' " — word-final closing quote
std::string split_tail_quote(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 4);
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '\'' && i > 0 && s[i - 1] != '\'' && i + 1 < s.size() &&
        s[i + 1] == ' ') {
      out += " '";
    } else {
      out += s[i];
    }
  }
  return out;
}

// rule 8: '([sSmMdD]) " " -> " '"\1 — possessive / 's 'm 'd
std::string split_possessive(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 4);
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '\'' && i + 2 < s.size() &&
        strchr("sSmMdD", s[i + 1]) != nullptr && s[i + 2] == ' ') {
      out += " '";
    } else {
      out += s[i];
    }
  }
  return out;
}

// rule 9: ('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) " " -> insert a space before the
// suffix (exact-case alternation, like the Python regex)
std::string split_suffixes(const std::string& s) {
  static const char* kSuf[] = {"'ll", "'LL", "'re", "'RE",
                               "'ve", "'VE", "n't", "N'T"};
  std::string out;
  out.reserve(s.size() + 4);
  for (size_t i = 0; i < s.size();) {
    bool matched = false;
    if (i + 3 < s.size() && s[i + 3] == ' ') {
      for (const char* suf : kSuf) {
        if (s.compare(i, 3, suf) == 0) {
          out += ' ';
          out.append(suf);
          i += 3;
          matched = true;
          break;
        }
      }
    }
    if (!matched) {
      out += s[i];
      ++i;
    }
  }
  return out;
}

// rule 10: ([,:])(?!\d) -> " c "
std::string split_comma_colon(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (size_t i = 0; i < s.size(); ++i) {
    char c = s[i];
    if ((c == ',' || c == ':') &&
        !(i + 1 < s.size() && isdigit(static_cast<unsigned char>(s[i + 1])))) {
      out += ' ';
      out += c;
      out += ' ';
    } else {
      out += c;
    }
  }
  return out;
}

// Split one caption into PTB tokens, lowercase, drop punctuation —
// pass-for-pass equivalent of metrics/tokenizer.py::ptb_tokenize.
std::vector<std::string> tokenize(const std::string& text) {
  size_t b = 0, e = text.size();
  while (b < e && is_space(text[b])) ++b;
  while (e > b && is_space(text[e - 1])) --e;
  std::string s = " " + text.substr(b, e - b) + " ";
  s = split_contractions(s);
  {
    std::string q;
    q.reserve(s.size() + 8);
    for (char c : s) {
      if (c == '"') q += " '' ";
      else q += c;
    }
    s = q;
  }
  s = space_ellipsis(s);
  s = space_chars(s, ";@#$%&");
  s = split_final_period(s);
  s = space_chars(s, "?!");
  s = space_chars(s, "][(){}<>");
  s = space_double_dash(s);
  s = split_tail_quote(s);
  s = split_possessive(s);
  s = split_suffixes(s);
  s = split_comma_colon(s);
  const std::string& spaced = s;

  // split on whitespace, lowercase, drop punctuation (all splitting already
  // happened in the rule passes above)
  std::vector<std::string> filtered;
  std::string cur;
  for (char c : spaced) {
    if (is_space(c)) {
      if (!cur.empty() && !punctuations().count(cur)) filtered.push_back(cur);
      cur.clear();
    } else {
      cur += static_cast<char>(tolower(static_cast<unsigned char>(c)));
    }
  }
  if (!cur.empty() && !punctuations().count(cur)) filtered.push_back(cur);
  return filtered;
}

// ---------------------------------------------------------------------------
// n-gram helpers
// ---------------------------------------------------------------------------

using Counts = std::unordered_map<std::string, int>;

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> t;
  std::string cur;
  for (char c : s) {
    if (is_space(c)) {
      if (!cur.empty()) t.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  if (!cur.empty()) t.push_back(cur);
  return t;
}

// joined-token n-gram key; the order k is encoded EXPLICITLY in the first
// byte ('1'..'4') rather than derived from separator counts — tokens can
// never contain '\x1f' after split_ws, but a wrong order must never be
// able to index past the per-order accumulators (it segfaulted before)
Counts ngram_counts(const std::vector<std::string>& toks, int n) {
  Counts c;
  for (int k = 1; k <= n; ++k) {
    for (int i = 0; i + k <= static_cast<int>(toks.size()); ++i) {
      std::string key(1, static_cast<char>('0' + k));
      for (int j = 0; j < k; ++j) {
        if (j) key += '\x1f';
        key += toks[i + j];
      }
      c[key] += 1;
    }
  }
  return c;
}

int ngram_order(const std::string& key) {
  return key.empty() ? 1 : key[0] - '0';
}

char* dup_string(const std::string& s) {
  char* out = static_cast<char*>(malloc(s.size() + 1));
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

std::string json_array(const std::vector<double>& v) {
  std::string s = "[";
  char buf[64];
  for (size_t i = 0; i < v.size(); ++i) {
    snprintf(buf, sizeof(buf), "%.12g", v[i]);
    if (i) s += ",";
    s += buf;
  }
  s += "]";
  return s;
}

}  // namespace

extern "C" {

void navc_free(char* p) { free(p); }

// Tokenize one caption -> space-joined tokens.
char* navc_tokenize(const char* text) {
  auto toks = tokenize(text ? text : "");
  std::string joined;
  for (size_t i = 0; i < toks.size(); ++i) {
    if (i) joined += ' ';
    joined += toks[i];
  }
  return dup_string(joined);
}

// Corpus BLEU-1..4. hyps[i] scored against refs[ref_off[i] .. ref_off[i+1]).
// Returns JSON [b1,b2,b3,b4].
char* navc_bleu_corpus(const char** hyps, int n, const char** refs,
                       const int* ref_off) {
  const int N = 4;
  const double kSmall = 1e-9, kTiny = 1e-15;
  double total_guess[4] = {0}, total_correct[4] = {0};
  double total_testlen = 0, total_reflen = 0;

  for (int i = 0; i < n; ++i) {
    auto h = split_ws(hyps[i]);
    int testlen = static_cast<int>(h.size());
    total_testlen += testlen;

    int rbeg = ref_off[i], rend = ref_off[i + 1];
    Counts max_ref;
    double reflen = 0;
    if (rend - rbeg == 1) {
      auto rt = split_ws(refs[rbeg]);
      reflen = static_cast<double>(rt.size());
      for (auto& kv : ngram_counts(rt, N)) {
        max_ref[kv.first] = std::max(max_ref[kv.first], kv.second);
      }
    } else {
      int best_d = 1 << 30, best_l = 0;
      for (int r = rbeg; r < rend; ++r) {
        auto rt = split_ws(refs[r]);
        int l = static_cast<int>(rt.size());
        int d = std::abs(l - testlen);
        // min over (|l - testlen|, l) tuples, matching python tuple order
        if (d < best_d || (d == best_d && l < best_l)) {
          best_d = d;
          best_l = l;
        }
        for (auto& kv : ngram_counts(rt, N)) {
          max_ref[kv.first] = std::max(max_ref[kv.first], kv.second);
        }
      }
      reflen = best_l;
    }
    total_reflen += reflen;

    auto hc = ngram_counts(h, N);
    for (int k = 0; k < N; ++k) {
      total_guess[k] += std::max(0, testlen - k);
    }
    for (auto& kv : hc) {
      int k = ngram_order(kv.first) - 1;
      auto it = max_ref.find(kv.first);
      total_correct[k] += std::min(kv.second, it == max_ref.end() ? 0 : it->second);
    }
  }

  std::vector<double> scores;
  double b = 1.0;
  double ratio = (total_testlen + kTiny) / (total_reflen + kSmall);
  for (int k = 0; k < N; ++k) {
    b *= (total_correct[k] + kTiny) / (total_guess[k] + kSmall);
    double s = std::pow(b, 1.0 / (k + 1));
    if (ratio < 1) s *= std::exp(1 - 1 / ratio);
    scores.push_back(s);
  }
  return dup_string(json_array(scores));
}

// Corpus CIDEr. Same layout as navc_bleu_corpus.
// Returns JSON [mean, per_image...].
char* navc_cider_corpus(const char** hyps, int n, const char** refs,
                        const int* ref_off) {
  const int N = 4;
  const double kSigma = 6.0;

  std::vector<Counts> ctest(n);
  std::vector<std::vector<Counts>> crefs(n);
  for (int i = 0; i < n; ++i) {
    ctest[i] = ngram_counts(split_ws(hyps[i]), N);
    for (int r = ref_off[i]; r < ref_off[i + 1]; ++r) {
      crefs[i].push_back(ngram_counts(split_ws(refs[r]), N));
    }
  }

  std::unordered_map<std::string, double> df;
  for (auto& ref_set : crefs) {
    std::unordered_set<std::string> seen;
    for (auto& ref : ref_set) {
      for (auto& kv : ref) seen.insert(kv.first);
    }
    for (auto& g : seen) df[g] += 1.0;
  }
  double ref_len = std::log(static_cast<double>(n));

  struct Vec {
    std::vector<std::unordered_map<std::string, double>> v;
    double norm[4];
    int length;
  };
  auto counts2vec = [&](const Counts& cnts) {
    Vec out;
    out.v.resize(N);
    for (int k = 0; k < N; ++k) out.norm[k] = 0;
    out.length = 0;
    for (auto& kv : cnts) {
      double d = 0.0;
      auto it = df.find(kv.first);
      if (it != df.end()) d = std::log(std::max(1.0, it->second));
      int k = ngram_order(kv.first) - 1;
      double w = kv.second * (ref_len - d);
      out.v[k][kv.first] = w;
      out.norm[k] += w * w;
      if (k == 1) out.length += kv.second;  // protocol quirk: bigram count
    }
    for (int k = 0; k < N; ++k) out.norm[k] = std::sqrt(out.norm[k]);
    return out;
  };

  std::vector<double> out;
  out.push_back(0);  // placeholder mean
  for (int i = 0; i < n; ++i) {
    Vec vh = counts2vec(ctest[i]);
    double score[4] = {0, 0, 0, 0};
    for (auto& ref : crefs[i]) {
      Vec vr = counts2vec(ref);
      double delta = static_cast<double>(vh.length - vr.length);
      double pen = std::exp(-(delta * delta) / (2 * kSigma * kSigma));
      for (int k = 0; k < N; ++k) {
        double val = 0;
        for (auto& kv : vh.v[k]) {
          auto it = vr.v[k].find(kv.first);
          if (it != vr.v[k].end()) {
            val += std::min(kv.second, it->second) * it->second;
          }
        }
        if (vh.norm[k] != 0 && vr.norm[k] != 0) val /= vh.norm[k] * vr.norm[k];
        score[k] += val * pen;
      }
    }
    double avg = (score[0] + score[1] + score[2] + score[3]) / N /
                 std::max<size_t>(1, crefs[i].size()) * 10.0;
    out.push_back(avg);
  }
  double mean = 0;
  for (int i = 1; i <= n; ++i) mean += out[i];
  out[0] = n ? mean / n : 0.0;
  return dup_string(json_array(out));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ROUGE-L and METEOR-equivalent (see navc_tpu/metrics/{rouge,meteor}.py)
// ---------------------------------------------------------------------------

#include "porter.h"

namespace {

const double kRougeBeta = 1.2;
const double kMeteorAlpha = 0.9;
const double kMeteorBeta = 3.0;
const double kMeteorGamma = 0.5;

int lcs_len(const std::vector<std::string>& a, const std::vector<std::string>& b) {
  if (a.empty() || b.empty()) return 0;
  std::vector<int> prev(b.size() + 1, 0), cur(b.size() + 1, 0);
  for (size_t i = 0; i < a.size(); ++i) {
    for (size_t j = 1; j <= b.size(); ++j) {
      cur[j] = (a[i] == b[j - 1]) ? prev[j - 1] + 1
                                  : std::max(prev[j], cur[j - 1]);
    }
    std::swap(prev, cur);
    std::fill(cur.begin(), cur.end(), 0);
  }
  return prev[b.size()];
}

double sentence_rouge_l(const std::vector<std::string>& hyp,
                        const std::vector<std::string>& refs_raw) {
  double pmax = 0, rmax = 0;
  for (const auto& r : refs_raw) {
    auto rt = split_ws(r);
    int l = lcs_len(rt, hyp);
    if (!hyp.empty()) pmax = std::max(pmax, double(l) / hyp.size());
    if (!rt.empty()) rmax = std::max(rmax, double(l) / rt.size());
  }
  if (pmax != 0 && rmax != 0) {
    double b2 = kRougeBeta * kRougeBeta;
    return ((1 + b2) * pmax * rmax) / (rmax + b2 * pmax);
  }
  return 0.0;
}

// greedy monotone one-to-one alignment: exact stage then stem stage
// (mirrors navc_tpu/metrics/meteor.py _align)
std::vector<std::pair<int, int>> meteor_align(
    const std::vector<std::string>& h, const std::vector<std::string>& r) {
  std::vector<std::pair<int, int>> matches;
  std::vector<bool> used_h(h.size(), false), used_r(r.size(), false);

  for (int stage = 0; stage < 2; ++stage) {
    std::vector<std::string> hk(h.size()), rk(r.size());
    for (size_t i = 0; i < h.size(); ++i)
      hk[i] = stage == 0 ? h[i] : porter::stem(h[i]);
    for (size_t i = 0; i < r.size(); ++i)
      rk[i] = stage == 0 ? r[i] : porter::stem(r[i]);
    int last_r = -1;
    for (size_t hi = 0; hi < h.size(); ++hi) {
      if (used_h[hi]) continue;
      int cand = -1;
      for (size_t ri = 0; ri < r.size(); ++ri) {
        if (used_r[ri] || rk[ri] != hk[hi]) continue;
        if (static_cast<int>(ri) > last_r) { cand = static_cast<int>(ri); break; }
        if (cand < 0) cand = static_cast<int>(ri);
      }
      if (cand >= 0) {
        used_h[hi] = true;
        used_r[cand] = true;
        matches.emplace_back(static_cast<int>(hi), cand);
        last_r = cand;
      }
    }
  }
  std::sort(matches.begin(), matches.end());
  return matches;
}

int meteor_chunks(const std::vector<std::pair<int, int>>& m) {
  if (m.empty()) return 0;
  int chunks = 1;
  for (size_t i = 1; i < m.size(); ++i) {
    if (!(m[i].first == m[i - 1].first + 1 && m[i].second == m[i - 1].second + 1))
      chunks += 1;
  }
  return chunks;
}

double sentence_meteor(const std::vector<std::string>& h,
                       const std::vector<std::string>& refs_raw) {
  double best = 0.0;
  for (const auto& rs : refs_raw) {
    auto r = split_ws(rs);
    if (h.empty() || r.empty()) continue;
    auto matches = meteor_align(h, r);
    int m = static_cast<int>(matches.size());
    if (m == 0) continue;
    double p = double(m) / h.size();
    double rec = double(m) / r.size();
    double fmean = p * rec / (kMeteorAlpha * p + (1 - kMeteorAlpha) * rec);
    double frag = double(meteor_chunks(matches)) / m;
    double score = fmean * (1 - kMeteorGamma * std::pow(frag, kMeteorBeta));
    best = std::max(best, score);
  }
  return best;
}

}  // namespace

extern "C" {

// Classic Porter stem of one word.
char* navc_porter_stem(const char* word) {
  return dup_string(porter::stem(word ? word : ""));
}

// Corpus ROUGE-L: returns JSON [mean, per_image...].
char* navc_rouge_corpus(const char** hyps, int n, const char** refs,
                        const int* ref_off) {
  std::vector<double> out;
  out.push_back(0);
  double total = 0;
  for (int i = 0; i < n; ++i) {
    auto h = split_ws(hyps[i]);
    std::vector<std::string> rs(refs + ref_off[i], refs + ref_off[i + 1]);
    double s = sentence_rouge_l(h, rs);
    out.push_back(s);
    total += s;
  }
  out[0] = n ? total / n : 0.0;
  return dup_string(json_array(out));
}

// Corpus METEOR-equivalent: returns JSON [mean, per_image...].
char* navc_meteor_corpus(const char** hyps, int n, const char** refs,
                         const int* ref_off) {
  std::vector<double> out;
  out.push_back(0);
  double total = 0;
  for (int i = 0; i < n; ++i) {
    auto h = split_ws(hyps[i]);
    std::vector<std::string> rs(refs + ref_off[i], refs + ref_off[i + 1]);
    double s = sentence_meteor(h, rs);
    out.push_back(s);
    total += s;
  }
  out[0] = n ? total / n : 0.0;
  return dup_string(json_array(out));
}

}  // extern "C"
