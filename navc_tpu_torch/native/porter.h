// Classic Porter stemming algorithm (Porter 1980), from-scratch C++
// implementation matching nltk PorterStemmer(mode='ORIGINAL_ALGORITHM').
// Used by the native METEOR-equivalent scorer's stem matcher stage.
#pragma once

#include <string>

namespace porter {

inline bool is_vowel_at(const std::string& w, size_t i) {
  char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return true;
  // y is a vowel when preceded by a consonant
  if (c == 'y' && i > 0) {
    char p = w[i - 1];
    return !(p == 'a' || p == 'e' || p == 'i' || p == 'o' || p == 'u' ||
             (p == 'y' && false));
  }
  if (c == 'y' && i == 0) return false;
  return false;
}

// measure m of the stem: count of VC sequences
inline int measure(const std::string& w) {
  int m = 0;
  bool prev_vowel = false;
  for (size_t i = 0; i < w.size(); ++i) {
    bool v = is_vowel_at(w, i);
    if (!v && prev_vowel) m += 1;
    prev_vowel = v;
  }
  return m;
}

inline bool contains_vowel(const std::string& w) {
  for (size_t i = 0; i < w.size(); ++i) {
    if (is_vowel_at(w, i)) return true;
  }
  return false;
}

inline bool ends_double_consonant(const std::string& w) {
  size_t n = w.size();
  if (n < 2) return false;
  return w[n - 1] == w[n - 2] && !is_vowel_at(w, n - 1);
}

// *o: stem ends cvc where the last c is not w, x or y
inline bool ends_cvc(const std::string& w) {
  size_t n = w.size();
  if (n < 3) return false;
  if (is_vowel_at(w, n - 3) || !is_vowel_at(w, n - 2) || is_vowel_at(w, n - 1))
    return false;
  char c = w[n - 1];
  return c != 'w' && c != 'x' && c != 'y';
}

inline bool ends_with(const std::string& w, const std::string& suf) {
  return w.size() >= suf.size() &&
         w.compare(w.size() - suf.size(), suf.size(), suf) == 0;
}

inline std::string chop(const std::string& w, size_t n) {
  return w.substr(0, w.size() - n);
}

// apply rule: if word ends `suf` and measure(stem) condition holds, replace
struct Rule { const char* suf; const char* repl; int min_m; };

inline bool apply_rules(std::string& w, const Rule* rules, int n) {
  for (int i = 0; i < n; ++i) {
    const std::string suf = rules[i].suf;
    if (ends_with(w, suf)) {
      std::string stem = chop(w, suf.size());
      if (measure(stem) > rules[i].min_m) {
        w = stem + rules[i].repl;
      }
      return true;  // first matching suffix ends the step (even if not fired)
    }
  }
  return false;
}

inline std::string stem(const std::string& word) {
  // NOTE: the original 1980 algorithm (and nltk's ORIGINAL_ALGORITHM mode)
  // stems short words too ("is" -> "i"); no length guard.
  std::string w = word;
  if (w.empty()) return w;

  // ---- step 1a
  if (ends_with(w, "sses")) w = chop(w, 2);
  else if (ends_with(w, "ies")) w = chop(w, 2);
  else if (ends_with(w, "ss")) { /* no-op */ }
  else if (ends_with(w, "s")) w = chop(w, 1);

  // ---- step 1b
  bool flag = false;
  if (ends_with(w, "eed")) {
    std::string stem_ = chop(w, 3);
    if (measure(stem_) > 0) w = chop(w, 1);
  } else if (ends_with(w, "ed")) {
    std::string stem_ = chop(w, 2);
    if (contains_vowel(stem_)) { w = stem_; flag = true; }
  } else if (ends_with(w, "ing")) {
    std::string stem_ = chop(w, 3);
    if (contains_vowel(stem_)) { w = stem_; flag = true; }
  }
  if (flag) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) {
      w += "e";
    } else if (ends_double_consonant(w) && !ends_with(w, "l") &&
               !ends_with(w, "s") && !ends_with(w, "z")) {
      w = chop(w, 1);
    } else if (measure(w) == 1 && ends_cvc(w)) {
      w += "e";
    }
  }

  // ---- step 1c: y -> i when stem contains vowel
  if (ends_with(w, "y") && contains_vowel(chop(w, 1))) {
    w = chop(w, 1) + "i";
  }

  // ---- step 2
  static const Rule step2[] = {
      {"ational", "ate", 0}, {"tional", "tion", 0}, {"enci", "ence", 0},
      {"anci", "ance", 0}, {"izer", "ize", 0}, {"abli", "able", 0},
      {"alli", "al", 0}, {"entli", "ent", 0}, {"eli", "e", 0},
      {"ousli", "ous", 0}, {"ization", "ize", 0}, {"ation", "ate", 0},
      {"ator", "ate", 0}, {"alism", "al", 0}, {"iveness", "ive", 0},
      {"fulness", "ful", 0}, {"ousness", "ous", 0}, {"aliti", "al", 0},
      {"iviti", "ive", 0}, {"biliti", "ble", 0}};
  apply_rules(w, step2, sizeof(step2) / sizeof(Rule));

  // ---- step 3
  static const Rule step3[] = {
      {"icate", "ic", 0}, {"ative", "", 0}, {"alize", "al", 0},
      {"iciti", "ic", 0}, {"ical", "ic", 0}, {"ful", "", 0}, {"ness", "", 0}};
  apply_rules(w, step3, sizeof(step3) / sizeof(Rule));

  // ---- step 4
  static const Rule step4a[] = {
      {"al", "", 1}, {"ance", "", 1}, {"ence", "", 1}, {"er", "", 1},
      {"ic", "", 1}, {"able", "", 1}, {"ible", "", 1}, {"ant", "", 1},
      {"ement", "", 1}, {"ment", "", 1}, {"ent", "", 1}};
  if (!apply_rules(w, step4a, sizeof(step4a) / sizeof(Rule))) {
    if (ends_with(w, "ion")) {
      std::string stem_ = chop(w, 3);
      if (measure(stem_) > 1 && !stem_.empty() &&
          (stem_.back() == 's' || stem_.back() == 't')) {
        w = stem_;
      }
    } else {
      static const Rule step4b[] = {
          {"ou", "", 1}, {"ism", "", 1}, {"ate", "", 1}, {"iti", "", 1},
          {"ous", "", 1}, {"ive", "", 1}, {"ize", "", 1}};
      apply_rules(w, step4b, sizeof(step4b) / sizeof(Rule));
    }
  } else {
    // handled (or suffix matched without firing)
  }

  // ---- step 5a
  if (ends_with(w, "e")) {
    std::string stem_ = chop(w, 1);
    int m = measure(stem_);
    if (m > 1 || (m == 1 && !ends_cvc(stem_))) w = stem_;
  }
  // ---- step 5b
  if (measure(w) > 1 && ends_double_consonant(w) && ends_with(w, "l")) {
    w = chop(w, 1);
  }
  return w;
}

}  // namespace porter
