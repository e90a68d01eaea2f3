"""METEOR 1.5 scorer (exact / stem / synonym / paraphrase stages, optimal
min-chunk alignment, content-function weighting).

The reference scores METEOR through the meteor-1.5.jar subprocess
(coco-caption/pycocoevalcap/meteor/meteor.py:18-26) whose jar (and its
bundled synonym db / function-word list / paraphrase table) is absent from
the checkout (.MISSING_LARGE_BLOBS:3). This module natively implements the
METEOR 1.5 scoring model (Denkowski & Lavie, "Meteor Universal", WACL 2014)
with the English rank-task parameters:

    alpha=0.85  beta=0.2  gamma=0.6  delta=0.75
    stage weights: exact=1.0, stem=0.6, synonym=0.8, paraphrase=0.6

Scoring per segment (best reference wins, per the Meteor multi-ref rule):

    P = sum_i w_i (delta * m_i_c(h) + (1-delta) * m_i_f(h))
        / (delta * |h_c| + (1-delta) * |h_f|)
    R = same over the reference side
    Fmean = P * R / (alpha * P + (1-alpha) * R)
    frag  = chunks / matches        (matches = word-level match count)
    score = Fmean * (1 - gamma * frag**beta)

with the Meteor identity rule: a single chunk that covers BOTH strings
entirely counts as zero chunks, so an exact match scores 1.0.

Corpus-level score is computed from micro-aggregated statistics (the Meteor
"EVAL" aggregation), not a macro mean of segment scores.

Alignment: Meteor selects, among all one-to-one word alignments, one that
(1) maximizes the number of matched words, (2) minimizes the number of
chunks, (3) maximizes the total stage weight. The jar resolves this with a
beam search; captions are short, so the beam here (width 64 over hypothesis
positions) is effectively exhaustive and strictly better than a greedy
matcher.

Data files the jar bundles are pluggable here, and the default scorer ships
with vendored deterministic tables (``metrics/data/``) so ALL FOUR stages and
the content/function weighting run on the live eval path (VERDICT r3 #4):
  * synonyms: ``load_wordnet_synonyms()`` builds the table from nltk WordNet
    when the corpus is installed; otherwise the vendored
    ``data/synonym-en.tsv`` (hand-curated concept groups) loads via
    ``load_synonyms_tsv(path)`` (``word<TAB>syn1 syn2 ...`` format).
  * function words: vendored ``data/function-words-en.txt`` (the jar derives
    its list from corpus frequency; this is the documented closed-class
    equivalent), loaded via ``load_function_words(path)``.
  * paraphrases: phrase-level (multi-word span) equivalence pairs via
    ``load_paraphrases_tsv(path)`` — the jar's paraphrase-en table format;
    the aligner matches whole spans one-to-one at the word level, counting
    (|h-span| + |r-span|) / 2 matches per phrase (Meteor's averaged
    coverage). The jar's PPDB-derived table is absent from the checkout
    (.MISSING_LARGE_BLOBS), so the vendored hand-curated
    ``data/paraphrase-en.tsv`` restores the stage deterministically.

A copy of navc_tpu/metrics/meteor15.py with its own copy of the tables
(navc_tpu_torch/metrics/data) and navc_tpu's stage switches, read once,
when ``default_scorer`` first builds its singleton.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase
BEAM = 64

# Standard English function words (articles, pronouns, prepositions,
# conjunctions, auxiliaries, common particles). The meteor-1.5 jar ships a
# corpus-frequency-derived list; this vendored equivalent covers the same
# closed-class words.
FUNCTION_WORDS: Set[str] = set("""
a an the this that these those some any each every no neither either
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
yourselves themselves who whom whose which what
in on at by for with about against between into through during before after
above below to from up down out off over under again further of near
and or but nor so yet as because although though while if unless until when
whenever where wherever why how than whether
be am is are was were been being have has had having do does did doing
will would shall should may might must can could ought
not only also very too quite such own same just ever never here there then
now once
""".split())


_SNOWBALL = None
_STEM_CACHE: Dict[str, str] = {}


def _stem_word(w: str) -> str:
    """Snowball (Porter2) English stem — the stemmer the meteor-1.5 jar
    uses (org.tartarus.snowball.ext.englishStemmer); falls back to the
    vendored classic Porter when nltk is unavailable."""
    global _SNOWBALL
    s = _STEM_CACHE.get(w)
    if s is not None:
        return s
    if _SNOWBALL is None:
        try:
            from nltk.stem.snowball import SnowballStemmer
            _SNOWBALL = SnowballStemmer("english").stem
        except Exception:
            from .meteor import _stem
            _SNOWBALL = _stem
    s = _SNOWBALL(w)
    _STEM_CACHE[w] = s
    return s


# ---------------------------------------------------------------------------
# pluggable data tables
# ---------------------------------------------------------------------------


def load_wordnet_synonyms() -> Optional[Dict[str, Set[str]]]:
    """Build word -> synset-name set from nltk WordNet, if installed."""
    try:
        from nltk.corpus import wordnet as wn
        wn.synsets("test")  # force the lazy corpus load
    except Exception:
        return None

    def lookup(word: str) -> Set[str]:
        return {s.name() for s in wn.synsets(word)}

    return _LazySynTable(lookup)


class _LazySynTable(dict):
    """dict-like synonym table backed by a lookup function, memoized."""

    def __init__(self, lookup):
        super().__init__()
        self._lookup = lookup

    def __missing__(self, key):
        val = self._lookup(key)
        self[key] = val
        return val

    def get(self, key, default=None):  # noqa: A003
        return self[key]  # __missing__ memoizes; never falls back


DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _data_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def load_function_words(path: str) -> Set[str]:
    """One word per line; '#' lines are comments."""
    words: Set[str] = set()
    with open(path) as f:
        for line in f:
            w = line.strip()
            if w and not w.startswith("#"):
                words.add(w)
    return words


def load_synonyms_tsv(path: str) -> Dict[str, Set[str]]:
    """``word<TAB>syn1 syn2 ...`` -> word -> concept-id set (shared ids)."""
    table: Dict[str, Set[str]] = {}
    with open(path) as f:
        for n, line in enumerate(f):
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            word, syns = parts[0], parts[1].split()
            cid = "c%d" % n
            table.setdefault(word, set()).add(cid)
            for s in syns:
                table.setdefault(s, set()).add(cid)
    return table


def load_paraphrases_tsv(path: str) -> Dict[Tuple[str, ...], Set[Tuple[str, ...]]]:
    """Paraphrase pairs, one ``a<TAB>b`` per line (symmetric); each side may
    be a multi-word phrase (space-separated) — the meteor-1.5 jar's
    paraphrase-en table format (phrase-level, meteor.py:18-26)."""
    table: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2:
                a = tuple(parts[0].split())
                b = tuple(parts[1].split())
                if a and b:
                    table.setdefault(a, set()).add(b)
                    table.setdefault(b, set()).add(a)
    return table


# ---------------------------------------------------------------------------
# aligner
# ---------------------------------------------------------------------------


class Meteor15:
    def __init__(self,
                 synonyms: Optional[Dict[str, Set[str]]] = None,
                 paraphrases=None,
                 function_words: Optional[Set[str]] = None,
                 alpha: float = ALPHA, beta: float = BETA,
                 gamma: float = GAMMA, delta: float = DELTA,
                 weights: Sequence[float] = STAGE_WEIGHTS,
                 beam: int = BEAM,
                 identity_rule: bool = True):
        self.synonyms = synonyms
        # normalize paraphrases: accept a set of word pairs (legacy) or the
        # phrase table from load_paraphrases_tsv; split into a word-pair set
        # (fast path in _match_weight) and a phrase-span table for the aligner
        self.para_words: Set[Tuple[str, str]] = set()
        self.para_phrases: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
        self.max_phrase_len = 1
        if isinstance(paraphrases, dict):
            for a, targets in paraphrases.items():
                for b in targets:
                    if len(a) == 1 and len(b) == 1:
                        self.para_words.add((a[0], b[0]))
                    else:
                        self.para_phrases.setdefault(a, set()).add(b)
                        self.max_phrase_len = max(self.max_phrase_len,
                                                  len(a), len(b))
        elif paraphrases:
            self.para_words = set(paraphrases)
        self.function_words = (FUNCTION_WORDS if function_words is None
                               else function_words)
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.weights = tuple(weights)
        self.beam = beam
        self.identity_rule = identity_rule

    # -- stages -------------------------------------------------------------
    def _match_weight(self, h: str, hs: str, r: str, rs: str) -> Optional[float]:
        """Stage weight matching hyp word h (stem hs) to ref word r.

        Meteor's matcher runs its modules in order (exact, stem, synonym,
        paraphrase) and a pair matched by an earlier module is never
        re-matched by a later one — the FIRST matching stage's weight
        applies, not the maximum (e.g. a stem match that also shares a
        synset scores 0.6, not 0.8)."""
        if h == r:
            return self.weights[0]
        if hs == rs:
            return self.weights[1]
        if self.synonyms is not None:
            syn_h = self.synonyms.get(h) or set()
            if r in syn_h or (syn_h and syn_h & (self.synonyms.get(r) or set())):
                return self.weights[2]
        if self.para_words and (h, r) in self.para_words:
            return self.weights[3]
        return None

    def _phrase_candidates(self, hyp: List[str], ref: List[str]
                           ) -> Dict[int, List[Tuple[int, int, int, float]]]:
        """Phrase-span paraphrase matches: hi -> [(lh, rj, lr, w)].

        A hypothesis span hyp[hi:hi+lh] matches every occurrence of a
        table-paraphrase ref span ref[rj:rj+lr] (meteor-1.5's phrase-level
        paraphrase stage; the stage weight applies per covered word).
        """
        out: Dict[int, List[Tuple[int, int, int, float]]] = {}
        if not self.para_phrases:
            return out
        w = self.weights[3]
        pmax = self.max_phrase_len
        for hi in range(len(hyp)):
            for lh in range(1, min(pmax, len(hyp) - hi) + 1):
                targets = self.para_phrases.get(tuple(hyp[hi:hi + lh]))
                if not targets:
                    continue
                for tgt in targets:
                    lr = len(tgt)
                    for rj in range(len(ref) - lr + 1):
                        if tuple(ref[rj:rj + lr]) == tgt:
                            out.setdefault(hi, []).append((lh, rj, lr, w))
        return out

    # -- alignment ----------------------------------------------------------
    def _align(self, hyp: List[str], ref: List[str]
               ) -> Tuple[float, int, float, List[Tuple[int, int, int, int, float]]]:
        """Beam search for (matches, chunks, weight, pairs).

        Objective order: max matches, min chunks, max weight — the Meteor
        aligner's resolution criteria. Matches are one-to-one at the WORD
        level on both sides; a phrase match covers a (lh, lr) span pair and
        counts (lh + lr) / 2 matches (Meteor's averaged coverage — reduces
        to 1 for word matches). ``pairs`` entries are
        (h_start, h_len, r_start, r_len, stage_weight).
        """
        hs = [_stem_word(w) for w in hyp]
        rs = [_stem_word(w) for w in ref]
        cand: List[List[Tuple[int, int, int, float]]] = []
        for i, h in enumerate(hyp):
            row = []
            for j, r in enumerate(ref):
                w = self._match_weight(h, hs[i], r, rs[j])
                if w is not None:
                    row.append((1, j, 1, w))
            cand.append(row)
        for hi, phrases in self._phrase_candidates(hyp, ref).items():
            cand[hi].extend(phrases)

        # state: (used_ref frozenset, prev (h_end, r_end) or None,
        #         next_free_h, matches, chunks, weight, pairs)
        states = [(frozenset(), None, 0, 0.0, 0, 0.0, ())]
        for hi in range(len(hyp)):
            nxt = {}
            for st in states:
                used, prev, free, m, ch, wt, pairs = st
                # contiguity only survives if the previous match ends at
                # hi-1 OR LATER (an in-flight phrase span ending at >= hi
                # still determines chunk contiguity at its end — merging
                # those states would lose the ref-end and overcount chunks)
                key = (used, prev if prev and prev[0] >= hi - 1 else None,
                       max(free, hi))
                cur = nxt.get(key)
                if cur is None or (m, -ch, wt) > (cur[3], -cur[4], cur[5]):
                    nxt[key] = st
            states = list(nxt.values())

            out = []
            for st in states:
                used, prev, free, m, ch, wt, pairs = st
                out.append(st)  # skip hi
                if free > hi:   # hi already covered by an earlier phrase
                    continue
                for (lh, rj, lr, w) in cand[hi]:
                    span = frozenset(range(rj, rj + lr))
                    if used & span:
                        continue
                    contiguous = (prev is not None and prev[0] == hi - 1
                                  and prev[1] == rj - 1)
                    out.append((used | span, (hi + lh - 1, rj + lr - 1),
                                hi + lh, m + (lh + lr) / 2.0,
                                ch + (0 if contiguous else 1),
                                wt + w * (lh + lr) / 2.0,
                                pairs + ((hi, lh, rj, lr, w),)))
            out.sort(key=lambda s: (s[3], -s[4], s[5]), reverse=True)
            states = out[:self.beam]

        best = max(states, key=lambda s: (s[3], -s[4], s[5]))
        return best[3], best[4], best[5], list(best[6])

    # -- segment stats ------------------------------------------------------
    def _segment_stats(self, hyp: List[str], ref: List[str]):
        m, chunks, _, pairs = self._align(hyp, ref)
        # Meteor identity rule: one chunk spanning both strings entirely
        # counts as zero chunks (exact match scores 1.0)
        if self.identity_rule and chunks == 1 and m == len(hyp) == len(ref):
            chunks = 0

        d = self.delta
        fw = self.function_words

        def side(words: List[str], start_idx: int, len_idx: int):
            wc = wf = 0.0
            for pair in pairs:
                start, length, w = pair[start_idx], pair[len_idx], pair[4]
                for i in range(start, start + length):
                    if words[i] in fw:
                        wf += w
                    else:
                        wc += w
            nc = sum(1 for w in words if w not in fw)
            nf = len(words) - nc
            num = d * wc + (1 - d) * wf
            den = d * nc + (1 - d) * nf
            return num, den

        p_num, p_den = side(hyp, 0, 1)
        r_num, r_den = side(ref, 2, 3)
        return dict(m=m, chunks=chunks, p_num=p_num, p_den=p_den,
                    r_num=r_num, r_den=r_den)

    def _score_stats(self, s) -> float:
        if s["m"] == 0 or s["p_den"] == 0 or s["r_den"] == 0:
            return 0.0
        p = s["p_num"] / s["p_den"]
        r = s["r_num"] / s["r_den"]
        if p == 0 or r == 0:
            return 0.0
        fmean = p * r / (self.alpha * p + (1 - self.alpha) * r)
        frag = s["chunks"] / s["m"]
        return fmean * (1.0 - self.gamma * frag ** self.beta)

    # -- public API ----------------------------------------------------------
    def sentence(self, hyp: str, refs: List[str]) -> float:
        stats = self.best_ref_stats(hyp, refs)
        return self._score_stats(stats) if stats else 0.0

    def best_ref_stats(self, hyp: str, refs: List[str]):
        """Best-scoring reference's stats (ties -> first reference).

        An empty hypothesis still returns stats (m=0 with the reference
        side's denominators): the Meteor EVAL aggregation includes every
        segment, so dropping such segments would inflate the corpus score.
        """
        h = hyp.split()
        best, best_score = None, -1.0
        for ref in refs:
            r = ref.split()
            if not h and not r:
                continue  # both sides empty: no stats either way
            s = self._segment_stats(h, r)
            sc = self._score_stats(s)
            if sc > best_score:
                best, best_score = s, sc
        return best

    def corpus(self, hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
               ) -> Tuple[float, List[float]]:
        """Micro-aggregated corpus score + per-image scores (Meteor EVAL)."""
        agg = dict(m=0, chunks=0, p_num=0.0, p_den=0.0, r_num=0.0, r_den=0.0)
        per = []
        for vid in hyps:
            s = self.best_ref_stats(hyps[vid][0], refs[vid])
            if s is None:
                per.append(0.0)
                continue
            per.append(self._score_stats(s))
            for k in agg:
                agg[k] += s[k]
        return self._score_stats(agg), per


_DEFAULT: Optional[Meteor15] = None


def default_scorer() -> Meteor15:
    """Singleton exercising all four METEOR stages on the live path:
    exact + stem (always), synonyms (WordNet when installed, else the
    vendored ``data/synonym-en.tsv``), phrase-level paraphrases
    (``data/paraphrase-en-expanded.tsv``, navc_tpu's default table), and
    content/function weighting (``data/function-words-en.txt``).
    navc_tpu's switches, read when the singleton is built:
    ``NAVC_METEOR_BARE`` keeps exact + stem only (no synonyms, paraphrases
    or function words), ``NAVC_METEOR_NO_WORDNET`` takes the vendored
    synonyms even where WordNet is installed, ``NAVC_METEOR_TABLE=curated``
    the 169-line hand-curated paraphrase core (``data/paraphrase-en.tsv``)."""
    global _DEFAULT
    if _DEFAULT is None:
        if os.environ.get("NAVC_METEOR_BARE"):
            _DEFAULT = Meteor15(synonyms=None, paraphrases=None)
            return _DEFAULT
        syn = None if os.environ.get("NAVC_METEOR_NO_WORDNET") else \
            load_wordnet_synonyms()
        if syn is None:
            syn = load_synonyms_tsv(_data_path("synonym-en.tsv"))
        table = "paraphrase-en.tsv"
        if os.environ.get("NAVC_METEOR_TABLE", "expanded") != "curated" \
                and os.path.exists(_data_path("paraphrase-en-expanded.tsv")):
            table = "paraphrase-en-expanded.tsv"
        _DEFAULT = Meteor15(
            synonyms=syn,
            paraphrases=load_paraphrases_tsv(_data_path(table)),
            function_words=load_function_words(
                _data_path("function-words-en.txt")))
    return _DEFAULT


def corpus_meteor15(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
                    ) -> Tuple[float, List[float]]:
    return default_scorer().corpus(hyps, refs)
