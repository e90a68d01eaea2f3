"""The port's native caption metrics against navc_tpu's, on the CPU.

The port builds its own copy of navc_tpu/native (``metrics.cpp``,
``porter.h``) into ``navc_tpu_torch/build/`` with the host's C++ compiler.
On seeded caption corpora:

  * the library builds, from the port's sources, into the port's build
    directory;
  * tokenize, BLEU, CIDEr, ROUGE-L, the legacy METEOR and the Porter stemmer
    equal ``navc_tpu.native``'s EXACTLY, and the port's Python path within
    1e-10;
  * a corpus that is not ASCII takes the Python path in both packages (the
    same numbers as the Python scorers, exactly);
  * ``COCOScorer``'s summary and per-image detail equal navc_tpu's exactly,
    with no switch and under each ``NAVC_METEOR_*`` switch;
  * a build with a broken compiler raises (nothing falls back).
"""

import os

import numpy as np
import pytest

from navc_tpu.metrics import meteor15 as J15
from navc_tpu.metrics.scorer import COCOScorer as JaxScorer
from navc_tpu.native import lib as jnative
from navc_tpu_torch.metrics import (corpus_bleu, corpus_cider, corpus_meteor,
                                    corpus_rouge_l, ptb_tokenize)
from navc_tpu_torch.metrics import meteor15 as P15
from navc_tpu_torch.metrics.scorer import COCOScorer
from navc_tpu_torch.native import lib as native

WORDS = ("a man woman dog cat is are playing plays played running runs ran the on in "
         "guitar ball park kitchen cooking cooks food field soccer children kid "
         "someone something people group of two three small big red blue green car "
         "driving drives road street talking talks about video game singing song "
         "stage dancing dances music water swimming pool").split()
PUNCT = (",", ".", "!", "?", "'s", " --", "n't", ":", ";")


def corpus(seed, n_vids=12, n_refs=4, accent=False):
    """Seeded captions, raw (with punctuation and capitals) and as
    {vid: [str]} of tokenized strings."""
    rng = np.random.RandomState(seed)

    def caption():
        words = list(rng.choice(WORDS, rng.randint(3, 14)))
        if rng.rand() < 0.5:
            words[0] = words[0].capitalize()
        out = " ".join(w + (PUNCT[rng.randint(len(PUNCT))] if rng.rand() < 0.15 else "")
                       for w in words)
        return out + (" café" if accent and rng.rand() < 0.5 else "")

    raw_hyps = {"vid%d" % i: [caption()] for i in range(n_vids)}
    raw_refs = {"vid%d" % i: [caption() for _ in range(n_refs)] for i in range(n_vids)}
    tok = lambda c: {v: [" ".join(ptb_tokenize(s)) for s in caps] for v, caps in c.items()}
    return raw_hyps, raw_refs, tok(raw_hyps), tok(raw_refs)


def test_library_builds_from_the_port_sources():
    path = native.build()
    assert native.available()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("navc_tpu_torch", "build"))
    assert os.path.exists(path)
    here = os.path.dirname(os.path.abspath(native.__file__))
    for name in native.SOURCES:
        with open(os.path.join(here, name), "rb") as f, \
                open(os.path.join(os.path.dirname(jnative.__file__), name), "rb") as g:
            assert f.read() == g.read(), name  # navc_tpu's sources, byte for byte


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_equals_navc_tpu_and_python(seed):
    raw_hyps, raw_refs, hyps, refs = corpus(seed)
    for caps in list(raw_hyps.values()) + list(raw_refs.values()):
        for c in caps:
            assert native.tokenize(c) == jnative.tokenize(c) == ptb_tokenize(c), c
    bleu = native.bleu_corpus(hyps, refs)
    assert bleu == jnative.bleu_corpus(hyps, refs)
    np.testing.assert_allclose(bleu, corpus_bleu(hyps, refs)[0], rtol=1e-10, atol=1e-10)
    for fn, python in (("cider_corpus", corpus_cider), ("rouge_corpus", corpus_rouge_l),
                       ("meteor_corpus", corpus_meteor)):
        score, per = getattr(native, fn)(hyps, refs)
        assert (score, per) == getattr(jnative, fn)(hyps, refs), fn
        py_score, py_per = python(hyps, refs)
        assert abs(score - py_score) <= 1e-10, fn
        np.testing.assert_allclose(per, py_per, rtol=1e-10, atol=1e-10, err_msg=fn)
    words = sorted({w for caps in refs.values() for c in caps for w in c.split()})
    assert [native.porter_stem(w) for w in words] == [jnative.porter_stem(w) for w in words]


def test_non_ascii_takes_the_python_path():
    raw_hyps, raw_refs, hyps, refs = corpus(4, accent=True)
    assert not native._all_ascii(hyps, refs)
    assert native.tokenize("A CAFÉ, don't") == jnative.tokenize("A CAFÉ, don't") == \
        ptb_tokenize("A CAFÉ, don't")
    assert native.bleu_corpus(hyps, refs) == list(corpus_bleu(hyps, refs)[0]) == \
        jnative.bleu_corpus(hyps, refs)
    for fn, python in (("cider_corpus", corpus_cider), ("rouge_corpus", corpus_rouge_l),
                       ("meteor_corpus", corpus_meteor)):
        got = getattr(native, fn)(hyps, refs)
        assert got == python(hyps, refs) == getattr(jnative, fn)(hyps, refs), fn


@pytest.mark.parametrize("switch", [None, ("NAVC_METEOR_BARE", "1"),
                                    ("NAVC_METEOR_NO_WORDNET", "1"),
                                    ("NAVC_METEOR_TABLE", "curated"),
                                    ("NAVC_METEOR_LEGACY", "1")],
                         ids=["default", "bare", "no_wordnet", "curated", "legacy"])
@pytest.mark.parametrize("accent", [False, True], ids=["ascii", "non-ascii"])
def test_coco_scorer_matches_navc_tpu(switch, accent, monkeypatch):
    for name in ("NAVC_METEOR_BARE", "NAVC_METEOR_NO_WORDNET", "NAVC_METEOR_TABLE",
                 "NAVC_METEOR_LEGACY"):
        monkeypatch.delenv(name, raising=False)
    if switch is not None:
        monkeypatch.setenv(*switch)
    # each package builds its METEOR singleton once per process, from the
    # switches then set: start both afresh
    monkeypatch.setattr(P15, "_DEFAULT", None)
    monkeypatch.setattr(J15, "_DEFAULT", None)
    raw_hyps, raw_refs, _, _ = corpus(7, accent=accent)
    gts = {v: [{"caption": c} for c in caps] for v, caps in raw_refs.items()}
    res = {v: [{"caption": c} for c in caps] for v, caps in raw_hyps.items()}
    ids = sorted(gts)
    summary, detail = COCOScorer().score(gts, res, ids)
    want_summary, want_detail = JaxScorer().score(gts, res, ids)
    assert summary == want_summary
    assert detail == want_detail
    assert set(summary) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                            "CIDEr"}


def test_meteor_switches_change_the_scorer(monkeypatch):
    """The switches reach the singleton: BARE drops the synonym and
    paraphrase stages, the curated table is the smaller one."""
    for name in ("NAVC_METEOR_BARE", "NAVC_METEOR_TABLE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(P15, "_DEFAULT", None)
    full = P15.default_scorer()
    monkeypatch.setattr(P15, "_DEFAULT", None)
    monkeypatch.setenv("NAVC_METEOR_TABLE", "curated")
    curated = P15.default_scorer()
    monkeypatch.setattr(P15, "_DEFAULT", None)
    monkeypatch.setenv("NAVC_METEOR_BARE", "1")
    bare = P15.default_scorer()
    assert bare.synonyms is None and not bare.para_words and not bare.para_phrases
    size = lambda m: len(m.para_words) + sum(map(len, m.para_phrases.values()))
    assert 0 < size(curated) < size(full)
    assert P15.default_scorer() is bare  # built once


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"], ids=["missing", "failing"])
def test_broken_compiler_raises(cxx, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="native metrics build"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        COCOScorer().score({"v": [{"caption": "a dog"}]}, {"v": [{"caption": "a dog"}]}, ["v"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]
