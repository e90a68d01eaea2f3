"""The port's data pipeline, caption metrics and sentence tools against
navc_tpu's, on the CPU.

  * ``get_loader`` batches: equal to navc_tpu's, every array key and the
    metadata, over two shuffled epochs (the same numpy RNG streams: shuffle,
    frame sampling, MLM masks, visual-word targets), for NACF and ARB, with
    and without the prefetch thread; the synthetic fixtures are equal too.
  * ``COCOScorer``: on the synthetic references and on hand-written
    captions with synonyms, paraphrases and repeats, equal to navc_tpu's
    default path, which takes its C++ tokenizer, CIDEr and ROUGE-L as the
    port does (summaries to 1e-10, navc_tpu's own native-vs-Python
    tolerance, tests/test_native_metrics.py; per-image detail exactly), and,
    with the port's Python tokenizer and scorers in the native ones' place,
    to navc_tpu's Python path to 1e-12.
  * ``to_sentence``, ``duplicate``, ``analyze_length_novel_unique``: equal.
"""

import pickle

import numpy as np
import pytest

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.data.loader import get_loader as jax_get_loader
from navc_tpu.data.synthetic import make_synthetic_corpus as jax_corpus
from navc_tpu.data.synthetic import make_synthetic_feats as jax_feats
from navc_tpu.metrics import COCOScorer as JaxScorer
from navc_tpu.runtime import sentence as jax_sentence
from navc_tpu_torch.config import default_config
from navc_tpu_torch.data.loader import get_loader
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from navc_tpu_torch.metrics import COCOScorer, corpus_cider, corpus_rouge_l, ptb_tokenize
from navc_tpu_torch.runtime import sentence

TOY = dict(vocab_size=40, dim_i=12, dim_m=10, modality="mi", max_len=10,
           n_frames=4, n_total_frames=10, batch_size=5, n_caps_per_video=2)


def configs(method):
    jcfg = jax_default_config(method, dataset="MSVD", **TOY)
    cfg = default_config(method, dataset="MSVD", **TOY)
    assert cfg.to_dict() == jcfg.to_dict()
    return jcfg, cfg


@pytest.fixture(scope="module")
def fixtures():
    _, cfg = configs("NACF")
    corpus, refs = make_synthetic_corpus(cfg, n_videos=14, n_caps=3, vocab_size=40)
    feats = make_synthetic_feats(cfg, n_videos=14, n_total_frames=10)
    jcorpus, jrefs = jax_corpus(cfg, n_videos=14, n_caps=3, vocab_size=40)
    jfeats = jax_feats(cfg, n_videos=14, n_total_frames=10)
    assert pickle.dumps(corpus) == pickle.dumps(jcorpus) and refs == jrefs
    assert feats.keys() == jfeats.keys()
    for k in feats:
        assert all(np.array_equal(feats[k][v], jfeats[k][v]) for v in jfeats[k])
    return corpus, refs, feats


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("prefetch", [0, 2], ids=["inline", "prefetch"])
@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_loader_batches_equal_navc_tpu(fixtures, method, prefetch):
    corpus, _, feats = fixtures
    jcfg, cfg = configs(method)
    for mode in ("train", "validate"):
        ours = get_loader(cfg, mode, info_corpus=corpus, in_memory_feats=feats,
                          prefetch=prefetch)
        theirs = jax_get_loader(jcfg, mode, info_corpus=corpus, in_memory_feats=feats,
                                prefetch=0)
        assert len(ours) == len(theirs)
        for _ in range(2):  # two epochs: the RNG streams carry on
            ours.dataset.shuffle()
            theirs.dataset.shuffle()
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert_batches_equal(g, w)
        if method == "NACF" and mode == "train":
            assert "labels_1" in got[0] and "tokens_1" in got[0]


HAND = {
    "video0": ["a man is playing a guitar", "a man plays the guitar",
               "someone is playing guitar on stage"],
    "video1": ["a woman is cooking food in a kitchen", "a lady cooks a meal",
               "a woman prepares food"],
    "video2": ["two dogs run in a field", "dogs are running on the grass"],
}
HYPS = {
    "video0": "a guy is playing a guitar guitar",   # synonym + repeat
    "video1": "a woman is making food in the kitchen",  # paraphrase
    "video2": "a dog runs runs runs in the field",  # repeats
}


def _caption_sets(refs, vocab_words=None):
    gts = {vid: [{"image_id": vid, "caption": c} for c in caps]
           for vid, caps in refs.items()}
    return gts


@pytest.mark.parametrize("source", ["synthetic", "hand"])
def test_coco_scorer_equals_navc_tpu(fixtures, source, monkeypatch):
    corpus, refs, _ = fixtures
    if source == "synthetic":
        gts = refs
        rng = np.random.RandomState(3)
        res = {}
        for vid, caps in refs.items():
            words = caps[0]["caption"].split()
            rng.shuffle(words)  # scrambled first reference, some dropped
            res[vid] = [{"image_id": vid, "caption": " ".join(words[:max(1, len(words) - 1)])}]
    else:
        gts = _caption_sets(HAND)
        res = {vid: [{"image_id": vid, "caption": c}] for vid, c in HYPS.items()}
    got, got_img = COCOScorer().score(gts, res, res.keys())
    want, want_img = JaxScorer().score(gts, res, res.keys())
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-10, (k, got[k], want[k])
    assert got_img == want_img  # both on the native library's CIDEr and ROUGE-L

    import navc_tpu.native.lib as native
    import navc_tpu_torch.native.lib as port_native
    monkeypatch.setattr(native, "available", lambda: False)  # its Python path
    # the port's Python path: its Python tokenizer and scorers in the native ones' place
    monkeypatch.setattr(port_native, "tokenize", ptb_tokenize)
    monkeypatch.setattr(port_native, "cider_corpus", corpus_cider)
    monkeypatch.setattr(port_native, "rouge_corpus", corpus_rouge_l)
    got, got_img = COCOScorer().score(gts, res, res.keys())
    want, want_img = JaxScorer().score(gts, res, res.keys())
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    for vid in want_img:
        for k in want_img[vid]:
            if k != "image_id":
                assert abs(got_img[vid][k] - want_img[vid][k]) <= 1e-12, (vid, k)
    assert 0.0 < got["METEOR"] < 1.0 and got["CIDEr"] > 0.0


def test_sentence_tools_equal_navc_tpu(fixtures):
    corpus, _, _ = fixtures
    itow = corpus["info"]["itow"]
    rng = np.random.RandomState(0)
    for _ in range(20):
        ids = rng.randint(0, 40, 12)
        assert sentence.to_sentence(ids, itow) == jax_sentence.to_sentence(ids, itow)
    for s in ["a man a man is is running running on on the the road",
              "the cat the cat the cat sat", "one two three one two three four",
              "no repeats here at all", "x"]:
        assert sentence.duplicate(s) == jax_sentence.duplicate(s)
    pred = {vid: [{"caption": sentence.to_sentence(caps[0][1:-1], itow)}]
            for vid, caps in list(corpus["captions"].items())[:6]}
    pred["video13"] = [{"caption": "wabc wabc wbbc"}]
    args = (corpus["captions"], pred, itow)
    kw = dict(splits=corpus["info"]["split"], n=1)
    assert (sentence.analyze_length_novel_unique(*args, **kw)
            == jax_sentence.analyze_length_novel_unique(*args, **kw))
