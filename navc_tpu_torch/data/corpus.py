"""Offline corpus preparation: vocab, POS tags, length histograms, splits.

Capability parity with reference prepare_corpora.py + misc/utils_corpora.py,
producing byte-compatible ``info_corpus.pkl`` / ``refs.pkl`` schemas so either
stack can consume either's artifacts:

  info_corpus = {'info': {'itow', 'itoc'?, 'itop', 'length_info', 'split',
                          'split_category'?}, 'captions', 'pos_tags'}
  refs = {vid: [{'image_id', 'cap_id', 'caption'}, ...]}

A copy of navc_tpu/data/corpus.py (the port imports nothing of
navc_tpu): the same functions, the same pickles.

Differences from the reference (documented):
  * no network downloads (zero-egress environment): raw annotation files must
    already exist locally (reference downloads them via wget,
    utils_corpora.py:16-19, 73-81);
  * nltk is optional — when its POS tagger is unavailable a heuristic tagger
    marks everything NOUN/VERB-less, which only disables visual-word
    supervision quality, not the pipeline.
"""

from __future__ import annotations

import json
import pickle
import string
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .. import constants as C


# ---------------------------------------------------------------------------
# Raw preprocessing (reference utils_corpora.py:13-114)
# ---------------------------------------------------------------------------


def preprocess_msrvtt(videodatainfo_json: str) -> Dict:
    """Parse the MSR-VTT annotation json (utils_corpora.py:13-65)."""
    with open(videodatainfo_json) as f:
        json_data = json.load(f)
    sentences = json_data["sentences"]
    videos = json_data["videos"]

    split: Dict[str, list] = {"train": [], "validate": [], "test": []}
    for v in videos:
        split[v["split"]].append(int(v["id"]))

    raw_caps_all = defaultdict(list)
    raw_caps_train = defaultdict(list)
    references = defaultdict(list)
    train_set = set(split["train"])

    for item in sentences:
        vid = item["video_id"]
        tokens = [t.lower() for t in item["caption"].split()
                  if t not in string.punctuation]
        raw_caps_all[vid].append(tokens)
        if int(vid[5:]) in train_set:
            raw_caps_train[vid].append(tokens)
        references[vid].append({
            "image_id": vid, "cap_id": len(references[vid]),
            "caption": " ".join(tokens)})

    itoc = {}
    split_category = {"train": defaultdict(list), "validate": defaultdict(list),
                      "test": defaultdict(list)}
    for item in videos:
        itoc[item["id"]] = item["category"]
        split_category[item["split"]][int(item["category"])].append(int(item["id"]))

    return {"split": split, "raw_caps_train": raw_caps_train,
            "raw_caps_all": raw_caps_all, "references": dict(references),
            "itoc": itoc, "split_category": split_category}


def preprocess_youtube2text(refs_pickle: str) -> Dict:
    """Parse the MSVD refs pickle (utils_corpora.py:68-114); fixed splits
    1200/100/670."""
    split = {"train": list(range(1200)),
             "validate": list(range(1200, 1300)),
             "test": list(range(1300, 1970))}
    with open(refs_pickle, "rb") as f:
        refs = pickle.load(f)
    raw_caps_all = defaultdict(list)
    raw_caps_train = {}
    train_set = set(split["train"])
    for vid in refs:
        num = int(vid[5:])
        for item in refs[vid]:
            raw_caps_all[vid].append(item["caption"].lower().split())
        if num in train_set:
            raw_caps_train[vid] = raw_caps_all[vid]
    return {"split": split, "raw_caps_train": raw_caps_train,
            "raw_caps_all": raw_caps_all, "references": refs}


# ---------------------------------------------------------------------------
# Vocab / tags / lengths (reference utils_corpora.py:117-222)
# ---------------------------------------------------------------------------


def build_vocab(train_vid2caps: Dict[str, List[List[str]]], count_thr: int,
                sort_vocab: bool = False, verbose: bool = True) -> List[str]:
    counts: Dict[str, int] = {}
    for caps in train_vid2caps.values():
        for cap in caps:
            for w in cap:
                counts[w] = counts.get(w, 0) + 1
    bad = [w for w, n in counts.items() if n <= count_thr]
    if verbose:
        total = sum(counts.values())
        bad_count = sum(counts[w] for w in bad)
        print("- bad words: %d/%d; vocab: %d; UNK rate: %.2f%%" % (
            len(bad), len(counts), len(counts) - len(bad),
            100.0 * bad_count / max(total, 1)))
    cand = [(w, n) for w, n in counts.items() if n > count_thr]
    if sort_vocab:
        cand = sorted(cand, key=lambda x: -x[1])
    return [w for w, _ in cand]


def get_length_info(captions: Dict[str, List[List[int]]],
                    max_length: int = 50) -> Dict[str, List[int]]:
    """Per-video caption-length histogram (utils_corpora.py:157-169)."""
    length_info = {}
    for vid, caps in captions.items():
        hist = [0] * max_length
        for cap in caps:
            length = len(cap) - 2  # exclude <bos>, <eos>
            if length < max_length:
                hist[length] += 1
        length_info[vid] = hist
    return length_info


def _pos_tag(tokens: List[str]) -> List[str]:
    """Universal POS tags per token via nltk, heuristic fallback."""
    try:
        import nltk
        tagged = nltk.pos_tag(tokens)
        return [C.pos_tag_mapping.get(t, "X") for _, t in tagged]
    except Exception:
        return ["X"] * len(tokens)


def get_captions_and_pos_tags(raw_caps_all: Dict[str, List[List[str]]],
                              vocab: List[str]):
    """Tokenize every caption into ids + tag ids (utils_corpora.py:172-222)."""
    itow = {i + C.NUM_SPECIAL_TOKENS: w for i, w in enumerate(vocab)}
    itow.update(C.SPECIAL_TOKEN_WORDS)
    wtoi = {w: i for i, w in itow.items()}

    ptoi = {C.SPECIAL_TOKEN_WORDS[i]: i for i in range(C.NUM_SPECIAL_TOKENS)}
    tag_start_i = C.NUM_SPECIAL_TOKENS

    captions = defaultdict(list)
    pos_tags = defaultdict(list)
    for vid, caps in raw_caps_all.items():
        for cap in caps:
            tags = _pos_tag(cap)
            caption_id = [C.BOS]
            tagging_id = [C.BOS]
            for w, tag in zip(cap, tags):
                if w in wtoi:
                    caption_id.append(wtoi[w])
                    if tag not in ptoi:
                        ptoi[tag] = tag_start_i
                        tag_start_i += 1
                    tagging_id.append(ptoi[tag])
                else:
                    caption_id.append(C.UNK)
                    tagging_id.append(C.UNK)
            caption_id.append(C.EOS)
            tagging_id.append(C.EOS)
            captions[vid].append(caption_id)
            pos_tags[vid].append(tagging_id)

    itop = {i: t for t, i in ptoi.items()}
    return itow, dict(captions), itop, dict(pos_tags)


# ---------------------------------------------------------------------------
# The preparation (reference prepare_corpora.py:16-66)
# ---------------------------------------------------------------------------


def prepare_corpus(dataset: str, raw_path: str, out_info_corpus: str,
                   out_refs: str, count_thr: Optional[int] = None,
                   sort_vocab: bool = False) -> Tuple[Dict, Dict]:
    """Build + pickle info_corpus and refs for a dataset.

    count_thr defaults: 2 for MSRVTT, 0 for Youtube2Text
    (reference prepare_corpora.py:10-13).
    """
    if dataset == "MSRVTT":
        data = preprocess_msrvtt(raw_path)
        thr = 2 if count_thr is None else count_thr
    elif dataset in ("Youtube2Text", "MSVD"):
        data = preprocess_youtube2text(raw_path)
        thr = 0 if count_thr is None else count_thr
    else:
        raise ValueError("unknown dataset %r" % dataset)

    vocab = build_vocab(data["raw_caps_train"], thr, sort_vocab)
    itow, captions, itop, pos_tags = get_captions_and_pos_tags(
        data["raw_caps_all"], vocab)
    length_info = get_length_info(captions)

    info = {
        "itow": itow,
        "itop": itop,
        "length_info": length_info,
        "split": data["split"],
    }
    if "itoc" in data:
        info["itoc"] = data["itoc"]
        info["split_category"] = data["split_category"]

    info_corpus = {"info": info, "captions": captions, "pos_tags": pos_tags}
    with open(out_info_corpus, "wb") as f:
        pickle.dump(info_corpus, f)
    with open(out_refs, "wb") as f:
        pickle.dump(data["references"], f)
    return info_corpus, data["references"]
