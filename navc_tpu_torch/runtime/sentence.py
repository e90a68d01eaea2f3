"""Sentence utilities: id->text, n-gram dedup, diversity analysis.

Capability parity with reference misc/utils.py:21-30 (to_sentence), 33-51
(get_dict_mapping), 66-98 (duplicate / remove_repeat_n_grame), 101-146
(novel/unique/vocab-usage analysis) and 149-155 (POS-tag word sets).

A copy of navc_tpu/runtime/sentence.py: the port imports nothing of
navc_tpu.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .. import constants as C


def get_dict_mapping(cfg, teacher_cfg, info_corpus, teacher_info):
    """Student->teacher vocab id map (reference misc/utils.py:33-51).

    Returns None when the vocabularies already agree; otherwise an
    (vocab_size,) int array mapping each student id to the teacher id of
    the same word (UNK when absent). Shared by cli/translate.py and
    api.CaptionPipeline."""
    import numpy as np

    if teacher_cfg is None or teacher_cfg.vocab_size == cfg.vocab_size:
        return None
    itow = info_corpus["info"]["itow"]
    t_itow = teacher_info["info"]["itow"]
    if itow == t_itow:
        return None
    t_wtoi = {w: i for i, w in t_itow.items()}
    arr = np.arange(cfg.vocab_size)
    for i, w in itow.items():
        arr[int(i)] = int(t_wtoi.get(w, C.UNK))
    return arr


def to_sentence(hyp: Sequence[int], vocab: Dict[int, str],
                break_words=(C.EOS, C.PAD), skip_words=()) -> str:
    sent = []
    for wid in hyp:
        wid = int(wid)
        if wid in skip_words:
            continue
        if wid in break_words:
            break
        sent.append(vocab[wid])
    return " ".join(sent)


def remove_repeat_n_gram(sent: List[str], n: int) -> Tuple[List[str], bool]:
    """Reference utils.py:66-81."""
    length = len(sent)
    rec: Dict[str, int] = {}
    for i in range(length - n + 1):
        key = " ".join(sent[i:i + n])
        if key in rec:
            dis = i - rec[key] - n
            if dis in (0, 1):
                result = sent[:i - dis]
                if i + n < length:
                    result += sent[i + n:]
                return result, False
        else:
            rec[key] = i
    return sent, True


def duplicate(sent: str) -> Tuple[str, str]:
    """4..1-gram repeated-span removal (reference utils.py:84-98)."""
    tokens = sent.split(" ")
    res: Dict[int, int] = {}
    for i in range(4, 0, -1):
        jud = False
        while not jud:
            tokens, jud = remove_repeat_n_gram(tokens, i)
            if not jud:
                res[i] = res.get(i, 0) + 1
            else:
                break
    res_str = ["%d-gram: %d" % (i, res.get(i, 0)) for i in range(1, 5)]
    return " ".join(tokens), "\t".join(res_str)


def _gt_ngrams(gt_captions: Dict[str, list], vocab: Dict[int, str],
               splits: Dict[str, list], n: int):
    """Reference utils.py:101-113."""
    gram_count: Dict[str, int] = {}
    gt_sents: Dict[str, int] = {}
    for i in splits["train"]:
        caps = gt_captions["video%d" % int(i)]
        for tmp in caps:
            cap = [vocab[int(w)] for w in tmp[1:-1]]
            key = " ".join(cap)
            gt_sents[key] = gt_sents.get(key, 0) + 1
            for j in range(len(cap) - n + 1):
                g = " ".join(cap[j:j + n])
                gram_count[g] = gram_count.get(g, 0) + 1
    return gram_count, gt_sents


def _pred_ngrams(pred: Dict[str, list], n: int):
    """Reference utils.py:116-129."""
    gram_count: Dict[str, int] = {}
    sents: Dict[str, int] = {}
    ave_length, count = 0, 0
    for vid in pred:
        for item in pred[vid]:
            cap_str = item["caption"]
            sents[cap_str] = sents.get(cap_str, 0) + 1
            cap = cap_str.split(" ")
            ave_length += len(cap)
            count += 1
            for j in range(len(cap) - n + 1):
                g = " ".join(cap[j:j + n])
                gram_count[g] = gram_count.get(g, 0) + 1
    return gram_count, sents, ave_length / max(count, 1), count


def get_words_with_specified_tags(word_to_ix, seq: str, index_set,
                                  demand=("NOUN", "VERB"),
                                  ignore_words=("is", "are", "<mask>")) -> None:
    """Collect vocab ids of words in ``seq`` whose POS tag is demanded
    (reference misc/utils.py:149-155; requires nltk)."""
    import nltk

    assert isinstance(index_set, set)
    for w, t in nltk.pos_tag(seq.split(" ")):
        if C.pos_tag_mapping.get(t) in demand and w not in ignore_words:
            index_set.add(word_to_ix[w])


def analyze_length_novel_unique(gt_captions, pred, vocab, splits, n: int = 1):
    """Reference utils.py:132-146: (ave_length, novel, unique, vocab usage,
    hypothesis n-gram counter, distinct 4-grams)."""
    hy_res, hy_sents, ave_length, hy_count = _pred_ngrams(pred, n)
    _, gt_sents = _gt_ngrams(gt_captions, vocab, splits, n)
    novel_count = sum(1 for s in hy_sents if s not in gt_sents)
    novel = novel_count / max(hy_count, 1)
    unique = len(hy_sents) / max(hy_count, 1)
    usage = len(hy_res)
    gram4, _, _, _ = _pred_ngrams(pred, 4)
    return ave_length, novel, unique, usage, hy_res, len(gram4)
