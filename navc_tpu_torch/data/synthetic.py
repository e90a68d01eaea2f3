"""Synthetic corpus + feature fixtures for tests and the chip smoke run.

Port of navc_tpu/data/synthetic.py (``make_synthetic_corpus``,
``make_synthetic_feats``, ``write_hdf5_feats``): data in exactly the
``info_corpus.pkl`` schema the reference produces (prepare_corpora.py:53-65:
{'info': {...}, 'captions', 'pos_tags'}) plus in-memory feature dicts shaped
like the HDF5 stores, drawn from the same numpy streams as navc_tpu's, so the
train/eval pipeline runs end to end without external datasets.
"""

from __future__ import annotations

import string
from typing import Dict, Tuple

import numpy as np

from .. import constants as C
from ..config import Config


def make_synthetic_corpus(cfg: Config, n_videos: int = 12, n_caps: int = 3,
                          vocab_size: int = 40, seed: int = 0,
                          n_categories: int = 4) -> Tuple[Dict, Dict]:
    """Returns (info_corpus dict, references dict)."""
    rng = np.random.RandomState(seed)
    n_words = vocab_size - C.NUM_SPECIAL_TOKENS
    words = []
    alphabet = string.ascii_lowercase
    i = 0
    while len(words) < n_words:
        w = ""
        k = i
        for _ in range(3):
            w += alphabet[k % 26]
            k //= 26
        words.append("w" + w)
        i += 1
    itow = {j + C.NUM_SPECIAL_TOKENS: w for j, w in enumerate(words)}
    for tok, w in C.SPECIAL_TOKEN_WORDS.items():
        itow[tok] = w

    # POS vocabulary: ids >= 6 are tags, mirroring utils_corpora.py:184-210
    itop = {C.PAD: C.PAD_WORD, C.UNK: C.UNK_WORD, C.BOS: C.BOS_WORD,
            C.EOS: C.EOS_WORD, C.MASK: C.MASK_WORD, C.VIS: C.VIS_WORD,
            6: "NOUN", 7: "VERB", 8: "DET", 9: "ADJ"}
    tag_ids = [6, 7, 8, 9]

    n_train = max(2, int(n_videos * 0.6))
    n_val = max(1, int(n_videos * 0.2))
    split = {
        "train": list(range(n_train)),
        "validate": list(range(n_train, n_train + n_val)),
        "test": list(range(n_train + n_val, n_videos)),
    }

    captions: Dict[str, list] = {}
    pos_tags: Dict[str, list] = {}
    references: Dict[str, list] = {}
    length_info: Dict[str, list] = {}
    itoc = {}
    for v in range(n_videos):
        vid = "video%d" % v
        itoc[v] = int(rng.randint(n_categories))
        captions[vid] = []
        pos_tags[vid] = []
        references[vid] = []
        length_info[vid] = [0] * 50
        for ci in range(n_caps):
            length = int(rng.randint(4, min(cfg.max_len - 2, 12)))
            word_ids = list(rng.randint(C.NUM_SPECIAL_TOKENS, vocab_size, size=length))
            cap = [C.BOS] + word_ids + [C.EOS]
            tags = [C.BOS] + [int(rng.choice(tag_ids)) for _ in word_ids] + [C.EOS]
            captions[vid].append(cap)
            pos_tags[vid].append(tags)
            length_info[vid][length] += 1
            references[vid].append({
                "image_id": vid, "cap_id": ci,
                "caption": " ".join(itow[w] for w in word_ids),
            })

    split_category: Dict[str, Dict] = {"train": {}, "validate": {}, "test": {}}
    for mode, vids in split.items():
        for c in range(n_categories):
            split_category[mode][c] = [v for v in vids if itoc[v] == c]

    info_corpus = {
        "info": {
            "itow": itow,
            "itoc": itoc,
            "itop": itop,
            "length_info": length_info,
            "split": split,
            "split_category": split_category,
        },
        "captions": captions,
        "pos_tags": pos_tags,
    }
    return info_corpus, references


def make_synthetic_feats(cfg: Config, n_videos: int = 12, n_total_frames: int = 10,
                         seed: int = 1) -> Dict[str, Dict[str, np.ndarray]]:
    """In-memory per-modality vid -> (frames, dim) float32 arrays."""
    rng = np.random.RandomState(seed)
    feats: Dict[str, Dict[str, np.ndarray]] = {}
    for ch in cfg.modality.lower():
        dim = getattr(cfg, "dim_%s" % ch)
        feats["feats_%s" % ch] = {
            "video%d" % v: rng.randn(n_total_frames, dim).astype(np.float32)
            for v in range(n_videos)
        }
    return feats


def write_hdf5_feats(path: str, feats_for_modality: Dict[str, np.ndarray]) -> None:
    """Persist one modality's synthetic features as an HDF5 store."""
    import h5py

    with h5py.File(path, "w") as f:
        for vid, arr in feats_for_modality.items():
            f.create_dataset(vid, data=arr)
