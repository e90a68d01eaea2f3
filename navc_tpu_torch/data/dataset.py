"""Video-caption dataset: per-item feature sampling + token construction.

Port of navc_tpu/data/dataset.py (reference dataloader.py): every item is
produced as fixed-shape NumPy arrays. Randomness uses a seeded
``np.random.RandomState`` like the reference (dataloader.py:68), drawn in
navc_tpu's order, so the two packages give equal items and batches.
With ``host_lockstep`` (a host-sharded loader sets it) the decisions every
rank must take alike (the epoch permutation, the per-epoch caption choice)
come from ``structure_random`` (seed + 0x5eed), which per-item draws never
touch: each rank draws per item for its own shard only.

Replicated semantics (reference line cites):
  * frame sampling strategies segment_random / all_random / equally_sampling
    (dataloader.py:24-37); eval always equally_sampling (43-48),
  * load_feats_type 0/1/2 branches + short-video linspace resampling
    (dataloader.py:263-315, 20-21),
  * per-(video, caption) infoset with normalized length-histogram targets
    (dataloader.py:146-201) and per-epoch resampling when n_caps_per_video>0
    (103-108),
  * NAR MLM masking: train masks a beta-ratio random subset (min 1), eval
    masks everything; targets only at masked slots (dataloader.py:349-381),
  * visual-word source/target: source all <vis>, target keeps demanded-POS
    tokens (minus 'be' verbs) and <mask> elsewhere (dataloader.py:383-425),
  * padding/truncation to max_len with EOS repair (dataloader.py:317-327).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import constants as C
from ..config import Config


def resampling_ids(source_length: int, target_length: int) -> List[int]:
    """Linspace index resampling (reference dataloader.py:20-21)."""
    return [round(i * (source_length - 1) / (target_length - 1)) for i in range(target_length)]


def get_frame_ids(n_total_frames: int, n_frames: int, random_type: str,
                  rng: np.random.RandomState) -> List[int]:
    """Frame-id sampling (reference dataloader.py:24-37)."""
    if random_type == "all_random":
        idx = list(rng.choice(n_total_frames, size=n_frames, replace=False))
    else:
        bound = [int(i) for i in np.linspace(0, n_total_frames, n_frames + 1)]
        idx = []
        for i in range(n_frames):
            if random_type == "equally_sampling":
                tmp = (bound[i] + bound[i + 1]) // 2
            else:  # segment_random
                tmp = rng.randint(bound[i], bound[i + 1])
            idx.append(tmp)
    return sorted(int(i) for i in idx)


class FeatureSource:
    """A set of per-video feature arrays for one modality.

    Abstracts over HDF5 files and in-memory dicts (synthetic fixtures); one
    modality may have several files whose features concatenate on the channel
    axis (reference dataloader.py:272-295).
    """

    def __init__(self, stores: Sequence[Any], dim: int, max_len_default: int,
                 n_total_frames: int = 60):
        assert len(stores) > 0
        self.stores = list(stores)
        self.dim = dim
        self.n_total_frames = n_total_frames
        # reference dataloader.py:268-270: an hdf5-level 'max_len' dataset
        # overrides n_frames as the padded length
        ml = None
        first = self.stores[0]
        if hasattr(first, "get") and first.get("max_len") is not None:
            try:
                ml = int(np.asarray(first.get("max_len")))
            except TypeError:
                ml = None
        self.max_seq_len = ml if ml is not None else max_len_default

    def load(self, vid: str) -> np.ndarray:
        feats = []
        pre_len = None
        for store in self.stores:
            if vid not in store:
                return np.zeros((self.max_seq_len, self.dim), np.float32)
            data = np.asarray(store[vid], dtype=np.float32)
            if data.ndim == 1:
                # a 1-D (per-video) feature broadcasts over time: to the
                # length of the preceding 2-D store in this modality, else to
                # n_total_frames (reference dataloader.py:281-285 — NOT the
                # padded max_seq_len; the sampling branches downstream expect
                # the raw temporal length)
                n = pre_len if pre_len is not None else self.n_total_frames
                data = np.repeat(data[None, :], n, axis=0)
            else:
                pre_len = data.shape[0]
            feats.append(data)
        return np.concatenate(feats, axis=1) if len(feats) > 1 else feats[0]


def open_feature_sources(cfg: Config, in_memory: Optional[Dict[str, Dict[str, np.ndarray]]] = None
                         ) -> Dict[str, FeatureSource]:
    """Open per-modality stores (reference dataloader.py:132-144).

    ``in_memory`` maps 'feats_<ch>' to a dict of vid -> array (synthetic
    features); other modalities open their HDF5 files, and only then is
    h5py imported (it is needed for HDF5 features alone).
    """
    sources: Dict[str, FeatureSource] = {}
    for ch in cfg.modality.lower():
        key = "feats_%s" % ch
        if in_memory is not None and key in in_memory:
            stores: List[Any] = [in_memory[key]]
        else:
            import h5py

            paths = getattr(cfg, key)
            if not isinstance(paths, list):
                paths = [paths]
            stores = [h5py.File(p, "r") for p in paths if str(p).endswith(".hdf5")]
        assert stores, "no feature stores for modality %r" % ch
        sources[key] = FeatureSource(stores, getattr(cfg, "dim_%s" % ch),
                                     cfg.n_frames, cfg.n_total_frames)
    return sources


class VideoDataset:
    """Reference VideoDataset (dataloader.py:40-217) on NumPy."""

    def __init__(self, cfg: Config, mode: str,
                 info_corpus: Optional[Dict] = None,
                 in_memory_feats: Optional[Dict] = None,
                 specific: int = -1):
        assert mode in ("train", "validate", "test")
        self.cfg = cfg
        self.mode = mode
        if mode != "train":
            self.random_type = "equally_sampling"
            # parallel_mlm evaluates every caption (reference dataloader.py:48)
            self.n_caps_per_video = 0 if getattr(cfg, "parallel_mlm", False) else 1
        else:
            self.random_type = cfg.random_type
            self.n_caps_per_video = cfg.n_caps_per_video
            assert self.random_type in ("segment_random", "all_random", "equally_sampling")

        if info_corpus is None:
            with open(cfg.info_corpus, "rb") as f:
                info_corpus = pickle.load(f)
        data = info_corpus
        self.captions = data["captions"]
        self.pos_tags = data.get("pos_tags")
        info = data["info"]
        self.itow = info["itow"]
        self.itoc = info.get("itoc")
        self.itop = info.get("itop")
        self.length_info = info.get("length_info")
        self.splits = info["split"]
        self.split_category = info.get("split_category")
        self.specific = specific

        self.random = np.random.RandomState(cfg.seed)
        # host-sharded loading: each rank's per-item draws (frame sampling,
        # MLM masking) advance self.random by its own shard's amounts, so
        # what must be the same on every rank comes from a stream per-item
        # draws never touch (navc_tpu dataset.py:160-169)
        self.host_lockstep = False
        self.structure_random = np.random.RandomState(cfg.seed + 0x5eed)
        self.sources = open_feature_sources(cfg, in_memory_feats)
        self.infoset = self._make_infoset()
        self._references = None

    # ------------------------------------------------------------------
    def get_vocab(self) -> Dict[int, str]:
        return self.itow

    def get_references(self):
        if self._references is None:
            with open(self.cfg.reference, "rb") as f:
                self._references = pickle.load(f)
        return self._references

    def set_references(self, refs) -> None:
        self._references = refs

    def shuffle(self) -> None:
        """Per-epoch infoset resampling (reference dataloader.py:103-108)."""
        if self.n_caps_per_video != 0:
            self.infoset = self._make_infoset()

    def __len__(self) -> int:
        return len(self.infoset)

    # ------------------------------------------------------------------
    def _make_infoset(self) -> List[Dict]:
        cfg = self.cfg
        infoset = []
        # ``specific`` >= 0 keeps one category's videos of the split
        # (reference dataloader.py:126-130)
        if self.specific != -1:
            ix_set = self.split_category[self.mode][self.specific]
        else:
            ix_set = self.splits[self.mode]
        for ix in (int(i) for i in ix_set):
            vid = "video%d" % ix
            category = self.itoc[ix] if self.itoc is not None else 0
            captions = self.captions[vid]
            pos_tags = self.pos_tags[vid] if self.pos_tags is not None else [None] * len(captions)
            assert len(captions) == len(pos_tags)

            if self.length_info is None:
                length_target = np.zeros(cfg.max_len, np.float32)
            else:
                lt = list(self.length_info[vid])[: cfg.max_len]
                lt = lt + [0] * (cfg.max_len - len(lt))
                arr = np.asarray(lt, np.float64)
                s = arr.sum()
                length_target = (arr / s if s > 0 else arr).astype(np.float32)

            if self.n_caps_per_video == 0:
                cap_id_set = list(range(len(captions)))
            elif self.n_caps_per_video == 1 and self.mode != "train":
                cap_id_set = [0]
            else:
                n = min(len(captions), self.n_caps_per_video)
                rng = self.structure_random if self.host_lockstep else self.random
                cap_id_set = list(rng.choice(len(captions), n, replace=False))

            for cap_id in cap_id_set:
                infoset.append({
                    "vid": vid,
                    "labels": captions[cap_id],
                    "pos_tags": pos_tags[cap_id],
                    "category": category,
                    "length_target": length_target,
                    "cap_id": int(cap_id),
                })
        return infoset

    # ------------------------------------------------------------------
    def __getitem__(self, ix: int) -> Dict[str, Any]:
        item = self.infoset[ix]
        data: Dict[str, Any] = {"video_ids": item["vid"], "caption_ids": item["cap_id"]}
        data.update(self._prepare_video_features(item["vid"]))
        data.update(self._prepare_input_ids(item["labels"], item["pos_tags"]))
        data["length_target"] = item["length_target"]
        data["category"] = np.asarray([item["category"]], np.int32)
        return data

    def _prepare_video_features(self, vid: str) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}
        shared_frame_ids = None
        if cfg.load_feats_type == 0:
            shared_frame_ids = get_frame_ids(
                cfg.n_total_frames, cfg.n_frames, self.random_type, self.random)
        for key, src in self.sources.items():
            feats = src.load(vid)
            out[key] = self._sample_frames(feats, src, shared_frame_ids).astype(np.float32)
        return out

    def _sample_frames(self, feats: np.ndarray, src: FeatureSource,
                       shared_frame_ids) -> np.ndarray:
        """load_feats_type branches (reference dataloader.py:297-315)."""
        cfg = self.cfg
        if cfg.load_feats_type == 0:
            assert shared_frame_ids is not None
            frame_ids = [min(i, feats.shape[0] - 1) for i in shared_frame_ids]
        elif cfg.load_feats_type == 1:
            n = feats.shape[0]
            if n >= cfg.n_frames:
                frame_ids = get_frame_ids(n, cfg.n_frames, self.random_type, self.random)
            else:
                frame_ids = resampling_ids(n, src.max_seq_len)
        else:  # 2: all feats, resample short videos
            n = feats.shape[0]
            if n < src.max_seq_len:
                frame_ids = resampling_ids(n, src.max_seq_len)
            else:
                frame_ids = list(range(n))
        return feats[frame_ids]

    # ------------------------------------------------------------------
    def _padding(self, seq, add_eos: bool = True):
        """Reference dataloader.py:317-327."""
        if seq is None:
            return None
        res = list(seq)
        max_len = self.cfg.max_len
        if len(res) > max_len:
            res = res[:max_len]
            if add_eos:
                res[-1] = C.EOS
        else:
            res = res + [C.PAD] * (max_len - len(res))
        return res

    def _prepare_input_ids(self, labels, taggings) -> Dict[str, np.ndarray]:
        results = self._make_source_target(labels, taggings)
        out = {
            "tokens": np.asarray(results["dec_source"], np.int32),
            "labels": np.asarray(results["dec_target"], np.int32),
        }
        if results.get("tagging") is not None:
            out["taggings"] = np.asarray(results["tagging"], np.int32)
        if "dec_source_1" in results:
            out["tokens_1"] = np.asarray(results["dec_source_1"], np.int32)
            out["labels_1"] = np.asarray(results["dec_target_1"], np.int32)
        return out

    def _make_source_target(self, target, tagging) -> Dict[str, Any]:
        """Reference dataloader.py:329-347."""
        cfg = self.cfg
        if cfg.decoding_type == "NARFormer":
            results = self._source_target_mlm(list(target[1:-1]))  # strip BOS/EOS
        else:
            results = {
                "dec_source": self._padding(target, add_eos=True),
                "dec_target": self._padding(target, add_eos=True),
            }
        assert len(results["dec_source"]) == len(results["dec_target"])
        if cfg.visual_word_generation:
            results.update(self._source_target_visual_word(target, tagging))
        if "tagging" not in results:
            results["tagging"] = self._padding(tagging, add_eos=True)
        return results

    def _source_target_mlm(self, target: List[int]) -> Dict[str, Any]:
        """Reference dataloader.py:349-381."""
        cfg = self.cfg
        assert not target or target[0] != C.BOS
        assert not target or target[-1] != C.EOS
        beta_low, beta_high = cfg.beta
        min_num_masks = 1
        dec_source = np.asarray(target, np.int64)
        dec_target_cp = dec_source.copy()
        dec_target = np.full(len(dec_source), C.PAD, np.int64)

        if self.mode == "train":
            if min_num_masks >= len(dec_source):
                ind = np.array([], np.int64)
            else:
                low = max(int(len(dec_source) * beta_low), min_num_masks)
                high = max(int(len(dec_source) * beta_high), min_num_masks)
                if high == low:
                    high += 1
                sample_size = self.random.randint(low, high)
                ind = self.random.choice(len(dec_source), size=sample_size, replace=False)
            if len(ind):
                dec_source[ind] = C.MASK
                dec_target[ind] = dec_target_cp[ind]
        else:
            dec_source[dec_source != C.PAD] = C.MASK
            dec_target = dec_target_cp

        return {
            "dec_source": self._padding(dec_source.tolist(), add_eos=False),
            "dec_target": self._padding(dec_target.tolist(), add_eos=False),
        }

    def _source_target_visual_word(self, target, pos_tag) -> Dict[str, Any]:
        """Reference dataloader.py:383-425."""
        cfg = self.cfg
        sent_length = len(target[1:-1])
        is_nar = cfg.decoding_type == "NARFormer"

        if self.mode != "train":
            return {"dec_source_1": [0], "dec_target_1": [0]}

        assert len(target) == len(pos_tag)
        assert self.itop is not None

        dec_source_1 = self._padding(
            [C.VIS] * (sent_length if is_nar else len(target)),
            add_eos=not is_nar,
        )

        pos_satisfied_ind = []
        for i, item in enumerate(pos_tag[1:-1]):
            w = self.itow[target[i + 1]]
            if self.itop[item] in cfg.demand and w not in C.IGNORED_VISUAL_WORDS:
                pos_satisfied_ind.append(i)

        dec_target_1 = np.full(sent_length, C.MASK, np.int64)
        dec_target_cp = np.asarray(target[1:-1], np.int64)
        if pos_satisfied_ind:
            idx = np.asarray(pos_satisfied_ind, np.int64)
            dec_target_1[idx] = dec_target_cp[idx]

        if is_nar:
            dec_target_1 = self._padding(dec_target_1.tolist(), add_eos=False)
        else:
            dec_target_1 = self._padding(
                [target[0]] + dec_target_1.tolist() + [C.EOS], add_eos=True)

        return {"dec_source_1": dec_source_1, "dec_target_1": dec_target_1}
