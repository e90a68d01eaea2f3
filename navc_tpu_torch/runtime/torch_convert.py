"""Reference PyTorch checkpoint -> flax-layout ``variables`` conversion.

A copy of navc_tpu/runtime/torch_convert.py (the port imports nothing of
navc_tpu). It converts a reference ``state_dict`` (the upstream
yangbang18/Non-Autoregressive-Video-Captioning ``Seq2Seq`` — see reference
models/__init__.py:64-94 for the module graph) into the flax ``variables``
tree with numpy leaves that navc_tpu's checkpoints hold;
``convert.load_flax_variables`` then fills a port model from it, so a
reference checkpoint runs on the card (``cli/convert.py``).

Naming correspondence (torch key -> flax path):

  encoder.Encoder_X.0.*                -> params/encoder/Encoder_X/linear
  encoder.Encoder_X.1.w{1,2}.*         -> params/encoder/Encoder_X/highway/w{1,2}
  joint_representation_learner.bnN.*   -> params/fusion/bnN (+ batch_stats)
  joint_representation_learner.lnN.*   -> params/fusion/lnN
  auxiliary_task_predictor.layers.J.net.{0,3}.* -> params/predictor_<crit>/fc{1,2}
  decoder[.bert].embedding.*           -> params/decoder/embedding
  decoder[.bert].layer.N.*             -> params/decoder/layer_N
  tgt_word_prj.weight                  -> params/tgt_word_prj/kernel (transposed)

Tensor-layout notes: torch ``nn.Linear.weight`` is (out, in) while flax
``nn.Dense.kernel`` is (in, out) -> transposed; embedding tables and LayerNorm
vectors carry over unchanged (torch LayerNorm ``weight`` is flax ``scale``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor, without importing torch
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _set(tree: Dict[str, Any], path: Sequence[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_LN_MAP = {"weight": "scale", "bias": "bias"}


def _convert_attention(rest: List[str]) -> Optional[Tuple[List[str], bool]]:
    """Map a Bert(Self)Attention suffix; returns (flax suffix, transpose)."""
    if rest[0] == "self" and rest[1] in ("query", "key", "value"):
        leaf = "kernel" if rest[2] == "weight" else "bias"
        return (["self", rest[1], leaf], rest[2] == "weight")
    if rest[0] == "output":
        if rest[1] == "dense":
            leaf = "kernel" if rest[2] == "weight" else "bias"
            return (["output", "dense", leaf], rest[2] == "weight")
        if rest[1] == "LayerNorm":
            return (["output", "LayerNorm", _LN_MAP[rest[2]]], False)
    return None


def translate_key(key: str, aux_crits: Sequence[str] = ("length",),
                  tie_weights: bool = False
                  ) -> Optional[Tuple[str, List[str], bool]]:
    """torch state_dict key -> (collection, flax path, transpose) or None (skip)."""
    parts = key.split(".")

    if parts[-1] == "num_batches_tracked":
        return None

    # ---- encoder streams (reference Encoder.py:62-66 Sequential(0=Linear,
    # 1=HighWay, 2=Dropout)) ------------------------------------------------
    if parts[0] == "encoder":
        stream = parts[1]  # Encoder_I / Encoder_M / ...
        if parts[2] == "0":
            leaf = "kernel" if parts[3] == "weight" else "bias"
            return ("params", ["encoder", stream, "linear", leaf], parts[3] == "weight")
        if parts[2] == "1":
            leaf = "kernel" if parts[4] == "weight" else "bias"
            return ("params", ["encoder", stream, "highway", parts[3], leaf],
                    parts[4] == "weight")
        return None

    # ---- fusion norms (reference joint_representation.py:13-22) ------------
    if parts[0] == "joint_representation_learner":
        norm = parts[1]  # bn0 / bn1 / ln0 ...
        leaf = parts[2]
        if leaf in ("weight", "bias"):
            return ("params", ["fusion", norm, _LN_MAP[leaf]], False)
        if leaf == "running_mean":
            return ("batch_stats", ["fusion", norm, "mean"], False)
        if leaf == "running_var":
            return ("batch_stats", ["fusion", norm, "var"], False)
        return None

    # ---- auxiliary predictors (reference Predictor.py:12-30; net.0/net.3
    # are the two Linear layers of the Sequential) ---------------------------
    if parts[0] == "auxiliary_task_predictor":
        idx = int(parts[2])  # layers.J
        crit = list(aux_crits)[idx]
        fc = {"0": "fc1", "3": "fc2"}[parts[4]]
        leaf = "kernel" if parts[5] == "weight" else "bias"
        return ("params", ["predictor_%s" % crit, fc, leaf], parts[5] == "weight")

    # ---- decoder (strip the Disentangled wrapper's .bert, Decoder.py:186) --
    if parts[0] == "decoder":
        rest = parts[1:]
        if rest[0] == "bert":
            rest = rest[1:]
        if rest[0] == "embedding":
            sub = rest[1]
            if sub in ("word_embeddings", "position_embeddings", "category_embeddings"):
                return ("params", ["decoder", "embedding", sub, "embedding"], False)
            if sub in ("LayerNorm", "pos_LN"):
                return ("params", ["decoder", "embedding", sub, _LN_MAP[rest[2]]], False)
            if sub == "word_embeddings_prj":
                leaf = "kernel" if rest[2] == "weight" else "bias"
                return ("params", ["decoder", "embedding", "word_embeddings_prj", leaf],
                        rest[2] == "weight")
            return None
        if rest[0] == "layer":
            layer = "layer_%d" % int(rest[1])
            mod = rest[2]
            if mod in ("attention", "pos_attention", "attend_to_enc_output"):
                sub = _convert_attention(rest[3:])
                if sub is None:
                    return None
                path, transpose = sub
                return ("params", ["decoder", layer, mod] + path, transpose)
            if mod in ("intermediate", "output") and rest[3] == "dense":
                leaf = "kernel" if rest[4] == "weight" else "bias"
                return ("params", ["decoder", layer, mod, "dense", leaf],
                        rest[4] == "weight")
            if mod == "output" and rest[3] == "LayerNorm":
                return ("params", ["decoder", layer, "output", "LayerNorm",
                                   _LN_MAP[rest[4]]], False)
            return None
        return None

    # ---- vocab projection (reference models/__init__.py:83; tied bias
    # seq2seq.py:30-33) ------------------------------------------------------
    if parts[0] == "tgt_word_prj":
        if parts[1] == "weight":
            if tie_weights:
                # shared with word_embeddings; the model projects through
                # the embedding table (models/seq2seq.py ``project``)
                return None
            return ("params", ["tgt_word_prj", "kernel"], True)
        if parts[1] == "bias":
            return ("params", ["tgt_word_prj_bias"], False)

    return None


def convert_state_dict(state_dict: Dict[str, Any],
                       aux_crits: Sequence[str] = ("length",),
                       tie_weights: bool = False,
                       strict: bool = True) -> Dict[str, Any]:
    """Convert a reference torch ``state_dict`` to flax ``variables``.

    Args:
        state_dict: torch tensors or numpy arrays keyed by dotted names.
        aux_crits: crits (in order) that have auxiliary predictor heads —
            the reference indexes them positionally (models/__init__.py:41-52).
        tie_weights: reference ``tie_weights`` flag; skips the (shared)
            projection weight.
        strict: raise on unrecognized keys instead of skipping them.

    Returns:
        {"params": ..., "batch_stats": ...} (batch_stats omitted when empty).
    """
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    unknown: List[str] = []
    for key, value in state_dict.items():
        spec = translate_key(key, aux_crits=aux_crits, tie_weights=tie_weights)
        if spec is None:
            if key.split(".")[-1] != "num_batches_tracked" and not (
                    tie_weights and key == "tgt_word_prj.weight"):
                unknown.append(key)
            continue
        collection, path, transpose = spec
        arr = _np(value)
        if transpose:
            arr = arr.T
        _set(params if collection == "params" else batch_stats, path,
             np.ascontiguousarray(arr))
    if unknown and strict:
        raise KeyError("unrecognized torch keys: %s" % unknown)

    variables: Dict[str, Any] = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return variables


def _flat_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in tree.items():
        p = prefix + "/" + k if prefix else k
        if isinstance(v, dict):
            out.update(_flat_paths(v, p))
        else:
            out[p] = tuple(np.shape(v))
    return out


def validate_against(variables: Dict[str, Any], template: Dict[str, Any]) -> None:
    """Assert the converted tree matches a template exactly (same leaf
    paths and shapes; a fresh port model's ``export_flax_variables``) —
    catches silent mis-mappings."""
    got = _flat_paths(variables)
    want = _flat_paths(template)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError("converted tree mismatch; missing=%s extra=%s"
                         % (missing, extra))
    bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    if bad:
        raise ValueError("converted tree shape mismatch: %s" % bad)
