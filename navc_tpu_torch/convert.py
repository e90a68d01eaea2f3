"""Weight bridge between a flax ``variables`` tree (numpy leaves) and the
port's model, both ways.

``navc_tpu`` keeps its weights as a flax tree ``{"params": ...,
"batch_stats": ...}``; its checkpoints pickle exactly that tree with numpy
leaves (navc_tpu/runtime/checkpoint.py). ``load_flax_variables`` fills a
``navc_tpu_torch`` Seq2Seq (student or teacher) from such a tree:

  * Dense ``kernel`` (in, out) is transposed into ``nn.Linear.weight``
    (out, in); ``bias`` is copied,
  * ``embedding`` tables fill ``nn.Embedding.weight``,
  * LayerNorm / BatchNorm ``scale`` becomes ``weight``,
  * BatchNorm ``batch_stats`` ``mean`` / ``var`` become ``running_mean`` /
    ``running_var``,
  * the tied projection bias ``tgt_word_prj_bias`` is copied as is.

Every parameter and running statistic of the model must be filled, and
every leaf of the tree must land somewhere, or the call raises.
``export_flax_variables`` is the inverse: the model's parameters and running
statistics as such a tree, so that a port model (after training steps, say)
can be held against navc_tpu's ``TrainState``.
"""

from __future__ import annotations

from typing import Any, Dict, Set

import numpy as np
import torch
from torch import nn

from .models.decoder import BertDecoder
from .models.layers import LayerNorm


def _child(module: nn.Module, name: str) -> nn.Module:
    """The port's submodule for a flax scope name."""
    for holder in ("streams", "norms", "predictors"):
        group = getattr(module, holder, None)
        if isinstance(group, nn.ModuleDict) and name in group:
            return group[name]
    if isinstance(module, BertDecoder) and name.startswith("layer_"):
        return module.layers[int(name[len("layer_"):])]
    child = getattr(module, name, None)
    if not isinstance(child, nn.Module):
        raise KeyError("no port module for flax scope %r under %s"
                       % (name, type(module).__name__))
    return child


def _copy(dst: torch.Tensor, src: Any, filled: Set[int], where: str) -> None:
    arr = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError("%s: flax shape %s vs port shape %s"
                         % (where, tuple(arr.shape), tuple(dst.shape)))
    with torch.no_grad():
        dst.copy_(arr.to(dst.device, dst.dtype))
    filled.add(id(dst))


def _leaf(tree: Dict[str, Any], key: str) -> bool:
    return key in tree and not isinstance(tree[key], dict)


def _fill(module: nn.Module, tree: Dict[str, Any], filled: Set[int],
          where: str) -> None:
    if _leaf(tree, "kernel"):       # Dense
        _copy(module.weight, np.asarray(tree["kernel"]).T, filled, where)
        if "bias" in tree:
            _copy(module.bias, tree["bias"], filled, where)
        return
    if _leaf(tree, "embedding"):    # Embed
        _copy(module.weight, tree["embedding"], filled, where)
        return
    if _leaf(tree, "scale"):        # LayerNorm / BatchNorm affine
        _copy(module.weight, tree["scale"], filled, where)
        _copy(module.bias, tree["bias"], filled, where)
        return
    if _leaf(tree, "mean"):         # BatchNorm batch_stats
        _copy(module.running_mean, tree["mean"], filled, where)
        _copy(module.running_var, tree["var"], filled, where)
        return
    for name, sub in tree.items():
        path = where + "/" + name
        if name == "tgt_word_prj_bias":
            _copy(module.tgt_word_prj_bias, sub, filled, path)
        else:
            _fill(_child(module, name), sub, filled, path)


def load_flax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a flax ``variables`` tree; returns it."""
    filled: Set[int] = set()
    _fill(model, variables["params"], filled, "params")
    if variables.get("batch_stats"):
        _fill(model, variables["batch_stats"], filled, "batch_stats")
    missing = [name for name, t in model.state_dict(keep_vars=True).items()
               if id(t) not in filled and not name.endswith("num_batches_tracked")]
    if missing:
        raise KeyError("flax tree leaves no value for: %s" % ", ".join(missing))
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _export(module: nn.Module, params: Dict[str, Any],
            stats: Dict[str, Any]) -> None:
    if isinstance(module, nn.Linear):
        params["kernel"] = _numpy(module.weight).T.copy()
        if module.bias is not None:
            params["bias"] = _numpy(module.bias)
        return
    if isinstance(module, nn.Embedding):
        params["embedding"] = _numpy(module.weight)
        return
    if isinstance(module, (LayerNorm, nn.BatchNorm1d)):
        params["scale"], params["bias"] = _numpy(module.weight), _numpy(module.bias)
        if isinstance(module, nn.BatchNorm1d):
            stats["mean"] = _numpy(module.running_mean)
            stats["var"] = _numpy(module.running_var)
        return
    if getattr(module, "tgt_word_prj_bias", None) is not None:
        params["tgt_word_prj_bias"] = _numpy(module.tgt_word_prj_bias)
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleDict):      # streams, norms, predictors
            items = list(child.items())
        elif isinstance(child, nn.ModuleList):    # the decoder's layers
            items = [("layer_%d" % i, c) for i, c in enumerate(child)]
        else:
            items = [(name, child)]
        for key, sub in items:
            p_sub, s_sub = {}, {}
            _export(sub, p_sub, s_sub)
            if p_sub:
                params[key] = p_sub
            if s_sub:
                stats[key] = s_sub


def export_flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The model's weights as a flax ``{"params", "batch_stats"}`` tree of
    float32 numpy arrays in navc_tpu's layout (Dense kernels (in, out))."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    _export(model, params, stats)
    return {"params": params, "batch_stats": stats}
