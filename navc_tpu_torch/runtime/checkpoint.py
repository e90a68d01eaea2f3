"""navc_tpu checkpoints (``.ckpt``): save, load, partial warm start.

Port of navc_tpu/runtime/checkpoint.py (:27-72, :134-181). A ``.ckpt`` is
one pickle of a dict: the flax ``params`` and ``batch_stats`` trees with
numpy leaves, the resolved config as a plain dict under ``settings``, and
whatever else the trainer kept (epoch, scores, optimizer state). Reading it
needs no JAX: numpy and the standard library rebuild everything the port
uses. Any other class in the file (a navc_tpu optimizer state's types) is
read as an opaque stand-in, so the load never imports the package that
defined it. The port writes the same format (``save_checkpoint``): its
model's weights go through ``convert.export_flax_variables``, so navc_tpu's
``load_model_and_config`` reads a port checkpoint; ``opt_state`` holds the
torch optimizer's ``state_dict`` as numpy arrays and builtins, for resume
within the port. The orbax format is not ported.

Unpickling runs code named by the file, so load only checkpoints that this
project's trainer wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..convert import export_flax_variables, load_flax_variables
from ..models import build_model

_READABLE = ("numpy", "builtins", "collections", "copyreg", "_codecs",
             "ml_dtypes")


class OpaqueObject:
    """Stands in for an instance of a class the port does not read."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _READABLE:
            return super().find_class(module, name)
        return OpaqueObject


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, as navc_tpu's ``load_checkpoint`` returns it,
    except that objects of classes outside numpy and the standard library
    are ``OpaqueObject``s."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def load_model_and_config(path: str, device="cuda"
                          ) -> Tuple[Any, Config, Dict[str, Any]]:
    """(model, cfg, other): the port's model built from the checkpoint's
    config on ``device`` and filled with its weights, the config, and the
    checkpoint's other entries (reference utils.py:54-63)."""
    ckpt = load_checkpoint(path)
    cfg = Config.from_dict(ckpt["settings"])
    variables = {"params": ckpt["params"]}
    if ckpt.get("batch_stats"):
        variables["batch_stats"] = ckpt["batch_stats"]
    model = load_flax_variables(build_model(cfg, device=device), variables)
    other = {k: v for k, v in ckpt.items()
             if k not in ("params", "batch_stats", "opt_state")}
    return model, cfg, other


def to_numpy(obj):
    """``obj`` with every tensor as a numpy array (dicts, lists and tuples
    walked): a torch ``state_dict`` becomes numpy and builtins."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def to_torch(obj):
    """The inverse of ``to_numpy``: numpy arrays become CPU tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_torch(v) for v in obj)
    return obj


def save_checkpoint(state: Dict[str, Any], filepath: str,
                    filename: str = "checkpoint.ckpt") -> str:
    """Write ``state`` as a navc_tpu ``.ckpt``: a ``model`` entry becomes
    ``params`` + ``batch_stats`` (``export_flax_variables``), a Config under
    ``settings`` its dict, tensors numpy; the file is replaced atomically
    (a crash mid-write keeps the previous resume state)."""
    os.makedirs(filepath, exist_ok=True)
    path = os.path.join(filepath, filename)
    payload = dict(state)
    model = payload.pop("model", None)
    if model is not None:
        payload.update(export_flax_variables(model))
    if isinstance(payload.get("settings"), Config):
        payload["settings"] = payload["settings"].to_dict()
    payload = to_numpy(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        node = root
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def load_satisfied_weights(model, checkpoint_path: str,
                           str_mapping: Optional[Dict[str, str]] = None,
                           verbose: bool = True):
    """Fill every weight of ``model`` whose (remapped) name and shape the
    checkpoint has, keep the rest (reference utils.py:158-192: the NAR
    student's warm start from the AR teacher). Returns ``model``."""
    str_mapping = str_mapping or {}
    ckpt = load_checkpoint(checkpoint_path)
    src = _flatten({"params": ckpt["params"],
                    "batch_stats": ckpt.get("batch_stats") or {}})
    dst = _flatten(export_flax_variables(model))
    success = 0
    new = {}
    for k, v in dst.items():
        key = k
        for a, b in str_mapping.items():
            if a in key:
                key = key.replace(a, b)
                break
        if key in src and np.shape(src[key]) == np.shape(v):
            new[k] = src[key]
            success += 1
        else:
            new[k] = v
    if verbose:
        print("Successfully loading %d/%d parameters" % (success, len(new)))
    return load_flax_variables(model, _unflatten(new))
