"""Read a navc_tpu checkpoint (``.ckpt``) into the port.

Port of the loading half of navc_tpu/runtime/checkpoint.py (:51-72). A
``.ckpt`` is one pickle of a dict: the flax ``params`` and ``batch_stats``
trees with numpy leaves, the resolved config as a plain dict under
``settings``, and whatever else the trainer kept (epoch, scores, optimizer
state). Reading it needs no JAX: numpy and the standard library rebuild
everything the port uses. Any other class in the file (an optimizer state's
types) is read as an opaque stand-in, so the load never imports the
package that defined it. Saving and the orbax format are not ported.

Unpickling runs code named by the file, so load only checkpoints that this
project's trainer wrote.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

from ..config import Config
from ..convert import load_flax_variables
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
