"""The comparison that decides ``correct`` for a serving cell.

Every answer to a video the traffic names for the check (``check_rows``)
is held against the reference's caption of that video: the plain float32
decode of ``reference/``, run once the window has closed on the same
weights and features, at the configuration's stated precision (bfloat16
products at the rounding points the program documents, see
reference/model.py). Two numbers are compared, each with its limit from
the cell's file:

  caption_mismatch  the share of those answers whose tokens differ from the
                    reference's anywhere;
  unanswered        requests of the window that never came back, or came
                    back with another shape than (videos, caption length).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import decode as reference


def models(config: Dict) -> Dict:
    m = {"student": config["student"]["model"]}
    if "teacher" in config:
        m["teacher"] = config["teacher"]["model"]
    return m


def stated_precision(config: Dict) -> str:
    """The reference's arithmetic: the configuration's compute type."""
    return {"bfloat16": "bf16", "float32": "fp32"}[config["student"]["model"]["compute_dtype"]]


def reference_captions(config: Dict, weights: Dict, feats: List[np.ndarray], cat: np.ndarray,
                       rows: np.ndarray, device, precision: str = "") -> np.ndarray:
    """The reference's captions of ``rows`` of a pool, in ``precision``
    (the configuration's own by default)."""
    f = [torch.as_tensor(x[rows]).to(device) for x in feats]
    c = torch.as_tensor(cat[rows]).to(device)
    return reference.captions(config["decode"], weights, models(config), f, c,
                              precision or stated_precision(config)).cpu().numpy()


def caption_len(config: Dict) -> int:
    m = config["student"]["model"]
    return m["max_len"] if config["decode"] == "nacf" else m["max_len"] - 1


def mismatch(client, reqs, refs: Dict[int, np.ndarray]) -> Tuple[int, int]:
    """(answers compared, answers that differ) against ``refs`` {pool:
    captions of its check rows}."""
    compared = differ = 0
    for pool, ref in refs.items():
        where = np.full(client.pools[pool][1].shape[0], -1)
        where[client.check_rows(pool)] = np.arange(ref.shape[0])
        for req in reqs:
            if req.pool != pool or req.hyp is None:
                continue
            idx = where[req.rows]
            keep = idx >= 0
            got = np.asarray(req.hyp)[keep]
            compared += int(keep.sum())
            differ += int((got != ref[idx[keep]]).any(1).sum())
    return compared, differ


def serving_checks(config: Dict, weights: Dict, client, reqs, device,
                   limits: Dict[str, float]) -> Tuple[Dict, int, Dict]:
    """({name: {"value", "limit"}}, requests failed, the reference's
    captions {pool: captions of its check rows})."""
    width = caption_len(config)
    failed = 0
    for r in reqs:
        if r.hyp is None or np.asarray(r.hyp).shape != (r.videos, width):
            r.hyp = None
            failed += 1
    refs = {pool: reference_captions(config, weights, feats, cat, client.check_rows(pool), device)
            for pool, (feats, cat) in enumerate(client.pools)}
    compared, differ = mismatch(client, reqs, refs)
    share = differ / compared if compared else 1.0
    return ({"caption_mismatch": {"value": share, "limit": limits["caption_mismatch"]},
             "unanswered": {"value": failed, "limit": 0}}, failed, refs)
