"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the models' weights and the videos' features.

Weights follow one law, drawn on the device in two calls (one uniform, one
normal draw for every tensor together): a Linear's weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), an embedding N(0, 1) with the PAD row
of the word table zero, norms at identity and BatchNorm's running
statistics at (0, 1) -- torch's default laws, which the program's own
initialisation also takes. They are float32, the type the program holds
its parameters in.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference.model import PAD, param_shapes

# derived seeds: the student's weights take the run's seed itself, the
# teacher's the seed + 1; the features and the schedule their own streams
FEATURE_STREAM, SCHEDULE_STREAM = 2, 3


def _law(name: str) -> str:
    if name.endswith("num_batches_tracked"):
        return "zero"
    if "embeddings" in name:
        return "normal"
    if ".norms." in name or "LayerNorm" in name:
        if name.endswith(("weight", "running_var")):
            return "one"
        return "zero"
    return "uniform"


def make_weights(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of the model entry ``m`` from ``seed``."""
    shapes = param_shapes(m)
    counts = {k: math.prod(s) for k, s in shapes.items()}
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_u = sum(counts[k] for k in shapes if _law(k) == "uniform")
    n_n = sum(counts[k] for k in shapes if _law(k) == "normal")
    uni = torch.rand(n_u, generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=g, device=device)
    sd, iu, inn = {}, 0, 0
    fan_in = {}
    for k, s in shapes.items():
        if k.endswith(".weight") and len(s) == 2:
            fan_in[k[:-len("weight")]] = s[1]
    for k, s in shapes.items():
        law, n = _law(k), counts[k]
        if law == "uniform":
            bound = 1.0 / math.sqrt(fan_in[k.rsplit(".", 1)[0] + "."])
            sd[k] = (uni[iu:iu + n] * bound).view(s)
            iu += n
        elif law == "normal":
            sd[k] = nor[inn:inn + n].view(s)
            inn += n
        elif law == "one":
            sd[k] = torch.ones(s, device=device)
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros(s, dtype=torch.long, device=device)
        else:
            sd[k] = torch.zeros(s, device=device)
    sd["decoder.embedding.word_embeddings.weight"][PAD] = 0.0
    return sd


def make_videos(m: Dict, n: int, seed: int, stream: int, device
                ) -> (List[np.ndarray], np.ndarray):
    """``n`` videos' features, float32 (n, n_frames, dim) per modality, as
    standard normals (bench.py's features), and their categories (n, 1)
    int32, drawn on the device from (seed, stream) and brought to the host,
    where a request's features come from."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 8 + stream)
    feats = [torch.randn((n, m["n_frames"], d), generator=g, device=device).cpu().numpy()
             for d in m["modality_dims"]]
    cat = torch.randint(0, m["num_category"], (n, 1), generator=g, device=device)
    return feats, cat.to(torch.int32).cpu().numpy()
