"""The system under test: navc_tpu_torch's models and its StreamingCaptioner,
built from a configuration file and the benchmark's weights.

This is the only module of the benchmark that imports the program. The
models are made empty (on the meta device) and take the benchmark's state
dicts, as a checkpoint would fill them; the configuration the program
resolves is held against the file's "model" entry first, so that the file
says what runs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def resolve(entry: Dict):
    """The program's Config for a configuration file's model entry
    ({"method", "dataset", "overrides", "model"}); raises where the program
    resolves another size than the entry states."""
    from navc_tpu_torch.config import default_config

    cfg = default_config(entry["method"], dataset=entry["dataset"], **entry["overrides"])
    got = {"modality": cfg.modality, "modality_dims": list(cfg.modality_dims),
           "n_frames": cfg.n_frames, "dim_hidden": cfg.dim_hidden,
           "num_attention_heads": cfg.num_attention_heads,
           "intermediate_size": cfg.intermediate_size, "max_len": cfg.max_len,
           "vocab_size": cfg.vocab_size, "with_category": cfg.with_category,
           "num_category": cfg.num_category, "layer_norm_eps": cfg.layer_norm_eps,
           "length_head": "length" in cfg.crit, "decoding_type": cfg.decoding_type,
           "num_hidden_layers_decoder": cfg.num_hidden_layers_decoder,
           "hidden_act": cfg.hidden_act, "enhance_input": cfg.enhance_input,
           "compute_dtype": cfg.compute_dtype, "length_beam_size": cfg.length_beam_size,
           "iterations": cfg.iterations, "use_ct": cfg.use_ct,
           "length_bias": cfg.length_bias, "beam_alpha": cfg.beam_alpha,
           "beam_size": cfg.beam_size, "paradigm": cfg.paradigm,
           "masking_decision": cfg.masking_decision,
           "no_candidate_decision": cfg.no_candidate_decision}
    bad = {k: (v, got.get(k)) for k, v in entry["model"].items() if got.get(k) != v}
    if bad:
        raise ValueError("the program resolves %s otherwise than the configuration file "
                         "states: {key: (file, program)} %s" % (entry["method"], bad))
    return cfg


def build(cfg, weights: Dict[str, torch.Tensor], device):
    """The program's Seq2Seq for ``cfg`` holding ``weights``, for inference
    (made on the device, its own initial draws overwritten)."""
    from navc_tpu_torch.models.seq2seq import Seq2Seq

    with torch.device(device):
        model = Seq2Seq(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval().requires_grad_(False)


def captioner(config: Dict, weights: Dict, device, depth: int):
    """StreamingCaptioner over the configuration's model (and its teacher)."""
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    cfg = resolve(config["student"])
    model = build(cfg, weights["student"], device)
    teacher: Optional[tuple] = None
    if "teacher" in config:
        tcfg = resolve(config["teacher"])
        teacher = (tcfg, build(tcfg, weights["teacher"], device))
    return StreamingCaptioner(cfg, model, teacher, depth=depth, device=device)


def build_kernels() -> None:
    """Compile every kernel source that has no library in the checkout yet
    (the first run of a checkout), all at once."""
    from navc_tpu_torch.ops import _build

    _build.build()


def graph_capture_s(cap) -> float:
    """Seconds the captioner's CUDA graph captures took (``Graph.capture_s``,
    summed over its encodes' and its decode's graphs)."""
    total = 0.0
    for fn in (cap._encode, cap._teacher_encode, cap.generate):
        for entry in getattr(fn, "graphs", {}).values():
            parts = entry.parts() if hasattr(entry, "parts") else [entry.graph]
            total += sum(g.capture_s for g in parts)
    return total
