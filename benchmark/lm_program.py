"""The system under test for the MLAMoE language-model cells: navc_tpu_torch's
CaptionLM and its StreamingCaptioner, built from a configuration file and
the benchmark's weights.

Beside ``program.py``, the only module of these cells that imports the
program. ``require()`` imports the program's entry points for this model
first, so that a checkout without them fails within seconds, before a
weight is drawn.
"""

from __future__ import annotations

from typing import Dict


def require() -> None:
    """Raises ImportError where the program has no MLAMoE decoder."""
    from navc_tpu_torch.config import lm_overrides  # noqa: F401
    from navc_tpu_torch.decoding.lm_beam import make_lm_generator  # noqa: F401
    from navc_tpu_torch.models.mla_moe import CaptionLM  # noqa: F401


def build_kernels() -> None:
    """Compile the kernel libraries this model runs (K5's and K13's),
    together, where the checkout has none yet."""
    from navc_tpu_torch.ops import _build

    _build.build(["vocab_fused", "swiglu"])


def resolve(config: Dict, **extra):
    """The program's Config for the configuration file: its method and
    dataset preset, the published keys through ``lm_overrides``, the
    encoder's inputs, the port's kernels on (as the other cells run them;
    ``extra`` overrides any field) and the beam; raises where the program resolves
    another beam or length than the file states."""
    from navc_tpu_torch.config import default_config, lm_overrides

    dims = config["modality_dims"]
    fields = dict(modality=config["modality"], n_frames=config["n_frames"],
                  dim_i=dims[config["modality"].index("i")],
                  dim_m=dims[config["modality"].index("m")],
                  compute_dtype=config["dtype"], use_pallas=True, **lm_overrides(config))
    cfg = default_config(config["method"], dataset=config["dataset"], **dict(fields, **extra))
    got = dict(beam_size=cfg.beam_size, beam_alpha=cfg.beam_alpha, max_len=cfg.max_len)
    want = {k: config[k] for k in got}
    if got != want:
        raise ValueError("the program resolves %s, the file states %s" % (got, want))
    return cfg


def build(cfg, device):
    """The program's CaptionLM for inference on ``device``, its language
    model's weights not yet drawn (``lm_inputs.make_weights(..., out=
    model.state_dict())`` fills them in place: one copy)."""
    from navc_tpu_torch.models.mla_moe import CaptionLM

    return CaptionLM(cfg, device).eval().requires_grad_(False)


def captioner(cfg, model, device, depth: int):
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    return StreamingCaptioner(cfg, model, depth=depth, device=device)


def graph_capture_s(cap) -> float:
    """Seconds the captioner's CUDA graph captures took: the encode's, the
    prefill's and the step loop's."""
    from benchmark.program import graph_capture_s as loop_and_encode

    total = loop_and_encode(cap)
    prefill = getattr(cap.generate, "prefill_graphs", {})
    return total + sum(entry.graph.capture_s for entry in prefill.values())


def expert_tokens() -> list:
    """The record's ``navc.moe.expert_tokens`` total (MoE layers x experts),
    or None."""
    from navc_tpu_torch.runtime import summary

    c = summary.record()["counters"].get("navc.moe.expert_tokens")
    return None if not c or not c["count"] else c["total"]
