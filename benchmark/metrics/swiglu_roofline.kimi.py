"""swiglu_roofline.kimi (cell kimi-vl-a3b-msrvtt.beam-512): K13, SwiGLU's
activation of every MLP (lm_costs.activation_bytes: each gate/up product
read and its activation written once, at HBM's 3.35 TB/s) over K13's device
time in the traced window, in %."""

from benchmark.lm_readers import swiglu_roofline


def read(run):
    return swiglu_roofline(run)
