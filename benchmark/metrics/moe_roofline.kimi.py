"""moe_roofline.kimi (cell kimi-vl-a3b-msrvtt.beam-512): the routed experts'
products (lm_costs.routed_call: each MoE layer call's FLOPs at the bf16
peak or its bytes at HBM's, the touched experts' weights read once) over
the device time of the grouped launches (torch._grouped_mm's kernels, by
name) in the traced window, in %."""

from benchmark.lm_readers import moe_roofline


def read(run):
    return moe_roofline(run)
