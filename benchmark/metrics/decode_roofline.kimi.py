"""decode_roofline.kimi (cell kimi-vl-a3b-msrvtt.beam-512): the least time of
the decodes' work (lm_costs.py: the prefill and every step, each bounded by
its operations at the bf16 peak or its bytes at HBM's) over their device
spans, in %."""

from benchmark.lm_readers import decode_roofline


def read(run):
    return decode_roofline(run)
