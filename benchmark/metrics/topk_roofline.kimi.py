"""topk_roofline.kimi (cell kimi-vl-a3b-msrvtt.beam-512): K5 at D 2048 and
V 163,840, its streamed walk and merge (lm_costs.topk_step: every beam row's
logits' products at the bf16 peak, or the head and rows read once at HBM's)
over K5's device time in the traced window, in %."""

from benchmark.lm_readers import topk_roofline


def read(run):
    return topk_roofline(run)
