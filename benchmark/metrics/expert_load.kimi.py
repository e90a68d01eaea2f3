"""expert_load.kimi (cell kimi-vl-a3b-msrvtt.beam-512): the program's counter
navc.moe.expert_tokens over the traced window, the tokens routed to each
expert of each MoE layer; the mean over layers of the busiest expert's
tokens over the mean expert's (1 is an even load)."""

from benchmark.lm_readers import expert_load


def read(run):
    return expert_load(run)
