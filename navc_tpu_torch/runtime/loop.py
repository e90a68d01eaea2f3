"""One training epoch (port of navc_tpu/runtime/loop.py ``run_train_epoch``,
reference misc/run.py:249-269).

The lr is set per step from the schedule; the metrics of every step stay on
the device until the epoch ends and are read in one copy, so the host queues
step n + 1 while the card runs step n. ``train_network_all`` (loader,
evaluator, checkpoints) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .logger import AverageMeter
from .optim import LrSchedule, set_learning_rate
from .train_step import TrainState


def run_train_epoch(cfg, train_step, state: TrainState, batches: Iterable[Dict],
                    lr_schedule: LrSchedule, generator: torch.Generator,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
    """Run ``train_step`` over ``batches`` (dicts of numpy arrays); returns
    (state, info) with navc_tpu's info keys: total_loss, lang_loss,
    length_loss, word_acc0/1, perplexity."""
    del cfg  # kept for navc_tpu's signature
    pending = []
    for batch in batches:
        set_learning_rate(state.optimizer, lr_schedule.step_lr())
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        pending.append(train_step(arrays, generator))
        state.step += 1

    meters: Dict[str, AverageMeter] = {}
    if pending:
        keys = sorted(pending[0])
        table = torch.stack([torch.stack([m[k].to(torch.float32) for k in keys])
                             for m in pending]).cpu().tolist()
        for row in table:
            metrics = dict(zip(keys, row))
            n = metrics["num_samples"]
            for name in ("total_loss", "lang_loss", "length_loss"):
                if name in metrics:
                    meters.setdefault(name, AverageMeter()).update(metrics[name], n)
            for j in range(2):
                ck, nk = "word_acc%d_correct" % j, "word_acc%d_count" % j
                if ck in metrics:
                    meters.setdefault("word_acc%d" % j, AverageMeter()).update(
                        metrics[ck], metrics[nk], multiply=False)
            if "ppl_sum" in metrics:
                meters.setdefault("perplexity_ce", AverageMeter()).update(
                    metrics["ppl_sum"], metrics["ppl_count"], multiply=False)

    info = {k: m.avg for k, m in meters.items()}
    if "perplexity_ce" in info:
        info["perplexity"] = float(np.exp(min(info.pop("perplexity_ce"), 50.0)))
    if log is not None:
        log("\t".join("%10s: %05.3f" % (k, v) for k, v in info.items()))
    return state, info
