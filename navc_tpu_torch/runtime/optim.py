"""Optimizer and learning-rate schedule (reference misc/optim.py).

Port of navc_tpu/runtime/optim.py, whose optax chain is
``clip(grad_clip) -> add_decayed_weights(weight_decay) -> adam | rmsprop ->
scale(-lr)``. Here: ``torch.nn.utils.clip_grad_value_`` on the raw
gradients, then ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8,
weight_decay=...)`` or ``torch.optim.RMSprop(alpha=0.99, eps=1e-8,
weight_decay=...)`` — torch's ``weight_decay`` adds ``wd * p`` to the
gradient before the moments, as ``add_decayed_weights`` does, and
RMSprop's eps sits outside the square root, as navc_tpu configures
optax's. optax updates every parameter, a zero gradient included, while
torch skips a parameter whose ``.grad`` is None: ``step`` gives each such
parameter a zero gradient first.

``LrSchedule`` mirrors ScheduledOptim's bookkeeping on the host: linear
warmup per step, decay per epoch; ``set_learning_rate`` writes the lr into
the optimizer's parameter groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    params = list(params)
    name = cfg.optim.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=cfg.learning_rate, alpha=0.99,
                                   eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError("optim must be adam or rmsprop, got %r" % cfg.optim)


def step(cfg: Config, opt: torch.optim.Optimizer) -> None:
    """Clip by value, give every gradient-less parameter a zero gradient,
    and take the optimizer step (reference run.py:260-262)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_value_(params, cfg.grad_clip)
    opt.step()


@dataclass
class LrSchedule:
    """Host-side mirror of reference ScheduledOptim lr bookkeeping."""

    learning_rate: float
    minimum_learning_rate: float
    decay: float
    n_warmup_steps: int = 0
    n_current_steps: int = 0

    @classmethod
    def from_config(cls, cfg: Config) -> "LrSchedule":
        return cls(learning_rate=cfg.learning_rate,
                   minimum_learning_rate=cfg.minimum_learning_rate,
                   decay=cfg.decay, n_warmup_steps=cfg.n_warmup_steps)

    def step_lr(self) -> float:
        """lr for the next optimizer step (reference optim.py:36-46)."""
        self.n_current_steps += 1
        ratio = min(self.n_current_steps / (self.n_warmup_steps + 1.0), 1.0)
        return self.learning_rate * ratio

    def epoch_update(self) -> None:
        """Per-epoch decay (reference optim.py:32-34)."""
        if self.n_current_steps > self.n_warmup_steps:
            self.learning_rate = max(self.minimum_learning_rate,
                                     self.decay * self.learning_rate)

    def get_lr(self) -> float:
        return self.learning_rate


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
