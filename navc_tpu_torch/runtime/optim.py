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

The lr is a float32 0-d tensor on the parameters' device, one per
parameter group for the optimizer's life: ``set_learning_rate`` fills it in
place, so a training step captured as a CUDA graph (``train_step``) reads
each step's lr where it lies. On the card the optimizer is also
``capturable`` (its step counts are tensors on the card, and its update
never reads a value back to the host); on the CPU it is not. Either way
torch takes the step size in float32 from the lr tensor (from a float lr
it would take it in double). ``load_state_dict`` keeps the lr tensor (its
value becomes the loaded lr, a tensor's or a float's) and the step counts
where this optimizer needs them. The eager step on the card takes the same
optimizer, so both routes do the same arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Adam or RMSprop over ``params``, its lr a float32 0-d tensor on their
    device; ``capturable`` on the card."""
    params = list(params)
    dev = params[0].device
    capturable = dev.type == "cuda"
    lr = torch.full((), cfg.learning_rate, dtype=torch.float32, device=dev)
    name = cfg.optim.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=cfg.weight_decay, capturable=capturable)
    elif name == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                  weight_decay=cfg.weight_decay, capturable=capturable)
    else:
        raise ValueError("optim must be adam or rmsprop, got %r" % cfg.optim)
    lrs = [group["lr"] for group in opt.param_groups]
    opt.register_load_state_dict_post_hook(lambda o: _keep_state_policy(o, lrs, capturable))
    return opt


def _keep_state_policy(opt: torch.optim.Optimizer, lrs, capturable: bool) -> None:
    """After ``load_state_dict``, whatever optimizer saved the state (on the
    card or not, its lr a tensor or a float): each group's lr tensor is put
    back in place, filled with the loaded value; the groups keep this
    optimizer's ``capturable``, and every step count lies where it then must
    (a float32 on its parameter's device when capturable, else on the
    CPU)."""
    for group, lr in zip(opt.param_groups, lrs):
        loaded = group["lr"]
        if loaded is not lr:
            lr.fill_(float(loaded))
            group["lr"] = lr
        group["capturable"] = capturable
        for p in group["params"]:
            st = opt.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(device=p.device if capturable else "cpu",
                                           dtype=torch.float32)


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
    """``lr`` into every parameter group's lr tensor, filled in place (a
    fill queued on the card, no copy from the host), never rebound."""
    for group in opt.param_groups:
        group["lr"].fill_(lr)
