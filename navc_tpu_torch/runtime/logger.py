"""Running averages (port of navc_tpu/runtime/logger.py's AverageMeter,
reference misc/logger.py:51-70)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1, multiply=True):
        self.val = val
        self.sum += val * n if multiply else val
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
