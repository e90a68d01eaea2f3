"""Scalar summaries (port of navc_tpu/runtime/summary.py's SummaryWriter).

Capability parity with the reference's tensorboardX usage (misc/run.py:282,
misc/crit.py:193-196, misc/optim.py:42-43): scalars are appended to a JSONL
events file that any dashboard can tail; if tensorboardX happens to be
installed the same scalars are mirrored to it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class SummaryWriter:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.jsonl")
        self._tb = None
        try:  # optional mirror
            from tensorboardX import SummaryWriter as TB
            self._tb = TB(logdir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(global_step),
                                "wall_time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def add_scalars(self, scalars: Dict[str, float], global_step: int = 0) -> None:
        for k, v in scalars.items():
            self.add_scalar(k, v, global_step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
