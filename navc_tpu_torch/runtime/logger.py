"""CSV/text logging, running averages, and k-best model selection.

Port of navc_tpu/runtime/logger.py (reference misc/logger.py):
  * CsvLogger writes fieldsnamed CSV rows + append-only log.txt
    (logger.py:10-48),
  * AverageMeter (logger.py:51-70),
  * KBestQueue replicates k_PriorityQueue's relative-to-best 'Sum' scoring
    (logger.py:94-104), best-model copying, and early-stop tolerance counting
    (logger.py:118-196).
"""

from __future__ import annotations

import csv
import heapq
import os
from typing import Dict, List, Optional, Tuple


class CsvLogger:
    def __init__(self, filepath: str = "./", filename: str = "validate_record.csv",
                 fieldsnames: Optional[List[str]] = None):
        self.log_path = filepath
        os.makedirs(filepath, exist_ok=True)
        self.fieldsnames = fieldsnames or [
            "epoch", "train_loss", "val_loss", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]
        self.csv_path = os.path.join(filepath, filename)
        if not os.path.exists(self.csv_path):
            with open(self.csv_path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.fieldsnames).writeheader()
        self.data: Dict[str, list] = {k: [] for k in self.fieldsnames}

    def write(self, data: Dict) -> None:
        row = {k: v for k, v in data.items() if k in self.data}
        for k in self.data:
            self.data[k].append(data.get(k))
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldsnames).writerow(row)

    def write_text(self, text: str, print_t: bool = True) -> None:
        with open(os.path.join(self.log_path, "log.txt"), "a") as f:
            f.write("%s\n" % text)
        if print_t:
            print(text)


class AverageMeter:
    """Reference logger.py:51-70."""

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


class KBestQueue:
    """k-best checkpoint selection with relative 'Sum' scoring.

    Reference k_PriorityQueue (logger.py:81-211). ``check(res, ...)`` mutates
    ``res['Sum']`` exactly like the reference ``score`` method: each metric is
    divided by the best value of that metric seen so far, averaged over the
    ``standard`` metrics.
    """

    def __init__(self, k_best_model: int = 1, folder_path: str = "",
                 standard: Optional[List[str]] = None):
        self.k_best_model = k_best_model
        self.folder_path = folder_path
        self.standard = standard or ["METEOR", "CIDEr"]
        self.heap: List[Tuple[float, int, Dict, str]] = []  # (Sum, seq, res, path)
        self._seq = 0
        self.continuous_failed_count = 0
        self.best_res: Dict = {"Sum": 0, "Bleu_4": 0, "METEOR": 0, "ROUGE_L": 0, "CIDEr": 0}
        self.best_ = {k: 0.0 for k in self.standard}
        if self.k_best_model > 1 and folder_path:
            os.makedirs(folder_path, exist_ok=True)

    def score(self, res: Dict) -> None:
        out = 0.0
        for k in self.best_:
            if res.get(k, 0) > self.best_[k]:
                self.best_[k] = res[k]
            out += res.get(k, 0) / self.best_[k] if self.best_[k] else 0.0
        res["Sum"] = out / len(self.best_)

    def _rescore_all(self) -> None:
        self.score(self.best_res)
        rescored = []
        for _, seq, res, path in self.heap:
            self.score(res)
            rescored.append((res["Sum"], seq, res, path))
        heapq.heapify(rescored)
        self.heap = rescored

    def check(self, res: Dict, checkpoint_path: str, tolerence: int,
              save_fn=None) -> Tuple[bool, str]:
        """Returns (keep_training, info string). ``save_fn(dst)`` persists the
        current checkpoint to dst when this epoch enters the top-k."""
        self.score(res)
        self._rescore_all()

        if self.k_best_model == 1:
            dst = os.path.join(checkpoint_path, "best.ckpt")
        else:
            dst = os.path.join(self.folder_path, "model_%04d.ckpt" % res.get("epoch", 0))

        if len(self.heap) == self.k_best_model:
            worst = heapq.heappop(self.heap)
            if res["Sum"] > worst[0]:
                self.continuous_failed_count = 0
                heapq.heappush(self.heap, (res["Sum"], self._next_seq(), res, dst))
                if save_fn is not None:
                    save_fn(dst)
                if self.k_best_model > 1 and os.path.exists(worst[3]):
                    os.remove(worst[3])
            else:
                heapq.heappush(self.heap, worst)
                self.continuous_failed_count += 1
                if self.continuous_failed_count >= tolerence:
                    return False, str(self.continuous_failed_count)
        else:
            heapq.heappush(self.heap, (res["Sum"], self._next_seq(), res, dst))
            if save_fn is not None:
                save_fn(dst)

        info = self._print_info(res)
        if res["Sum"] > self.best_res.get("Sum", 0):
            self.best_res = res
        return True, info

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def state_dict(self) -> Dict:
        """Serializable selection state, so mid-training resume does not
        reset the relative-Sum normalizers / early-stop counter — a reset
        queue would score the first post-resume epoch Sum=1.0 and clobber
        best.ckpt with a possibly-worse model."""
        return {
            "heap": [list(e) for e in self.heap],
            "seq": self._seq,
            "continuous_failed_count": self.continuous_failed_count,
            "best_res": dict(self.best_res),
            "best_": dict(self.best_),
        }

    def load_state_dict(self, state: Dict) -> None:
        self.heap = [tuple(e) for e in state.get("heap", [])]
        heapq.heapify(self.heap)
        self._seq = int(state.get("seq", 0))
        self.continuous_failed_count = int(
            state.get("continuous_failed_count", 0))
        self.best_res = dict(state.get("best_res", self.best_res))
        best = state.get("best_")
        if best:
            self.best_ = {k: float(v) for k, v in best.items()}

    def best_entry_path(self) -> Optional[str]:
        """Checkpoint path of the highest-Sum entry (k>1 selection)."""
        if not self.heap:
            return None
        return max(self.heap, key=lambda e: e[0])[3]

    def _print_info(self, res: Dict) -> str:
        return ("{:2d}, {:6.2f} {} {:6.2f}\tB {:5.2f}({:5.2f})\tM {:5.2f}({:5.2f})"
                "\tR {:5.2f}({:5.2f})\tC {:5.2f}({:5.2f})").format(
            self.continuous_failed_count, 100 * res["Sum"],
            res["Sum"] > self.best_res.get("Sum", 0), 100 * self.best_res.get("Sum", 0),
            100 * res.get("Bleu_4", 0), 100 * (res.get("Bleu_4", 0) - self.best_res.get("Bleu_4", 0)),
            100 * res.get("METEOR", 0), 100 * (res.get("METEOR", 0) - self.best_res.get("METEOR", 0)),
            100 * res.get("ROUGE_L", 0), 100 * (res.get("ROUGE_L", 0) - self.best_res.get("ROUGE_L", 0)),
            100 * res.get("CIDEr", 0), 100 * (res.get("CIDEr", 0) - self.best_res.get("CIDEr", 0)))
