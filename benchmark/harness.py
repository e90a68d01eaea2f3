"""The benchmark's plumbing: files found by name, the run's record, the
metrics a cell reports, the check on loaded modules and the result line.

Everything that belongs to one configuration, traffic kind, cell or metric
lives in a file of its own, found by the name BENCHMARK.json gives it:

    benchmark/configs/<config>.json    a configuration: sizes, source, cuts
    benchmark/workloads/<cell>.json    a cell: its traffic and its limits
    benchmark/traffic/<kind>.py        the generator of one traffic kind
    benchmark/metrics/<metric>.py      the reader of one metric: read(run)
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "navc_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> Dict:
    return load_json(os.path.join(BENCH, "workloads", name + ".json"))


def config(name: str) -> Dict:
    return load_json(os.path.join(BENCH, "configs", name + ".json"))


def _module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(os.path.join(BENCH, "traffic", kind + ".py"), "bench_traffic_" + kind)


def reader(metric: str):
    """``read(run) -> number or None`` of a metric, from its own file."""
    return _module(os.path.join(BENCH, "metrics", metric + ".py"),
                   "bench_metric_" + metric.replace(".", "_")).read


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on): those whose ``workloads`` name it, or that name no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (navc_tpu_torch is not navc_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def use_checkout_caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout: only a
    checkout's first run builds. (The program builds its kernels into
    navc_tpu_torch/build/ of the checkout by itself.)"""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


@dataclass
class Request:
    """One request of the window: which videos (rows of one of the
    traffic's pools), when it was due, sent and answered (host seconds from
    the window's start), and the hypotheses that came back."""
    pool: int
    rows: Any                      # np.ndarray of pool rows
    due: float
    sent: float = float("nan")
    done: float = float("nan")
    hyp: Any = None
    decode_s: float = float("nan")  # device span of its decode (traced runs)
    dispatch_s: float = float("nan")  # host time staging and dispatching it

    @property
    def videos(self) -> int:
        return len(self.rows)


@dataclass
class Run:
    """What one run recorded, for the metrics' readers."""
    cell: str
    workload: Dict
    config: Dict
    seed: int
    seconds: int
    traced: bool
    setup_s: float = float("nan")
    window_s: float = float("nan")
    requests: List[Request] = field(default_factory=list)
    capture_s: float = float("nan")
    trace: Optional[Any] = None    # trace.Trace in a traced run
    extra: Dict[str, Any] = field(default_factory=dict)


def result_line(run: Run, metrics: List[Dict], correct: bool, attempted: int,
                failed: int, device: Dict, checks: Dict[str, Dict]) -> Dict:
    """The contract's last line; a metric whose reader finds nothing to read
    is left out."""
    values = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": values, "device": device}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["check"] = checks
    return line
