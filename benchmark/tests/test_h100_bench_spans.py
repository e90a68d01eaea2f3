"""The readers of the metrics that read the program's own record
(benchmark/spans.py): a synthetic record gives each its value; an untraced
run, an empty record and a program that keeps none give None."""

import pytest

import bench_tiny  # noqa: F401  (puts the repository root on sys.path)
from benchmark import harness
from benchmark.harness import Run
from benchmark.trace import Trace
from navc_tpu_torch.runtime import summary

RECORD = {
    "spans": {"navc.submit": {"count": 4, "total_s": 0.4, "self_s": 0.1},
              "navc.stage": {"count": 4, "total_s": 0.2, "self_s": 0.05},
              "navc.decode.flag_wait": {"count": 24, "total_s": 0.12, "self_s": 0.12}},
    "counters": {"navc.request_gap_s": {"count": 3, "total": 0.15},
                 "navc.inflight_at_result": {"count": 4, "total": 1.0}}}
# metric: its value from RECORD (ms a request, ms a gap, requests a result)
WANT = {"stage_host_ms.nacf": 50.0, "stage_host_ms.arb": 50.0,
        "request_gap_ms.nacf": 50.0, "request_gap_ms.arb": 50.0,
        "inflight_at_result.nacf": 0.25, "inflight_at_result.arb": 0.25,
        "flag_wait_ms.arb": 30.0}


def _run(traced=True):
    run = Run(cell="arb-msrvtt.batch-1024", workload={}, config={}, seed=1, seconds=1,
              traced=traced)
    if traced:
        run.trace = Trace(window_s=1.0, busy_s=0.5, kernels={}, htod_s=0.0)
    return run


def test_every_new_metric_is_in_the_spec_with_its_cell():
    spec = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in WANT:
        cell = "%s-msrvtt.batch-%s" % (("nacf", "8192") if name.endswith(".nacf")
                                       else ("arb", "1024"))
        assert spec[name]["workloads"] == [cell], name


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_synthetic_record_gives_the_metric(name, monkeypatch):
    monkeypatch.setattr(summary, "record", lambda: RECORD)
    assert harness.reader(name)(_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("case", ["untraced", "empty", "no_record"])
def test_nothing_recorded_gives_none(case, monkeypatch):
    if case == "empty":
        monkeypatch.setattr(summary, "record", lambda: {"spans": {}, "counters": {}})
    elif case == "no_record":  # a program that keeps no record
        monkeypatch.delattr(summary, "record")
    else:
        monkeypatch.setattr(summary, "record", lambda: RECORD)
    for name in WANT:
        assert harness.reader(name)(_run(traced=case != "untraced")) is None, name


def test_a_request_without_flag_waits_gives_none(monkeypatch):
    rec = {"spans": {k: v for k, v in RECORD["spans"].items()
                     if k != "navc.decode.flag_wait"}, "counters": {}}
    monkeypatch.setattr(summary, "record", lambda: rec)
    assert harness.reader("flag_wait_ms.arb")(_run()) is None
    assert harness.reader("stage_host_ms.arb")(_run()) == pytest.approx(50.0)
