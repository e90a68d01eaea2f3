"""The serving path's spans and the record they keep (``runtime/summary.py``),
on the CPU.

  * with no profile recording, a StreamingCaptioner's submit and flush leave
    the record empty, and ``span`` hands out one shared no-op context;
  * under ``torch.profiler.profile`` a tiny NACF captioner (with its ARB
    teacher) and a tiny ARB captioner record ``navc.submit``, ``navc.stage``,
    ``navc.encode``, ``navc.decode``, ``navc.result`` (and NACF's
    ``navc.teacher_encode``) once a request; among the profiler's own
    events each range carries its request's ticket and lies inside that
    request's ``navc.submit`` (a result read by ``flush`` inside
    ``navc.flush``);
  * a span's self time is its total less its child spans', on known clock
    readings;
  * ``trace(logdir)`` clears the record and writes it beside the trace;
  * ``submit`` reaches the card through the ``_dispatch`` and ``generate``
    attributes, which a caller may wrap;
  * at depths 0-3 a NACF and an ARB captioner hand back depth 0's tickets
    and hypotheses in submission order, each request's once ``depth`` newer
    ones are queued.

The request marks and the in-flight count, which need CUDA events, are
tested on the card (tests/test_torch_port_cuda.py, ``-k request_marks``).

Run: ``python -m pytest tests/test_torch_port_spans.py -q``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from navc_tpu_torch.config import default_config
from navc_tpu_torch.models import build_model
from navc_tpu_torch.runtime import summary
from navc_tpu_torch.runtime.serving import StreamingCaptioner

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2, intermediate_size=32,
           n_frames=4, dim_i=12, dim_m=10, modality="mi", max_len=10)
REQUEST_SPANS = ("navc.stage", "navc.encode", "navc.decode")


def _model(method, seed):
    cfg = default_config(method, dataset="MSRVTT", **TOY)
    return cfg, build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _captioner(method, depth=2):
    cfg, model = _model(method, 0)
    teacher = _model("ARB", 1) if method == "NACF" else None
    return StreamingCaptioner(cfg, model, teacher, depth=depth, device="cpu")


def _requests(cap, n, videos=3, seed=7):
    rng = np.random.RandomState(seed)
    cfg = cap.cfg
    return [([rng.randn(videos, cfg.n_frames, d).astype(np.float32) for d in cfg.modality_dims],
             rng.randint(0, cfg.num_category, (videos, 1)).astype(np.int64))
            for _ in range(n)]


def _serve(cap, reqs):
    done = []
    for feats, cat in reqs:
        done += cap.submit(feats, cat)[1]
    return done + cap.flush()


@pytest.fixture
def clean_record():
    summary.clear_record()
    yield
    summary.clear_record()


def test_no_profile_leaves_the_record_empty(clean_record):
    cap = _captioner("NACF")
    done = _serve(cap, _requests(cap, 3))
    assert [t for t, _ in done] == [0, 1, 2]
    assert summary.record() == {"spans": {}, "counters": {}}
    assert not summary.recording()
    assert summary.span("navc.submit", 4) is summary.span("navc.stage")


@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_request_spans_under_a_profile(method, clean_record):
    cap = _captioner(method)
    reqs = _requests(cap, 4)
    _serve(cap, reqs[:1])  # first use outside the profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        done = _serve(cap, reqs)
    n = len(reqs)
    tickets = [t for t, _ in done]
    assert tickets == list(range(1, n + 1))
    per_request = ("navc.submit", "navc.result") + REQUEST_SPANS + (
        ("navc.teacher_encode",) if method == "NACF" else ())
    spans = summary.record()["spans"]
    for name in per_request:
        assert spans[name]["count"] == n, name
        assert 0 <= spans[name]["self_s"] <= spans[name]["total_s"], name
    assert spans["navc.flush"]["count"] == 1
    assert summary.record()["counters"] == {}  # the request marks need the card

    events = [e for e in prof.events() if e.name.startswith("navc.")]

    def root(e):
        while e.cpu_parent is not None and not e.cpu_parent.name.startswith(
                ("navc.submit", "navc.flush")):
            e = e.cpu_parent
        return e.cpu_parent

    for name in per_request:
        got = sorted(e.kwinputs["request"] for e in events if e.name == name)
        assert got == tickets, name
    for e in events:
        if e.name in per_request[2:]:
            top = root(e)
            assert top.name == "navc.submit", e.name
            assert top.kwinputs["request"] == e.kwinputs["request"], e.name
        elif e.name == "navc.result":
            # results forced out by submit lie in a later request's submit
            top = root(e)
            assert top.name in ("navc.submit", "navc.flush")
            if top.name == "navc.submit":
                assert top.kwinputs["request"] == e.kwinputs["request"] + cap.depth
    in_flush = [e.kwinputs["request"] for e in events
                if e.name == "navc.result" and root(e).name == "navc.flush"]
    assert in_flush == tickets[-cap.depth:]


def test_self_time_is_total_less_children(monkeypatch, clean_record):
    """a(0-20) holds b(1-10), which holds c(3-6), and d(11-15); a second
    c(16-18) inside a."""
    ticks = iter([0.0, 1.0, 3.0, 6.0, 10.0, 11.0, 15.0, 16.0, 18.0, 20.0])
    monkeypatch.setattr(summary, "_clock", lambda: next(ticks))
    with profile(activities=[ProfilerActivity.CPU]):
        with summary.span("a", 5):
            with summary.span("b"):
                with summary.span("c"):
                    pass
            with summary.span("d"):
                pass
            with summary.span("c"):
                pass
        summary.count("gap_s", 0.25)
        summary.count("inflight", 3, n=2)
    spans = summary.record()["spans"]
    want = {"a": (1, 20.0, 20.0 - 9.0 - 4.0 - 2.0), "b": (1, 9.0, 6.0), "c": (2, 5.0, 5.0),
            "d": (1, 4.0, 4.0)}
    assert {k: (v["count"], v["total_s"], v["self_s"]) for k, v in spans.items()} == want
    assert summary.record()["counters"] == {"gap_s": {"count": 1, "total": 0.25},
                                            "inflight": {"count": 2, "total": 3.0}}


def test_trace_clears_the_record_and_writes_it_beside_the_trace(tmp_path, clean_record):
    with profile(activities=[ProfilerActivity.CPU]):
        with summary.span("navc.stale"):
            pass
    assert "navc.stale" in summary.record()["spans"]
    cap = _captioner("ARB", depth=1)
    reqs = _requests(cap, 2)
    logdir = str(tmp_path / "trace")
    with summary.trace(logdir):
        _serve(cap, reqs)
    (trace_file,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(trace_file[:-len(".pt.trace.json")] + ".navc.json") as f:
        written = json.load(f)
    assert written == summary.record()
    assert "navc.stale" not in written["spans"]
    assert written["spans"]["navc.submit"]["count"] == 2
    with open(trace_file) as f:
        ranges = [e for e in json.load(f)["traceEvents"] if e.get("name") == "navc.submit"]
    assert sorted(e["args"]["request"] for e in ranges) == [0, 1]


def test_submit_calls_the_dispatch_and_generate_attributes(clean_record):
    """A caller that wraps ``_dispatch`` and ``generate`` on the instance (as
    the benchmark times them) sees every request pass through both."""
    cap = _captioner("NACF", depth=1)
    reqs = _requests(cap, 3)
    want = [h for _, h in _serve(cap, reqs)]
    calls = []
    dispatch, generate = cap._dispatch, cap.generate

    def wrapped_dispatch(feats, category):
        calls.append("dispatch")
        return dispatch(feats, category)

    def wrapped_generate(*args, **kwargs):
        calls.append("generate")
        return generate(*args, **kwargs)

    cap._dispatch, cap.generate = wrapped_dispatch, wrapped_generate
    got = [h for _, h in _serve(cap, reqs)]
    assert calls == ["dispatch", "generate"] * len(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_each_depth_returns_depth_0s_results_in_order(method, depth, clean_record):
    """Requests of 3, 2, 4, 3 and 1 videos: at every depth the same tickets
    and bit for bit the same hypotheses as a depth-0 captioner's, request i
    read by the submit of request i + depth and the rest by ``flush``."""
    base = _captioner(method, depth=0)
    reqs = [_requests(base, 1, videos=v, seed=20 + i)[0] for i, v in enumerate((3, 2, 4, 3, 1))]
    want = _serve(base, reqs)
    cap = _captioner(method, depth=depth)
    done = []
    for i, (feats, cat) in enumerate(reqs):
        ticket, out = cap.submit(feats, cat)
        assert ticket == i
        assert [t for t, _ in out] == ([i - depth] if i >= depth else [])
        done += out
    done += cap.flush()
    assert [t for t, _ in done] == [t for t, _ in want] == list(range(len(reqs)))
    for (_, got), (_, ref) in zip(done, want):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
