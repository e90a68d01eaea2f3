"""Each cell's files through the harness on the CPU at a tiny size: the
lookups by name, the client loop, the check against the reference and the
result line's shape. The program runs its plain versions there (the
kernels' rounding points, ``use_pallas``) and the reference its bfloat16
arithmetic; in float32 both give the same captions too."""

import math

import pytest

import bench_tiny as bt
from benchmark import harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS + ["open_loop"])
@pytest.mark.parametrize("route", ["bf16", "fp32"])
def test_cell_runs_and_agrees_with_the_reference(cell, route):
    extra = {} if route == "bf16" else dict(compute_dtype="float32", use_pallas=False)
    parts = bt.run_tiny(bt.tiny_ctx(cell, seed=2**31 + 7, **extra))
    line = parts["line"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["check"]["caption_mismatch"]["value"] == 0.0
    assert line["check"]["unanswered"] == {"value": 0, "limit": 0}
    want = {m["name"] for m in harness.metrics_for(harness.spec(), cell, False)}
    assert set(line["metrics"]) == (want if cell in CELLS else {"setup_s"})
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_same_seed_same_inputs_and_schedule():
    from benchmark import inputs

    m = bt.tiny_config("nacf-msrvtt")["student"]["model"]
    a = inputs.make_videos(m, 4, 2**31 + 3, inputs.FEATURE_STREAM, "cpu")
    b = inputs.make_videos(m, 4, 2**31 + 3, inputs.FEATURE_STREAM, "cpu")
    assert all((x == y).all() for x, y in zip(a[0] + [a[1]], b[0] + [b[1]]))
    w1, w2 = (inputs.make_weights(m, 2**31 + 3, "cpu") for _ in range(2))
    assert all((w1[k] == w2[k]).all() for k in w1)
    client = harness.traffic("open_loop").Client(
        dict(rate=50.0, sizes=[2, 4], pool_videos=8, block=10, schedule_seed=7, depth=2),
        bt.tiny_config("nacf-msrvtt"),
        2**31 + 3, "cpu")
    s1, s2 = client.schedule(10), client.schedule(10)
    assert s1 == s2 and len(s1) == 500
    other = harness.traffic("open_loop").Client(client.params, bt.tiny_config("nacf-msrvtt"),
                                                 2**31 + 4, "cpu").schedule(10)
    # another seed: the same arrivals and sizes, other places in the pool
    assert [x[0] for x in s1] == [x[0] for x in other]
    assert [x[2] for x in s1] == [x[2] for x in other]
    assert [x[1] for x in s1] != [x[1] for x in other]
    # each block of 10 holds both sizes in equal shares
    for b in range(0, 500, 10):
        assert sorted(x[2] for x in s1[b:b + 10]) == [2] * 5 + [4] * 5
