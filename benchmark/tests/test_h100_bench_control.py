"""The control: the reference in float8 (the precision below the
configuration's bfloat16) put in the program's place fails each cell's
limit, at a size a test run holds. (On the card, at the cells' own sizes:
``python3 benchmark/calibrate.py``; its readings are in PERF.md.)"""

import pytest

import bench_tiny as bt
from benchmark import harness
from benchmark.check import reference_captions

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_the_limit(cell):
    parts = bt.run_tiny(bt.tiny_ctx(cell, seed=2**31 + 13))
    assert parts["line"]["correct"] is True
    client, config = parts["client"], parts["run"].config
    compared = differ = 0
    for pool, (feats, cat) in enumerate(client.pools):
        rows = client.check_rows(pool)
        fp8 = reference_captions(config, parts["weights"], feats, cat, rows, "cpu", "fp8")
        compared += len(rows)
        differ += int((fp8 != parts["refs"][pool]).any(1).sum())
    limit = harness.workload(cell)["check"]["limits"]["caption_mismatch"]
    assert differ / compared > limit
