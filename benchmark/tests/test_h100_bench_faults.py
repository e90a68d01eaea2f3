"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, with the captioner's answers altered where they are produced."""

import numpy as np
import pytest

import bench_tiny as bt
from benchmark import harness, program

CELLS = [w["name"] for w in harness.spec()["workloads"]]



def lost(ticket):
    """Even tickets from 2 on: the closed loop's first request of the window
    (its warm-up takes tickets 0 and 1 here) and every other one of the open
    loop's (a warm-up answer lost is not read anyway)."""
    return ticket >= 2 and ticket % 2 == 0


def broken(fault):
    def make(config, weights, device, depth):
        cap = program.captioner(config, weights, device, depth)
        sync = cap._sync

        def bad(hyp):
            out = np.array(sync(hyp))
            if fault == "token":
                out[:, 1] = (out[:, 1] + 7) % config["student"]["model"]["vocab_size"]
            elif fault == "half_batch":
                out[out.shape[0] // 2:] = 0
            return out

        cap._sync = bad
        if fault == "lost":
            submit = cap.submit

            def lose_first(*args):
                ticket, done = submit(*args)
                return ticket, [d for d in done if not lost(d[0])]

            cap.submit = lose_first
            cap.flush = lambda: [d for d in type(cap).flush(cap) if not lost(d[0])]
        return cap
    return make


@pytest.mark.parametrize("cell", CELLS + ["open_loop"])
@pytest.mark.parametrize("fault", ["token", "half_batch", "lost"])
def test_a_broken_path_is_not_correct(cell, fault):
    ctx = bt.tiny_ctx(cell, seed=2**31 + 11)
    ctx["captioner"] = broken(fault)
    if fault == "lost":
        ctx["workload"]["traffic"]["depth"] = 0
    parts = bt.run_tiny(ctx)
    assert parts["line"]["correct"] is False
    if fault == "lost":
        assert parts["line"]["check"]["unanswered"]["value"] >= 1
    else:
        assert parts["line"]["check"]["caption_mismatch"]["value"] > \
            parts["line"]["check"]["caption_mismatch"]["limit"]
