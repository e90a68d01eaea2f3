"""The MLAMoE cell (kimi-vl-a3b-msrvtt.beam-512) through its traffic kind's
run on the CPU at a tiny size (every width cut, a few videos): the run is
correct and its result line has the cell's end-to-end metrics; three
faults in the program's timed path, each in the model the captioner runs,
make it not correct (``benchmark/lm_faults.py``: one expert's output
dropped, the router's correction bias left out of the choice, a step's
latent entry one caption slot early, the caption's rotary position one
off).

The faults run the program in float32 (``fp32``), where its log-probs
agree with the reference's to about 1e-6, against a logprob_err limit of
FP32_LIMIT: the cell's own limits are set at the published widths from
the bfloat16 program's readings, which a tiny model's faults (a change of
0.006 to 0.04 in a log-prob here) need not pass. The ``cuda`` test
``test_mla_moe_faults_fail_the_cells_check`` holds the faults to the
cell's own limits at the published widths."""

import copy
import math
import time

import pytest

import bench_tiny  # noqa: F401  (puts the repository root on sys.path)
from benchmark import harness, lm_faults

CELL = "kimi-vl-a3b-msrvtt.beam-512"
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=96, vocab_size=97, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, moe_intermediate_size=32, modality_dims=[24, 24],
            n_frames=4)


FP32_LIMIT = 1e-3


def tiny_ctx(seed, fp32=False):
    work = copy.deepcopy(harness.workload(CELL))
    work["traffic"].update(videos=6, check_videos=4, warm_requests=2)
    config = dict(copy.deepcopy(harness.config(work["config"])), **TINY)
    ctx = dict(cell=CELL, workload=work, seed=seed, seconds=1.0, trace=False, device="cpu",
               t0=time.perf_counter(), config=config)
    if fp32:  # float32 weights and products, the kernels' plain versions off
        config["dtype"] = "float32"
        ctx["extra"] = dict(use_pallas=False)
        work["check"]["limits"]["logprob_err"] = FP32_LIMIT
    return ctx


def run_tiny(ctx):
    parts = harness.traffic(ctx["workload"]["traffic"]["kind"]).run(ctx)
    parts["line"] = harness.result_line(parts["run"], harness.metrics_for(
        harness.spec(), ctx["cell"], False), parts["correct"], parts["attempted"],
        parts["failed"], parts["device"], parts["checks"])
    return parts


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_the_cell_runs_and_agrees_with_the_reference(seed, fp32):
    line = run_tiny(tiny_ctx(seed, fp32))["line"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["check"]) == {"logprob_err", "beam_rank_violation", "unanswered"}
    assert line["check"]["logprob_err"]["value"] < line["check"]["logprob_err"]["limit"] / 4
    assert set(line["metrics"]) == {"captions_per_s.arb", "setup_s"}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("fault", sorted(lm_faults.FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    lm_faults.FAULTS[fault](monkeypatch.setattr)
    line = run_tiny(tiny_ctx(2**31 + 11, fp32=True))["line"]
    assert line["correct"] is False
    assert line["check"]["logprob_err"]["value"] > line["check"]["logprob_err"]["limit"]
