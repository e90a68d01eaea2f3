"""Host-side plans of the port's serving kernels, checked without a card.

K6 (``beam_attend_step``) splits each instance's positions [0, tpos] into
runs, a block each, planned in Python by ``attend_runs``; K1 and K2 (the
serving walk of ``fused_layer`` / ``fused_layer_qsub``) take scratch sized
by ``walk_scratch`` and refuse operands by ``check_layer``. The kernels run
only on the card (tests/test_torch_port_cuda.py); what they are handed is
decided here, in plain Python that the CPU reaches.
"""

import math

import pytest
import torch

from navc_tpu_torch.ops.beam_attend import (RUN_MAX, STAGE_BYTES, STAGE_MAX,
                                            attend_runs, stage_bytes)
from navc_tpu_torch.ops.fused_layer import (LayerWeights, check_layer,
                                            walk_scratch)

TPOS = (0, 1, 2, 14, 15, 28, 29, 31, 63)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 16, 60, 64, 1024, 4096])
def test_attend_run_plan_covers_each_position_once(b, itemsize):
    """Every position of [0, tpos] lies in exactly one run, no run is empty
    or longer than RUN_MAX (a lane each) or than its stage allows, and the
    b * runs blocks give every SM one where there are positions enough."""
    for k in (1, 5, 8, 32):
        for h, nh in ((128, 2), (128, 8), (512, 8), (512, 32), (1024, 16)):
            for sms in (8, 114, 132):
                for tpos in TPOS:
                    if stage_bytes(k, h, nh, itemsize, 1) > STAGE_MAX:  # refused
                        with pytest.raises(ValueError):
                            attend_runs(b, k, tpos, h, nh, itemsize, sms)
                        continue
                    run, runs = attend_runs(b, k, tpos, h, nh, itemsize, sms)
                    ranges = [(s * run, min((s + 1) * run, tpos + 1)) for s in range(runs)]
                    covered = [p for lo, hi in ranges for p in range(lo, hi)]
                    assert covered == list(range(tpos + 1)), (b, k, tpos, h, sms)
                    assert all(lo < hi for lo, hi in ranges)
                    assert 1 <= run <= RUN_MAX
                    assert stage_bytes(k, h, nh, itemsize, run) <= STAGE_MAX
                    if stage_bytes(k, h, nh, itemsize, 1) <= STAGE_BYTES:
                        assert stage_bytes(k, h, nh, itemsize, run) <= STAGE_BYTES
                    assert b * runs >= min(sms, b * (tpos + 1))


def test_attend_run_plan_at_the_serving_shapes():
    """The ARB decode's shapes (beam 5, H 512, 8 heads, bf16, 132 SMs): at
    64 videos and tpos 14 five runs of 3 (320 blocks, about two an SM); at
    B=1024 three runs of 5 (each 52 KB of stage: four blocks an SM), at
    tpos 13 the last of them 4 long (5 does not divide 14); a first step is
    one run."""
    assert attend_runs(64, 5, 14, 512, 8, 2, 132) == (3, 5)
    assert attend_runs(1024, 5, 14, 512, 8, 2, 132) == (5, 3)
    assert attend_runs(1024, 5, 13, 512, 8, 2, 132) == (5, 3)
    assert attend_runs(1024, 5, 0, 512, 8, 2, 132) == (1, 1)
    assert attend_runs(64, 5, 29, 512, 8, 2, 132) == (6, 5)
    assert stage_bytes(5, 512, 8, 2, 5) == 2 * 5 * 5 * 1040 + 5 * 8 * 28


def test_attend_run_plan_refuses_a_position_beyond_the_stage():
    with pytest.raises(ValueError, match="stage"):
        attend_runs(16, 32, 3, 4096, 64, 4, 132)


def _layer_operands(n, l, le, h, heads, inter):
    bf = torch.bfloat16
    mats = {f: torch.zeros((h, h), dtype=bf) for f in LayerWeights.__dataclass_fields__
            if f.startswith("w")}
    mats.update(wi=torch.zeros((inter, h), dtype=bf), wo2=torch.zeros((h, inter), dtype=bf))
    vecs = {f: torch.zeros(h) for f in LayerWeights.__dataclass_fields__
            if f.startswith("b")}
    vecs["bi"] = torch.zeros(inter)
    w = LayerWeights(**mats, **vecs)
    return dict(raw=torch.zeros((n, l, h), dtype=bf), static=torch.zeros((n, l, h), dtype=bf),
                kp=torch.zeros((n, l), dtype=torch.bool),
                ke=torch.zeros((n, le, h), dtype=bf), ve=torch.zeros((n, le, h), dtype=bf),
                w=w, ln_scale=torch.ones(h), ln_bias=torch.zeros(h), n_head=heads,
                out_dtype=torch.bfloat16)


@pytest.mark.parametrize("n,l,h,inter", [(384, 32, 512, 2048), (384, 29, 512, 2048),
                                         (1, 24, 256, 1024), (7, 13, 128, 272)])
def test_walk_scratch_sizes_and_alignment(n, l, h, inter):
    """K1's query rows are its N * L canvas rows, flattened with no sequence
    padding; K2's canvas rows are padded to 16 a sequence, its query rows
    not. Every (rows, H) slice of the scratch starts 16-byte aligned (TMA
    reads it) and the whole fits the walk's row tiles."""
    k1 = walk_scratch(n, l, h, inter)
    rows = n * l
    assert k1 == {"rows": ((5, rows, h), torch.bfloat16), "g": ((rows, inter), torch.bfloat16),
                  "res": ((rows, h), torch.float32)}
    k = min(24, l)
    k2 = walk_scratch(n, l, h, inter, k)
    assert k2["canvas"][0] == (3, n * math.ceil(l / 16) * 16, h)
    assert k2["query"][0] == (3, n * k, h) and k2["g"][0] == (n * k, inter)
    if (n, l, h) == (384, 32, 512):  # the NACF decode: 12288 rows, 138 MB
        total = sum(math.prod(s) * torch.empty((), dtype=dt).element_size()
                    for s, dt in k1.values())
        assert rows == 12288 and total == 12288 * (5 * 512 * 2 + 2048 * 2 + 512 * 4)
    for shape, dt in list(k1.values()) + list(k2.values()):
        if len(shape) == 3 and shape[1] * shape[2] < 1 << 22:
            for t in torch.empty(shape, dtype=dt).unbind(0):
                assert t.data_ptr() % 16 == 0


def test_check_layer_takes_the_walk_shapes_and_refuses_others():
    """check_layer accepts the shapes the walk takes (L up to 32, ragged L,
    one sequence, H 128 to 512) and refuses the others with ValueError,
    without a card."""
    for n, l, le, h, heads, inter in [(384, 32, 16, 512, 8, 2048), (1, 29, 16, 256, 4, 1024),
                                      (3, 24, 8, 128, 2, 272)]:
        check_layer(**_layer_operands(n, l, le, h, heads, inter))
    bad = {
        "canvas longer than 32": dict(l=33),
        "encoder longer than 32": dict(le=40),
        "H not a multiple of 128": dict(h=192, heads=4),
        "H above 512": dict(h=640, heads=5),
        "head width not a multiple of 16": dict(h=384, heads=16),
        "FFN not a multiple of 16": dict(inter=1000),
    }
    for what, change in bad.items():
        shape = dict(n=2, l=24, le=16, h=256, heads=4, inter=1024)
        shape.update(change)
        with pytest.raises(ValueError):
            check_layer(**_layer_operands(**shape))
            pytest.fail(what)
    ops = _layer_operands(2, 24, 16, 256, 4, 1024)
    flat = torch.zeros(256 * 256 + 1, dtype=torch.bfloat16)
    ops["w"].wq_s = flat[1:].view(256, 256)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte"):
        check_layer(**ops)
    ops = _layer_operands(2, 24, 16, 256, 4, 1024)
    ops["kp"] = ops["kp"].to(torch.uint8)
    with pytest.raises(ValueError, match="kp"):
        check_layer(**ops)
