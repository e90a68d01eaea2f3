"""costs.py against counts made by hand at tiny sizes."""

import math

import bench_tiny  # noqa: F401
from benchmark import costs

M = dict(modality="mi", modality_dims=[3, 5], n_frames=2, dim_hidden=4, intermediate_size=6,
         max_len=6, vocab_size=7, length_head=True, length_beam_size=2, iterations=2,
         use_ct=True, beam_size=3, with_category=True, num_category=2, num_attention_heads=2)


def test_encode_flops_by_hand():
    # per stream 2 frames x (dim x 4 + 2 x 4 x 4) multiply-adds; the length head 4x4 + 4x6
    want = 2 * (2 * (3 * 4 + 32) + 2 * (5 * 4 + 32)) + 2 * (16 + 24)
    assert costs.encode_flops(M) == want


def test_nacf_decode_flops_by_hand():
    te, d, L, v, f = 4, 4, 6, 7, 6

    def fwd(q):
        return (2 * q * d * d + 4 * L * d * d + 4 * q * L * d + 6 * q * d * d
                + 4 * q * te * d + 4 * q * d * f + 2 * q * d * v)

    # T = 3: the CT pass (6), the CT completion (6), floor(6 / 3) = 2, the teacher (6)
    want = (fwd(6) + fwd(6) + fwd(2) + fwd(6)) * 2 + 8 * te * d * d
    assert costs.nacf_decode_flops(M) == want


def test_beam_decode_flops_by_hand():
    te, d, v, f, k = 4, 4, 7, 6, 3
    per = 8 * d * d + 4 * d * d + 4 * d * f + 4 * 5 * d + 4 * te * d + 2 * d * v
    assert costs.beam_decode_flops(M, 5) == k * (5 * per + 4 * te * d * d)


def test_request_cost_and_bound():
    config = {"decode": "nacf", "student": {"model": M}, "teacher": {"model": dict(M, length_head=False)}}
    c = costs.request_cost(config, 3)
    enc = costs.encode_flops(M) + costs.encode_flops(dict(M, length_head=False))
    assert c["flops"] == 3 * (enc + costs.nacf_decode_flops(M))
    params = costs.param_count(M) + costs.param_count(dict(M, length_head=False))
    assert c["bytes"] == 3 * 2 * 8 * 4 + params * 2 + 3 * 6 * 4
    assert costs.bound_s(989e12, 1.0) == 1.0
    assert math.isclose(costs.bound_s(1.0, 3.35e12), 1.0)
