"""The MLAMoE language model (models/mla_moe.py) and its beam
(decoding/lm_beam.py) against the benchmark's plain reference
(benchmark/reference/mla_moe_lm.py), on the CPU at a tiny size: hidden 64,
3 layers (layer 0 dense), 8 experts top-2 and 1 shared, latent 16 + rope 8,
4 heads, vocabulary 97, a non-zero router correction bias, float32.

  * the full forward's log-probs equal the reference's (1e-5 relative);
  * prefill then cached steps give the reference's full-forward log-probs
    at every caption position;
  * the absorbed attention of a cached step equals the decompressed one;
  * the router's choices and weights equal the reference's, and the
    correction bias changes some choices;
  * the beam's tokens equal the reference beam's exactly and their
    log-probabilities to float32 rounding, with and without captions that
    end early;
  * the expert counter counts top-k x tokens a layer, and the captioner
    serves (tokens, log-probabilities) with ``navc.prefill`` and
    ``navc.moe.expert_tokens`` in the record under a profile;
  * the published configuration's parameter count, from shapes on the meta
    device; ``lm_overrides`` refuses a structure the decoder lacks.

Run: ``python -m pytest tests/test_torch_port_mla_moe.py -q``.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import lm_inputs
from benchmark.reference import mla_moe_lm as RL
from navc_tpu_torch.config import default_config, lm_overrides
from navc_tpu_torch.decoding import make_ar_generator
from navc_tpu_torch.models.mla_moe import CaptionLM, MLAMoELM, compute_dtype, rope_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=96, vocab_size=97, hidden_act="silu", kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rope_theta=800000.0,
            rms_norm_eps=1e-5, first_k_dense_replace=1, n_routed_experts=8,
            n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
            routed_scaling_factor=2.446, q_lora_rank=None, topk_method="noaux_tc",
            scoring_func="sigmoid", n_group=1, topk_group=1, norm_topk_prob=True)
M = dict(TINY, modality="mi", modality_dims=[24, 24], n_frames=4, dtype="float32")
P = 8  # prefix positions: 4 frames x 2 streams


def tiny(seed=3, eos_bias=0.0, **extra):
    """(cfg, model, state dict): float32, the benchmark's weight laws, a
    correction bias of scale 0.1, and the head's EOS row moved by
    ``eos_bias`` (captions that end)."""
    cfg = default_config("MLAMoE", dataset="MSRVTT", compute_dtype="float32", dim_i=24,
                         dim_m=24, n_frames=4, **dict(lm_overrides(TINY), **extra))
    model = CaptionLM(cfg, "cpu").eval().requires_grad_(False)
    lm_inputs.make_weights(M, seed, "cpu", out=model.state_dict())
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for layer in model.lm.layers:
            if not layer.dense:
                layer.mlp.gate.e_score_correction_bias.copy_(torch.randn(8, generator=g) * 0.1)
        model.lm.lm_head.weight[RL.EOS] += eos_bias * model.lm.norm.weight
    return cfg, model, dict(model.state_dict())


def videos(b, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, 4, 24, generator=g) for _ in range(2)]


def test_state_dict_is_the_references():
    _, _, sd = tiny()
    shapes = RL.param_shapes(M)
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == s for k, s in shapes.items())


@pytest.mark.parametrize("seed", [3, 4])
def test_full_forward_matches_the_reference(seed):
    _, model, sd = tiny(seed)
    feats = videos(3, seed)
    tokens = torch.randint(5, 97, (3, 7), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = model(feats, tokens)
        want = RL.logprobs(sd, M, RL.sequence(sd, RL.prefix_of(sd, M, feats), tokens))[:, P:]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_then_cached_steps_match_the_full_forward():
    """Rows of 2 videos x 3 beams: the prefix cache once per video, the
    caption cache written a position a step."""
    _, model, sd = tiny()
    lm, k, steps = model.lm, 3, 6
    feats = videos(2, 7)
    tokens = torch.randint(5, 97, (6, steps), generator=torch.Generator().manual_seed(1))
    tokens[:, 0] = RL.BOS
    with torch.no_grad():
        prefix = model.encode(feats)["enc_output"]
        pre, _ = lm.prefill(prefix)
        caption = torch.zeros(6, 3, steps, 24)
        got = []
        for t in range(1, steps + 1):
            hidden, _ = lm.decode_step(tokens[:, t - 1], t, pre, caption, k)
            got.append(torch.log_softmax(lm.logits(hidden), -1))
        ref_prefix = RL.prefix_of(sd, M, feats).repeat_interleave(k, 0)
        want = RL.logprobs(sd, M, RL.sequence(sd, ref_prefix, tokens))[:, P:]
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-5, atol=1e-5)


def test_absorbed_attention_equals_the_decompressed():
    """A cached step's absorbed attention (q_nope W_uk against the latent,
    the output through W_uv) against the full causal attention's last
    position, at every layer."""
    _, model, _ = tiny()
    g = torch.Generator().manual_seed(9)
    x = torch.randn(4, P + 3, 64, generator=g)
    with torch.no_grad():
        for layer in model.lm.layers:
            att = layer.self_attn
            cos, sin = rope_tables(torch.arange(P + 3), 8, 800000.0)
            full, entry = att.full(x, cos, sin)
            caption = torch.zeros(4, 5, 24)
            caption[:, :2] = entry[:, P:P + 2]
            got = att.cached(x[:, -1], cos[-1:], sin[-1:], entry[::1, :P], caption, 3, 1)
            torch.testing.assert_close(got, full[:, -1], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(caption[:, 2], entry[:, -1])


def test_router_matches_the_reference_and_its_bias_chooses():
    _, model, sd = tiny()
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(2))
    changed = 0
    for i, layer in enumerate(model.lm.layers[1:], start=1):
        with torch.no_grad():
            idx, g = layer.mlp.gate(x)
            ridx, rg = RL.route(sd, "lm.layers.%d.mlp." % i, x, M)
            unbiased = torch.topk(torch.sigmoid(x @ layer.mlp.gate.weight.t()), 2, -1).indices
        order, rorder = idx.sort(-1), ridx.sort(-1)
        assert torch.equal(order.values, rorder.values)
        torch.testing.assert_close(g.gather(1, order.indices), rg.gather(1, rorder.indices))
        torch.testing.assert_close(g.sum(-1), torch.full((50,), 2.446))
        changed += int((unbiased.sort(-1).values != order.values).any(1).sum())
    assert changed > 0


@pytest.mark.parametrize("eos_bias", [0.0, 6.0], ids=["long", "ending"])
def test_beam_matches_the_reference_beam(eos_bias):
    """Tokens exactly and each token's log-probability to float32 rounding,
    the caption ranked by score / length**alpha; ``ending`` makes EOS likely
    so that hypotheses finish at different steps."""
    cfg, model, sd = tiny(5, eos_bias=eos_bias)
    feats = videos(4, 11)
    gen = make_ar_generator(cfg, model, jit=True)
    with torch.no_grad():
        tokens, _, lps, counts = gen(model.encode(feats))
    want, want_lp = RL.beam(sd, M, feats, cfg.beam_size, cfg.max_len, cfg.beam_alpha)
    assert torch.equal(tokens.long(), want)
    torch.testing.assert_close(lps, want_lp, rtol=1e-5, atol=2e-5)
    if eos_bias:
        assert bool((tokens == RL.EOS).any(1).all())
    assert gen.steps_run > 0 and counts.shape == (2, 8)


def test_expert_counter_counts_every_routed_token():
    cfg, model, _ = tiny()
    gen = make_ar_generator(cfg, model, jit=False)
    with torch.no_grad():
        _, _, _, counts = gen(model.encode(videos(3, 1)))
    rows, steps = 3 * cfg.beam_size, cfg.max_len - 1
    assert counts.sum(1).tolist() == [2 * (3 * P + rows * steps)] * 2


def test_captioner_serves_logprobs_and_records_the_prefill_and_experts():
    from torch.profiler import ProfilerActivity, profile

    from navc_tpu_torch.runtime import summary
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    cfg, model, _ = tiny()
    cap = StreamingCaptioner(cfg, model, depth=1, device="cpu")
    feats = [f.numpy() for f in videos(2, 4)]
    summary.clear_record()
    with profile(activities=[ProfilerActivity.CPU]):
        done = [cap.submit(feats)[1], cap.submit(feats)[1], cap.flush()]
    rec = summary.record()
    summary.clear_record()
    answers = [hyp for part in done for _, hyp in part]
    assert len(answers) == 2
    for tokens, lps in answers:
        assert tokens.shape == lps.shape == (2, cfg.max_len - 1) and lps.dtype == np.float32
        assert (lps <= 0).all()
    assert rec["spans"]["navc.prefill"]["count"] == 2
    experts = rec["counters"]["navc.moe.expert_tokens"]
    rows, steps = 2 * cfg.beam_size, cfg.max_len - 1
    assert experts["count"] == 2
    assert np.asarray(experts["total"]).sum(1).tolist() == [2 * 2 * (2 * P + rows * steps)] * 2


def test_array_counters_add_elementwise():
    from navc_tpu_torch.runtime import summary

    summary.clear_record()
    summary.count("navc.moe.expert_tokens", np.array([[1, 2], [3, 4]]))
    summary.count("navc.moe.expert_tokens", np.array([[1, 0], [0, 1]]))
    c = summary.record()["counters"]["navc.moe.expert_tokens"]
    summary.clear_record()
    assert c == {"count": 2, "total": [[2, 2], [3, 5]]}
    json.dumps(c)


def test_published_parameter_count():
    with open(os.path.join(ROOT, "benchmark", "configs", "kimi-vl-a3b-msrvtt.json")) as f:
        published = json.load(f)
    cfg = default_config("MLAMoE", dataset="MSRVTT", **lm_overrides(published))
    lm = MLAMoELM(cfg, compute_dtype(cfg), "meta")
    assert sum(p.numel() for p in lm.parameters()) == 15_960_110_208


@pytest.mark.parametrize("bad", [dict(q_lora_rank=1536), dict(scoring_func="softmax"),
                                 dict(num_key_value_heads=2), dict(rope_scaling={"type": "yarn"})])
def test_lm_overrides_refuse_what_the_decoder_lacks(bad):
    with pytest.raises(ValueError):
        lm_overrides(dict(TINY, **bad))
