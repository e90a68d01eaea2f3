"""navc_tpu's A/B route switches in the port, against navc_tpu, on the CPU.

The six switches (``NAVC_DENSE_REFINE``, ``NAVC_NO_FUSED_TRAIN``,
``NAVC_NO_FUSED_CE``, ``NAVC_NO_{ATTEND,PERMUTE,TOPK}_KERNEL``) are set and
unset with ``monkeypatch.setenv``:

  * the port's predicates equal navc_tpu's over a grid of configurations;
  * the beam's ``Routes`` (``plan_routes``) name the kernels that navc_tpu's
    beam search calls under the same switches. navc_tpu's beam kernels run
    only on a device (beam.py:376, :382, :399), so its device gate is opened
    by replacing ``jax.default_backend`` and its kernels run in interpret
    mode; navc_tpu's K8 also needs 16 | b (a TPU tile), so the grid's b is
    16;
  * float32 tokens equal navc_tpu's exactly: mp under ``NAVC_DENSE_REFINE``
    (K1 + K3 on every canvas row, both packages), and the beam search under
    each switch set, against navc_tpu's kernel route as above (scores
    within 1e-6);
  * under ``NAVC_NO_FUSED_TRAIN`` and ``NAVC_NO_FUSED_CE`` the p = 0 train
    step matches navc_tpu's with tests/test_torch_port_train.py's
    tolerances (metrics 1e-4, gradients and parameters 1e-5);
  * a switch is read when the generator or step is made: flipping it later
    does not change the route.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_ar_generator as jax_make_ar_generator
from navc_tpu.ops import beam_attend as JA
from navc_tpu.ops import beam_permute as JP
from navc_tpu.ops import eligibility as JE
from navc_tpu.ops import vocab_fused as JV
from navc_tpu_torch.config import default_config
from navc_tpu_torch.decoding import make_ar_generator
from navc_tpu_torch.decoding.beam import Routes, Switches, plan_routes
from navc_tpu_torch.ops import eligibility as PE
from navc_tpu_torch.runtime import train_step
from test_torch_port_beam import WIDE
from test_torch_port_beam import _models as beam_models
from test_torch_port_beam import _request as beam_request
from test_torch_port_decode import _decode_both, _nacf, _requests
from test_torch_port_train import (METRIC_TOL, NO_DROPOUT, PARAM_TOL, assert_trees_close,
                                   configs, jax_one_step, make_batch, port_model,
                                   port_one_step)

BEAM_SWITCHES = ("NAVC_NO_ATTEND_KERNEL", "NAVC_NO_PERMUTE_KERNEL", "NAVC_NO_TOPK_KERNEL")
SWITCHES = ("NAVC_DENSE_REFINE", "NAVC_NO_FUSED_TRAIN", "NAVC_NO_FUSED_CE") + BEAM_SWITCHES


def set_switches(monkeypatch, on):
    for name in SWITCHES:
        if name in on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)


def grid():
    """Configurations around the kernels' gates, both packages."""
    out = []
    for method, pallas, paradigm, layers, dec in itertools.product(
            ("NACF", "ARB", "NAB", "ARB2"), (True, False), ("mp", "l2r", "ef"), (1, 2),
            ("default", "SelfMask")):
        kw = dict(use_pallas=pallas, paradigm=paradigm, num_hidden_layers_decoder=layers,
                  vocab_size=50, dim_hidden=16, num_attention_heads=2, intermediate_size=32)
        over = dict(paradigm=paradigm)
        if dec == "SelfMask":
            if method not in ("ARB", "ARB2"):
                continue
            over.update(decoding_type="SelfMask", parallel_mlm=True)
        cfg = default_config(method, dataset="MSRVTT", **kw).replace(**over)
        jcfg = jax_default_config(method, dataset="MSRVTT", **kw).replace(**over)
        assert cfg.to_dict() == jcfg.to_dict()
        out.append((cfg, jcfg))
    return out


@pytest.mark.parametrize("switch", [None] + list(SWITCHES))
def test_predicates_match_navc_tpu(switch, monkeypatch):
    set_switches(monkeypatch, () if switch is None else (switch,))
    pairs = grid()
    for name in ("fused_sparse_eligible", "fused_train_eligible", "fused_vocab_ce_eligible",
                 "kv_cached_beam_eligible", "fused_decode_eligible"):
        got = [getattr(PE, name)(c) for c, _ in pairs]
        want = [getattr(JE, name)(j) for _, j in pairs]
        assert got == want, (switch, name)
    flips = {"NAVC_DENSE_REFINE": "fused_sparse_eligible",
             "NAVC_NO_FUSED_TRAIN": "fused_train_eligible",
             "NAVC_NO_FUSED_CE": "fused_vocab_ce_eligible"}
    if switch in flips:  # the switch turns its route off everywhere
        assert not any(getattr(PE, flips[switch])(c) for c, _ in pairs)


def jax_kernel_calls(monkeypatch):
    """navc_tpu's beam kernels in interpret mode behind its device gate,
    recording the names of those its decode calls."""
    calls = set()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for mod, name in ((JA, "beam_attend_step"), (JA, "cross_attend"),
                      (JV, "fused_project_topk"), (JP, "permute_beam_caches")):
        def wrap(*a, _f=getattr(mod, name), _n=name, **k):
            calls.add(_n)
            return _f(*a, **dict(k, interpret=True))
        monkeypatch.setattr(mod, name, wrap)
    return calls


ROUTE_OF = {"fused_project_topk": "topk", "beam_attend_step": "attend",
            "cross_attend": "cross", "permute_beam_caches": "permute"}


@pytest.mark.parametrize("on", [s for n in range(4) for s in itertools.combinations(BEAM_SWITCHES, n)],
                         ids=lambda on: "+".join(s[8:-7].lower() for s in on) or "none")
def test_beam_routes_and_tokens_match_navc_tpu(on, monkeypatch):
    """16 videos, d 128, float32, the kernels on: the kernels navc_tpu calls
    are the port's ``Routes``, and the tokens are equal."""
    set_switches(monkeypatch, on)
    calls = jax_kernel_calls(monkeypatch)
    jcfg, jmodel, jvars, cfg, model = beam_models(use_pallas=True, compute_dtype="float32",
                                                   max_len=8, **WIDE)
    feats, cat = beam_request(cfg, 16, seed=5)
    enc = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    ref_hyp, ref_sc = jax_make_ar_generator(jcfg, jmodel, jit=False)(jvars, enc, jnp.asarray(cat))
    routes = plan_routes(cfg, 16, Switches.read())
    assert routes == Routes(**{ROUTE_OF[n]: True for n in calls}), (sorted(calls), routes)
    gen = make_ar_generator(cfg, model)
    with torch.no_grad():
        hyp, sc = gen(model.encode([torch.from_numpy(f) for f in feats]), torch.from_numpy(cat))
    assert gen.routes == routes
    np.testing.assert_array_equal(hyp.numpy(), np.asarray(ref_hyp))
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref_sc), rtol=1e-6, atol=1e-6)


def test_beam_precedence():
    """navc_tpu's precedence (beam.py:373-402) over widths and batches: K7
    only with K6; K8 only off K6; the switches drop only their own kernels."""
    for h, b in itertools.product((16, 128), (12, 16, 64)):
        cfg = default_config("ARB", dataset="MSRVTT", use_pallas=True, dim_hidden=h,
                             num_attention_heads=2, intermediate_size=32, vocab_size=50)
        for on in itertools.product((False, True), repeat=3):
            r = plan_routes(cfg, b, Switches(*on))
            fits = h % 128 == 0 and b % 16 == 0
            assert r.cross == r.attend == (fits and not on[0])
            assert r.permute == (not r.attend and not on[1])
            assert r.topk == (not on[2])
        assert plan_routes(cfg.replace(use_pallas=False), b, Switches()) == Routes()


def test_switch_read_when_made(monkeypatch):
    """A generator and a step keep the routes of the environment they were
    made in."""
    set_switches(monkeypatch, ())
    *_, cfg, model = beam_models(use_pallas=True, compute_dtype="float32", max_len=6, **WIDE)
    feats, cat = beam_request(cfg, 16, seed=2)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    gen = make_ar_generator(cfg, model)
    monkeypatch.setenv("NAVC_NO_ATTEND_KERNEL", "1")
    monkeypatch.setenv("NAVC_NO_TOPK_KERNEL", "1")
    gen(enc, torch.from_numpy(cat))
    assert gen.routes == Routes(topk=True, cross=True, attend=True)
    later = make_ar_generator(cfg, model)
    later(enc, torch.from_numpy(cat))
    assert later.routes == Routes(permute=True)

    jcfg, tcfg = configs("NACF", use_pallas=True)
    monkeypatch.delenv("NAVC_NO_FUSED_TRAIN", raising=False)
    step_model = port_model(tcfg, jcfg)
    step = train_step.make_train_step(tcfg, step_model,
                                      train_step.create_train_state(tcfg, step_model).optimizer)
    monkeypatch.setenv("NAVC_NO_FUSED_TRAIN", "1")
    calls = []
    fn = train_step.fused_bert_layer_train
    monkeypatch.setattr(train_step, "fused_bert_layer_train",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    step(make_batch(tcfg), torch.Generator().manual_seed(0))
    assert step.routes == train_step.TrainRoutes(layer=True, ce=True)
    assert len(calls) == 2  # NACF's two decoder passes, on the fused layer
    assert train_step.TrainRoutes.of(tcfg) == train_step.TrainRoutes()


def test_dense_refine_f32_tokens_match_navc_tpu(monkeypatch):
    """NACF mp with the ARB teacher, the kernels on, float32: under
    NAVC_DENSE_REFINE both packages refine every canvas row (the port
    through K1's plain version: no K2 call) and the tokens are equal; they
    are also the sparse route's."""
    set_switches(monkeypatch, ())
    student, teacher = _nacf(use_pallas=True, compute_dtype="float32")
    (feats, cat), = _requests(student[0], 1, 8, seed=5)
    sparse, _ = _decode_both(student, teacher, feats, cat, jit=False)
    monkeypatch.setenv("NAVC_DENSE_REFINE", "1")
    import navc_tpu_torch.decoding.mask_predict as mp
    qsub = []
    monkeypatch.setattr(mp, "fused_layer_qsub", lambda *a, **k: qsub.append(1))
    out, ref = _decode_both(student, teacher, feats, cat, jit=False)
    assert not qsub
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, sparse)


@pytest.mark.parametrize("switch", ["NAVC_NO_FUSED_TRAIN", "NAVC_NO_FUSED_CE"])
@pytest.mark.parametrize("method", ["NACF", "ARB2"])
def test_train_switch_step_matches_navc_tpu(method, switch, monkeypatch):
    """use_pallas=True, p = 0, float32, the switch set for both packages:
    the port's step takes the route navc_tpu's takes (no K11 under
    NO_FUSED_TRAIN, no K9 under either) and matches it."""
    set_switches(monkeypatch, (switch,))
    jcfg, cfg = configs(method, use_pallas=True, **NO_DROPOUT)
    assert train_step.TrainRoutes.of(cfg) == train_step.TrainRoutes(
        layer=switch != "NAVC_NO_FUSED_TRAIN", ce=False)
    calls = []
    for name in ("vocab_ce_train", "fused_bert_layer_train"):
        fn = getattr(train_step, name)
        monkeypatch.setattr(train_step, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    batch = make_batch(cfg)
    batch["valid_mask"] = np.array([1, 1, 0, 1], np.float32)
    want_vars, want_grads, want_metrics = jax_one_step(jcfg, batch)
    got_vars, got_grads, got_metrics = port_one_step(cfg, jcfg, batch, monkeypatch)
    passes = 2 if cfg.visual_word_generation else 1
    assert calls == ([] if switch == "NAVC_NO_FUSED_TRAIN"
                     else ["fused_bert_layer_train"] * passes)
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], err_msg=k, **METRIC_TOL)
    assert_trees_close(got_grads, want_grads, PARAM_TOL, "grads")
    assert_trees_close(got_vars["params"], want_vars["params"], PARAM_TOL, "params")
    assert_trees_close(got_vars["batch_stats"], want_vars["batch_stats"], PARAM_TOL,
                       "batch_stats")


def test_no_switch_means_every_kernel_route(monkeypatch):
    """With no switch in the environment every kernel route is on: the
    default routes are the kernels'."""
    set_switches(monkeypatch, ())
    monkeypatch.delenv("NAVC_NO_KVCACHE", raising=False)
    nacf = default_config("NACF", dataset="MSRVTT", use_pallas=True)
    arb = default_config("ARB", dataset="MSRVTT", use_pallas=True)
    assert Switches.read() == Switches()
    assert PE.fused_sparse_eligible(nacf) and PE.kv_cached_beam_eligible(arb)
    assert train_step.TrainRoutes.of(nacf) == train_step.TrainRoutes(layer=True, ce=True)
    assert plan_routes(arb, 64, Switches.read()) == Routes(topk=True, cross=True, attend=True)
    assert plan_routes(arb, 60, Switches.read()) == Routes(topk=True, permute=True)
