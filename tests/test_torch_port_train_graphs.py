"""The port's compiled training step (``jit=``, navc_tpu's jitted
``make_train_step``) and what it rests on, on the CPU.

On the card ``make_train_step(..., jit=True)`` replays the step as a CUDA
graph per batch signature, the fused layer's kernels read their dropout seed
from the device, and the optimizer is capturable (the replays are tested in
tests/test_torch_port_cuda.py, ``-k train_graphs``). The optimizer's lr is
a tensor on every device. Here, on the CPU, where ``jit=True`` runs the step
as it is:

  * navc_tpu's jitted step and the port's with ``jit=True`` agree at p = 0
    for NACF, ARB, NAB and ARB2 on the fused and the module route, at
    tests/test_torch_port_train.py's tolerances (metrics 1e-4, gradients and
    parameters 1e-5);
  * ``jit=True`` and ``jit=False`` give identical metrics and parameters
    over 3 dropout-on steps;
  * the plain K11/K12a/K12b versions give the same bits for an int seed and
    for a (1,) int32 tensor seed, and match navc_tpu's kernels in interpret
    mode with its (1,) seed (tests/test_torch_port_train_layer.py's
    tolerance, 1e-5);
  * Adam and RMSprop with the tensor lr filled from ``LrSchedule`` through
    its warm-up and decay follow torch's optimizer with a float lr over 5
    steps (rtol 1e-6: torch computes a tensor lr's step size in float32, a
    float's in double);
  * a ``.ckpt`` written with a tensor lr reads back (the lr tensor kept in
    place; a float lr, as an older checkpoint holds, read into it), and
    ``resume`` continues the straight run exactly;
  * an optimizer reload drops a step's graphs, and the hook that does so
    does not keep the step's graphs alive;
  * ``make_train_step`` and ``make_eval_loss_step`` keep navc_tpu's
    parameters first, ``jit`` keyword-only and True by default;
  * ``trace`` behaves as navc_tpu's does.

Run: ``python -m pytest tests/test_torch_port_train_graphs.py -q``.
"""

import copy
import gc
import inspect
import os
import weakref

import jax
import numpy as np
import pytest
import torch

import test_torch_port_train as TPT
from navc_tpu.runtime import summary as jax_summary
from navc_tpu.runtime.train_step import make_eval_loss_step as jax_make_eval_step
from navc_tpu.runtime.train_step import make_train_step as jax_make_step
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import export_flax_variables
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops import fused_layer_train as FT
from navc_tpu_torch.runtime import graphs, optim, summary, train_step
from navc_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint, to_torch
from navc_tpu_torch.runtime.loop import train_network_all
from navc_tpu_torch.runtime.train_step import (create_train_state, make_eval_loss_step,
                                               make_train_step)
from test_torch_port_train_layer import PROBS, SHAPES, TOL, _jax_ref, _case, port_layer


# ---------------------------------------------------------------------------
# the step against navc_tpu's, and jit=True against jit=False
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
@pytest.mark.parametrize("method", ["NACF", "ARB", "NAB", "ARB2"])
def test_jit_step_matches_navc_tpu(method, use_pallas, monkeypatch):
    """TPT.check_step (one step from the same flax weights, p = 0, float32,
    a valid_mask dropping one row) with the port's step made by
    ``make_train_step(..., jit=True)``."""
    made = []

    def jit_step(cfg, model, opt):
        made.append(1)
        return make_train_step(cfg, model, opt, jit=True)

    monkeypatch.setattr(TPT, "make_train_step", jit_step)
    TPT.check_step(method, monkeypatch, use_pallas=use_pallas)
    assert made == [1]


@pytest.mark.parametrize("method", ["NACF", "ARB", "NAB", "ARB2"])
def test_jit_and_eager_steps_are_identical_on_the_cpu(method):
    """3 dropout-on steps (hidden and encoder 0.3, the fused route) from the
    same weights and CPU generator: the same metrics and parameters bit for
    bit, and the same eval-loss metrics after them."""
    _, cfg = TPT.configs(method, use_pallas=True, hidden_dropout_prob=0.3,
                         encoder_dropout=0.3)
    batches = [TPT.make_batch(cfg, seed) for seed in range(3)]
    runs = {}
    for jit in (False, True):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                            train=True)
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, model, state.optimizer, jit=jit)
        assert step.jitted is None  # the CPU runs the step as it is
        gen = torch.Generator().manual_seed(1)
        metrics = [step(b, gen) for b in batches]
        evals = make_eval_loss_step(cfg, model, jit=jit)(batches[0])
        runs[jit] = (metrics, evals, export_flax_variables(model))
    (m0, e0, v0), (m1, e1, v1) = runs[False], runs[True]
    for a, b in zip(m0 + [e0], m1 + [e1]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for x, y in zip(jax.tree_util.tree_leaves(v0), jax.tree_util.tree_leaves(v1)):
        np.testing.assert_array_equal(x, y)
    assert len(m0) == 3 and m0[0]["total_loss"] != m0[1]["total_loss"]


def test_step_takes_a_batch_of_tensors_as_one_of_arrays():
    """The train and eval-loss steps give the same metrics and parameters
    for a batch of numpy arrays and for the same batch as tensors."""
    _, cfg = TPT.configs("NACF", use_pallas=True, hidden_dropout_prob=0.3)
    batch = TPT.make_batch(cfg, 0)
    runs = []
    for as_tensors in (False, True):
        b = {k: torch.from_numpy(v) for k, v in batch.items()} if as_tensors else batch
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                            train=True)
        state = create_train_state(cfg, model)
        metrics = make_train_step(cfg, model, state.optimizer)(b, torch.Generator())
        evals = make_eval_loss_step(cfg, model)(b)
        runs.append((metrics, evals, list(model.parameters())))
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for p, q in zip(runs[0][2], runs[1][2]):
        assert torch.equal(p, q)


def test_step_factories_keep_navc_tpu_parameters_first():
    """navc_tpu's (cfg, model, tx) and (cfg, model), positional, no
    defaults (the port's optimizer stands where optax's transformation
    does); ``jit`` keyword-only, True by default."""
    for port, ref in ((make_train_step, jax_make_step),
                      (make_eval_loss_step, jax_make_eval_step)):
        mine = list(inspect.signature(port).parameters.values())
        theirs = list(inspect.signature(ref).parameters.values())
        names = {"tx": "opt"}
        assert [(names.get(p.name, p.name), p.kind, p.default) for p in theirs] == [
            (p.name, p.kind, p.default) for p in mine[:len(theirs)]]
        assert [(p.name, p.kind, p.default) for p in mine[len(theirs):]] == [
            ("jit", inspect.Parameter.KEYWORD_ONLY, True)]


# ---------------------------------------------------------------------------
# the fused layer's seed: an int or navc_tpu's (1,) int32 tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1234567, 2 ** 31 - 1, -5])
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
def test_plain_kernels_take_a_tensor_seed_bitwise(seed, causal):
    """train_fwd_plain, ffn_bwd_operands_plain and attn_bwd_operands_plain
    (and their CPU wrappers) give the same bits for the seed as an int and
    as a (1,) int32 tensor."""
    n, l, le = 11, 13, 6
    x, enc, kp, w, dy = _case(n, l, le, seed=3)
    w = FT.kernel_weights({k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
                           for k, v in w.items()}, torch.float32)
    x, enc, kp, dy = (torch.from_numpy(a) for a in (x, enc, kp, dy))
    kw = dict(n_head=4, causal=causal, p=0.5, p_input=0.5, compute_dtype=torch.float32)

    def run(s):
        out, r2 = FT.train_fwd(x, enc, kp, w, s, **kw)
        dr2, fp = FT.ffn_bwd_operands(r2, dy, kp, w, s, p=0.5, compute_dtype=torch.float32)
        dx, denc, ap = FT.attn_bwd_operands(x, enc, dr2, kp, w, s, **kw)
        return [out, r2, dr2, dx, denc] + [t for pr in fp + ap for t in (pr.P, pr.Q, pr.part)]

    got = run(torch.tensor([seed], dtype=torch.int32))
    want = run(seed)
    assert len(got) == len(want) == 35
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(run(seed + 1)[0], want[0])


@pytest.mark.parametrize("prob", list(PROBS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tensor_seed_layer_matches_navc_tpu(shape, prob):
    """The autograd layer with the seed a (1,) int32 tensor against
    navc_tpu's fused layer in interpret mode with its (1,) seed, float32."""
    n, l, le, causal = SHAPES[shape]
    p, p_in = PROBS[prob]
    ref = _jax_ref(shape, prob)
    got = port_layer(n, l, le, causal, p, p_in,
                     seed=torch.tensor([1234567], dtype=torch.int32))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)


def test_device_seed_passes_a_tensor_on_and_fills_an_int():
    s = torch.tensor([7], dtype=torch.int32)
    assert FT.device_seed(s, torch.device("cpu")) is s
    for v, want in ((2 ** 31 - 1, 2 ** 31 - 1), (2 ** 31, -2 ** 31), (-5, -5),
                    (2 ** 32 + 3, 3)):
        t = FT.device_seed(v, torch.device("cpu"))
        assert t.dtype == torch.int32 and t.shape == (1,) and int(t) == want
        assert FT.seed_value(t) & 0xFFFFFFFF == v & 0xFFFFFFFF
    for bad in (torch.tensor([7]), torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor(7, dtype=torch.float32)):
        with pytest.raises(ValueError, match="int32"):
            FT.device_seed(bad, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the optimizer's tensor lr
# ---------------------------------------------------------------------------

def _float_lr_reference(cfg, params):
    """torch's optimizer as ``optim.make_optimizer`` configures it, with a
    float lr."""
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    return torch.optim.RMSprop(params, lr=cfg.learning_rate, alpha=0.99, eps=1e-8,
                               weight_decay=cfg.weight_decay)


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_tensor_lr_follows_the_float_lr_through_the_schedule(name):
    """5 steps with the lr from LrSchedule (2 warm-up steps, a decay of 0.5
    after step 3): make_optimizer's parameters and moments follow torch's
    optimizer with a float lr, and its lr tensor is filled in place, never
    rebound."""
    _, cfg = TPT.configs("NACF", optim=name, n_warmup_steps=2, decay=0.5,
                         learning_rate=1e-2, minimum_learning_rate=1e-4, weight_decay=5e-4)
    rng = np.random.RandomState(0)
    init = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((6, 5), (5,))]
    grads = [[torch.from_numpy(rng.randn(*t.shape).astype(np.float32)) for t in init]
             for _ in range(5)]
    sides = {}
    for tensor_lr in (False, True):
        params = [torch.nn.Parameter(t.clone()) for t in init]
        opt = (optim.make_optimizer(cfg, params) if tensor_lr
               else _float_lr_reference(cfg, params))
        lr0 = opt.param_groups[0]["lr"]
        assert torch.is_tensor(lr0) == tensor_lr
        sched = optim.LrSchedule.from_config(cfg)
        lrs = []
        for i, gs in enumerate(grads):
            lr = sched.step_lr()
            if tensor_lr:
                optim.set_learning_rate(opt, lr)
            else:
                opt.param_groups[0]["lr"] = lr
            lrs.append(float(opt.param_groups[0]["lr"]))
            for p, g in zip(params, gs):
                p.grad = g.clone()
            torch.nn.utils.clip_grad_value_(params, cfg.grad_clip)
            opt.step()
            if i == 2:
                sched.epoch_update()
        if tensor_lr:
            assert opt.param_groups[0]["lr"] is lr0
        sides[tensor_lr] = (params, lrs, [opt.state[p] for p in params])
    assert sides[True][1] == pytest.approx(sides[False][1], rel=1e-7)
    assert len(set(sides[True][1])) == 4  # two warm-up values, full, decayed
    for a, b in zip(sides[True][0], sides[False][0]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-9)
    for sa, sb in zip(sides[True][2], sides[False][2]):
        assert set(sa) == set(sb) and len(sa) >= 2
        for k in sa:
            np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-6, atol=1e-12,
                                       err_msg=k)


def test_tensor_lr_checkpoint_reads_back(tmp_path):
    """The optimizer's state through a .ckpt: an optimizer that loads it
    keeps its lr tensor (now holding the saved lr) and continues exactly as
    the straight run does; a checkpoint whose lr is a float (a float-lr
    optimizer's) is read into the lr tensor too."""
    _, cfg = TPT.configs("NACF", learning_rate=3e-3)
    rng = np.random.RandomState(1)
    init = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))]
    grads = [torch.from_numpy(rng.randn(4, 3).astype(np.float32)) for _ in range(4)]

    def run(opt, params, gs, lr):
        for g in gs:
            optim.set_learning_rate(opt, lr)
            params[0].grad = g.clone()
            optim.step(cfg, opt)

    straight = [torch.nn.Parameter(init[0].clone())]
    sopt = optim.make_optimizer(cfg, straight)
    run(sopt, straight, grads, 2e-3)

    first = [torch.nn.Parameter(init[0].clone())]
    fopt = optim.make_optimizer(cfg, first)
    run(fopt, first, grads[:2], 2e-3)
    save_checkpoint({"opt_state": fopt.state_dict(), "params": {}}, str(tmp_path), "s.ckpt")
    saved = load_checkpoint(str(tmp_path / "s.ckpt"))["opt_state"]
    assert isinstance(saved["param_groups"][0]["lr"], np.ndarray)

    resumed = [torch.nn.Parameter(first[0].detach().clone())]
    ropt = optim.make_optimizer(cfg, resumed)
    lr_t = ropt.param_groups[0]["lr"]
    ropt.load_state_dict(to_torch(copy.deepcopy(saved)))
    assert ropt.param_groups[0]["lr"] is lr_t and float(lr_t) == pytest.approx(2e-3)
    assert ropt.param_groups[0]["capturable"] is False
    run(ropt, resumed, grads[2:], 2e-3)
    assert torch.equal(resumed[0], straight[0])

    fl = [torch.nn.Parameter(first[0].detach().clone())]
    flopt = _float_lr_reference(cfg, fl)
    fl[0].grad = grads[0].clone()
    flopt.param_groups[0]["lr"] = 5e-4
    flopt.step()
    save_checkpoint({"opt_state": flopt.state_dict(), "params": {}}, str(tmp_path), "f.ckpt")
    fsaved = load_checkpoint(str(tmp_path / "f.ckpt"))["opt_state"]
    assert type(fsaved["param_groups"][0]["lr"]) is float
    lopt = optim.make_optimizer(cfg, [torch.nn.Parameter(fl[0].detach().clone())])
    lr_t = lopt.param_groups[0]["lr"]
    lopt.load_state_dict(to_torch(fsaved))
    assert lopt.param_groups[0]["lr"] is lr_t and float(lr_t) == pytest.approx(5e-4)


def test_resume_with_a_tensor_lr_is_exact(tmp_path):
    """train_network_all with the optimizer's lr a tensor: 2 ARB epochs
    straight and 1 epoch + resume=True for 1 more give identical parameters
    and optimizer state (dropout 0.1: the dropout generator's state is
    carried too)."""
    over = dict(vocab_size=40, dim_hidden=16, num_attention_heads=2, intermediate_size=32,
                n_frames=4, n_total_frames=10, dim_i=12, dim_m=10, modality="mi",
                max_len=10, batch_size=4, compute_dtype="float32", epochs=2,
                hidden_dropout_prob=0.1, encoder_dropout=0.1, use_pallas=True,
                scope="t", no_test=True, base_checkpoint_path=str(tmp_path))
    cfg = default_config("ARB", dataset="MSVD", **over)
    corpus, refs = make_synthetic_corpus(cfg, n_videos=10, n_caps=2, vocab_size=40)
    data = dict(info_corpus=corpus, references=refs,
                in_memory_feats=make_synthetic_feats(cfg, n_videos=10, n_total_frames=10))
    straight = train_network_all(cfg, workdir=str(tmp_path / "a"), verbose=False,
                                 device="cpu", **data)
    train_network_all(cfg.replace(epochs=1), workdir=str(tmp_path / "b"), verbose=False,
                      device="cpu", **data)
    ckpt = load_checkpoint(str(tmp_path / "b" / "checkpoint.ckpt"))
    assert isinstance(ckpt["opt_state"]["param_groups"][0]["lr"], np.ndarray)
    resumed = train_network_all(cfg, workdir=str(tmp_path / "b"), verbose=False,
                                device="cpu", resume=True, **data)
    assert len(resumed["history"]) == 1 and resumed["history"][0]["epoch"] == 1
    a = jax.tree_util.tree_leaves(export_flax_variables(straight["model"]))
    b = jax.tree_util.tree_leaves(export_flax_variables(resumed["model"]))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    sa, sb = (r["state"].optimizer for r in (straight, resumed))
    assert torch.is_tensor(sb.param_groups[0]["lr"])
    assert torch.equal(sa.param_groups[0]["lr"], sb.param_groups[0]["lr"])
    for i, st in sa.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb.state_dict()["state"][i][k]), (i, k)


def test_reload_hook_drops_graphs_and_holds_the_step_weakly():
    """An optimizer reload clears the step's graphs; the hook neither keeps
    them alive nor outlives them."""
    _, cfg = TPT.configs("NACF")
    opt = optim.make_optimizer(cfg, [torch.nn.Parameter(torch.ones(3))])
    hooks = opt._optimizer_load_state_dict_post_hooks
    n = len(hooks)
    jitted = graphs.Jitted(lambda x: x)
    train_step._drop_graphs_on_reload(opt, jitted)
    assert len(hooks) == n + 1
    jitted.graphs["sig"] = object()
    opt.load_state_dict(opt.state_dict())
    assert not jitted.graphs
    ref = weakref.ref(jitted)
    del jitted
    gc.collect()
    assert ref() is None and len(hooks) == n
    opt.load_state_dict(opt.state_dict())


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_trace_behaves_as_navc_tpu(tmp_path):
    """A falsy logdir is a no-op on both sides; a directory gets the
    block's trace (the port's as TensorBoard's ``*.pt.trace.json``)."""
    for mod in (summary, jax_summary):
        for logdir in (None, ""):
            with mod.trace(logdir):
                pass
    with summary.trace(str(tmp_path / "port")):
        torch.ones(3).sum()
    files = [f for _, _, fs in os.walk(tmp_path / "port") for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files
    with jax_summary.trace(str(tmp_path / "jax")):
        jax.numpy.ones(3).sum().block_until_ready()
    assert any(fs for _, _, fs in os.walk(tmp_path / "jax"))
