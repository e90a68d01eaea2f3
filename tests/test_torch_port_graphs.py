"""The port's ``jit=`` (navc_tpu's compiled decode) on the CPU.

On the card ``jit=True`` captures the encode, the mp decode and the beam
search's blocks as CUDA graphs (``navc_tpu_torch/runtime/graphs.py``; the
replays are tested in tests/test_torch_port_cuda.py). Here, on the CPU:

  * the factories carry ``jit`` where navc_tpu's do, with its default;
  * the blocked beam schedule (``graphs.lagged_blocks``, which the card's graphs
    follow too) stops one block late and gives float32 tokens IDENTICAL to
    navc_tpu's ``jax.jit`` decode, which stops its ``while_loop`` exactly,
    at block sizes 1 and DONE_LAG, on weights whose large EOS bias finishes
    every instance well before max_len, so that the steps past the exact
    stop really run;
  * the graph-cache key tells widths, dtypes, devices, ``None``-ness and
    non-tensor values apart and nothing else;
  * a capture's launch counts are taken out of ``_build.LAUNCHES`` and
    added back per replay;
  * ``jit=True`` on CPU tensors returns what ``jit=False`` returns (NACF
    mp, NACF collect, ARB) and says which route it takes on the card.

Run: ``python -m pytest tests/test_torch_port_graphs.py -q``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_ar_generator as jax_make_ar_generator
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.runtime.train_step import make_encode_fn as jax_make_encode_fn
from navc_tpu_torch import constants as C
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
from navc_tpu_torch.decoding.beam import DONE_LAG, block_spans
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops import _build
from navc_tpu_torch.runtime import graphs
from navc_tpu_torch.runtime.serving import make_encode_fn

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi")
EOS_BIAS = 11.0  # every instance of the ARB case below is done after step 11


@pytest.mark.parametrize("port,ref", [
    (make_nar_generator, jax_make_nar_generator),
    (make_ar_generator, jax_make_ar_generator),
    (make_encode_fn, jax_make_encode_fn)], ids=["nar", "ar", "encode"])
def test_factories_carry_jit_where_navc_tpu_does(port, ref):
    """navc_tpu's parameters, in its order and with its defaults, come
    first; ``jit`` defaults to True (navc_tpu's encode is always jitted);
    what the port adds is keyword-only."""
    mine = list(inspect.signature(port).parameters.values())
    theirs = list(inspect.signature(ref).parameters.values())
    if "jit" not in [p.name for p in theirs]:
        theirs.append(inspect.Parameter("jit", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                        default=True, annotation=bool))
    assert [(p.name, p.default) for p in mine[:len(theirs)]] == [
        (p.name, p.default) for p in theirs]
    assert mine[[p.name for p in mine].index("jit")].default is True
    assert all(p.kind == p.KEYWORD_ONLY for p in mine[len(theirs):])


# ---------------------------------------------------------------------------
# the blocked beam schedule against navc_tpu's exact early exit
# ---------------------------------------------------------------------------

def _arb_models(eos_bias=None, **kw):
    over = dict(TOY, **kw)
    jcfg = jax_default_config("ARB", dataset="MSRVTT", **over)
    cfg = default_config("ARB", dataset="MSRVTT", **over)
    jmodel = jax_build_model(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, init_params(jmodel, jax.random.PRNGKey(1), jcfg))
    if eos_bias is not None:
        bias = np.array(variables["params"]["tgt_word_prj_bias"])
        bias[C.EOS] = eos_bias
        variables["params"]["tgt_word_prj_bias"] = bias
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, cfg, model


def _request(cfg, b, seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, cfg.n_frames, d).astype(np.float32)
             for d in cfg.modality_dims]
    return feats, rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def early_eos():
    """f32 ARB models (tied projection, EOS biased) and one request, with
    navc_tpu's jitted decode of it."""
    jcfg, jmodel, jvars, cfg, model = _arb_models(
        eos_bias=EOS_BIAS, compute_dtype="float32", tie_weights=True)
    feats, cat = _request(cfg, 6, seed=6)
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    ref_hyp, ref_sc = jax_make_ar_generator(jcfg, jmodel, jit=True)(
        jvars, enc_j, jnp.asarray(cat))
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    return cfg, model, enc, torch.from_numpy(cat), np.asarray(ref_hyp), np.asarray(ref_sc)


@pytest.mark.parametrize("block", [1, DONE_LAG])
def test_blocked_beam_tokens_identical_to_navc_tpu(early_eos, block):
    cfg, model, enc, cat, ref_hyp, ref_sc = early_eos
    exact = make_ar_generator(cfg, model, jit=False)  # the CPU reads at once
    want, _ = exact(enc, cat)
    assert exact.steps_run <= (cfg.max_len - 1) // 2  # well before max_len
    gen = make_ar_generator(cfg, model, jit=True, block=block)
    hyp, sc = gen(enc, cat)
    # the stop rule reads block j's flag after block j + 1 ran
    blocks = -(-exact.steps_run // block) + 1
    assert gen.steps_run == min(blocks * block, cfg.max_len - 1) > exact.steps_run
    np.testing.assert_array_equal(hyp.numpy(), ref_hyp)
    np.testing.assert_array_equal(hyp.numpy(), want.numpy())
    np.testing.assert_allclose(sc.numpy(), ref_sc, rtol=1e-6, atol=1e-6)
    assert ((hyp.numpy() == C.EOS).argmax(1) > 0).any()  # not every caption empty


@pytest.mark.parametrize("max_len,block,want", [
    (30, 4, [(1, 5), (5, 9), (9, 13), (13, 17), (17, 21), (21, 25), (25, 29), (29, 30)]),
    (10, 1, [(t, t + 1) for t in range(1, 10)]),
    (5, 8, [(1, 5)])])
def test_block_spans_cover_every_step_once(max_len, block, want):
    assert block_spans(max_len, block) == want


# ---------------------------------------------------------------------------
# the graph cache's key and launch counts
# ---------------------------------------------------------------------------

def _args(b=4, dtype=torch.float32, cat=True, n=5):
    enc = {"enc_output": torch.zeros(b, 8, 16, dtype=dtype),
           "pred_length": torch.zeros(b, 30)}
    return ((enc, torch.zeros(b, 1, dtype=torch.int64) if cat else None, n), {})


@pytest.mark.parametrize("other,same", [
    (_args(), True),
    (((({"enc_output": torch.ones(4, 8, 16), "pred_length": torch.ones(4, 30)},
        torch.ones(4, 1, dtype=torch.int64), 5), {})), True),
    (_args(b=5), False),
    (_args(dtype=torch.bfloat16), False),
    (_args(cat=False), False),
    (_args(n=6), False),
    (((_args()[0][0], _args()[0][1]), {"n": 5}), False)],
    ids=["equal", "other-values", "width", "dtype", "none", "non-tensor", "keyword"])
def test_graph_key_tells_signatures_apart(other, same):
    key, leaves = graphs.signature(_args())
    other_key, _ = graphs.signature(other)
    assert (key == other_key) is same
    assert hash(key) == hash(graphs.signature(_args())[0])
    assert sum(isinstance(x, torch.Tensor) for x in leaves) == 3
    assert not graphs.on_cuda(leaves)


def test_graph_key_round_trips_and_clones():
    args = _args()
    key, leaves = graphs.signature(args)
    back = graphs._unflatten(key[0], iter(leaves))
    assert back[0][0]["enc_output"] is args[0][0]["enc_output"] and back[0][2] == 5
    copy = graphs.clone_tensors(args)
    assert copy[0][1] is not args[0][1] and torch.equal(copy[0][1], args[0][1])
    assert copy[0][0]["pred_length"].data_ptr() != args[0][0]["pred_length"].data_ptr()


def test_capture_counts_go_to_replays():
    _build.reset_launches()
    _build.LAUNCHES["project_argmax"] = 2
    with _build.capture_launches() as counts:
        _build.LAUNCHES["project_argmax"] += 6
        _build.LAUNCHES["fused_layer"] += 3
    assert counts == {"project_argmax": 6, "fused_layer": 3}
    assert _build.LAUNCHES["project_argmax"] == 2 and _build.LAUNCHES["fused_layer"] == 0
    for _ in range(3):
        _build.add_launches(counts)
    assert _build.LAUNCHES["project_argmax"] == 20 and _build.LAUNCHES["fused_layer"] == 9
    _build.reset_launches()


# ---------------------------------------------------------------------------
# jit=True on CPU tensors: the eager numbers
# ---------------------------------------------------------------------------

def _nacf(**kw):
    cfg = default_config("NACF", dataset="MSRVTT", max_len=10, use_pallas=True,
                         **dict(TOY, **kw))
    tcfg = default_config("ARB", dataset="MSRVTT", max_len=10, use_pallas=True, **TOY)
    g = torch.Generator().manual_seed(0)
    return (cfg, build_model(cfg, device="cpu", generator=g), tcfg,
            build_model(tcfg, device="cpu", generator=g))


@pytest.mark.parametrize("case", ["mp", "collect", "arb", "l2r", "ef"])
def test_jit_on_the_cpu_returns_the_eager_result(case):
    cfg, model, tcfg, teacher = _nacf(**(dict(paradigm=case, q=1, q_iterations=1)
                                         if case in ("l2r", "ef") else {}))
    feats, cat = _request(cfg, 3, seed=4)
    tf = [torch.from_numpy(f) for f in feats]
    cat = torch.from_numpy(cat)
    if case == "arb":
        model = teacher
    enc = make_encode_fn(cfg, model)(tf)
    assert isinstance(make_encode_fn(cfg, model), graphs.Jitted)
    with torch.no_grad():
        for k, v in model.encode(tf).items():
            assert torch.equal(enc[k], v)
    if case == "arb":
        gens = [make_ar_generator(tcfg, teacher, jit=j) for j in (True, False)]
        outs = [g(enc, cat) for g in gens]
        assert gens[0].graphed and not gens[1].graphed
    else:
        tenc = teacher.encode(tf)
        gens = [make_nar_generator(cfg, model, teacher, jit=j, collect=case == "collect")
                for j in (True, False)]
        outs = [g(enc, cat, tenc) for g in gens]
        assert gens[0].graphed and not gens[1].graphed  # every paradigm is compiled
    flat = [[], []]
    for out, leaves in zip(outs, flat):
        graphs._flatten(out, leaves)
    assert len(flat[0]) == len(flat[1]) > 0
    for a, b in zip(*flat):
        assert torch.equal(a, b)
