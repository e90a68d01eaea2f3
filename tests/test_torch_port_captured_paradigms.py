"""The port's compiled l2r and ef decodes and its full-prefix ARB route vs
navc_tpu, on the CPU.

``make_nar_generator(..., jit=True)`` runs on the CPU the formulation the
card captures (``runtime/graphs.py``): l2r's ceil(L / q) reveal rounds each
under ``graphs.when`` on whether it reveals anything, ef's rounds in blocks
under ``graphs.when`` on navc_tpu's while-loop condition, the blocks ended
by the lagged stop rule (``graphs.lagged_blocks``); here ``when`` runs every
body and merges. Same flax weights (bridged by navc_tpu_torch.convert),
same seeded numpy features, toy sizes (d 16, 2 heads, vocab 40, max_len
10), float32:

  * l2r (CT on and off, q 1, 2, 3) and ef (CT on and off, q 1, 2; with an
    ARB teacher and a student -> teacher ``dict_mapping``): tokens
    IDENTICAL to navc_tpu's jitted ``make_nar_generator``, and the reveal
    rounds of the compiled ef those of the eager one;
  * ef with a model that predicts <mask> into a revealed slot runs past
    ceil(L / q) rounds, at blocks of 1, 2 and 4 rounds: tokens identical
    to navc_tpu's ``_easy_first`` (log-probs within 1e-6), the stop round,
    the blocks run and the flag reads asserted;
  * the beam search under ``NAVC_NO_KVCACHE=1`` (the full-prefix step,
    both packages on their plain route on the CPU): tokens identical to
    navc_tpu's under the same switch, scores within 1e-6 (relative or
    absolute, as tests/test_torch_port_beam.py holds the plain route);
  * the beam step's K1 call (``prefix_hidden`` with ``static=``, its plain
    version here) within K1's 5e-2 of navc_tpu's
    ``fused_nar_decoder_layer(..., causal=True, static=..., interpret=True)``
    on the same operands;
  * teacher-forced, that call plus the projection gives the log-probs of
    the model's own forward (the CPU beam's route) within 5e-2 at every
    position a beam step projects, and a ``static`` without its position
    rows does not;
  * ``when``'s merge, ``_build.Launches``' deferred counts (settled by
    every read, by no count), a graph's counter arithmetic,
    the lagged stop rule on an open-ended loop and the blocks' cap
    (``graphs.lagged_blocks``: an error for ef's open-ended loop, the end
    of the beam's).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_ar_generator as jax_make_ar_generator
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.decoding.mask_predict import _easy_first as jax_easy_first
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.ops.fused_layer import fused_nar_decoder_layer, layer_weights_from_params
from navc_tpu_torch import constants as C
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
from navc_tpu_torch.decoding.beam import prefix_hidden, prefix_static
from navc_tpu_torch.decoding.length_beam import enlarge
from navc_tpu_torch.decoding.mask_predict import (EF_BLOCK, _easy_first, _EasyFirst,
                                                  ef_block_cap)
from navc_tpu_torch.decoding.operands import KernelOperands
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops import _build
from navc_tpu_torch.ops.eligibility import kv_cached_beam_eligible
from navc_tpu_torch.runtime import graphs

TOY = dict(vocab_size=40, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi")
MAX_LEN = 10  # set after the dataset's defaults (MSRVTT's is 30)
F32 = dict(compute_dtype="float32")
HID_TOL = 5e-2  # K1's: a float32 sum-order flip of one bf16 rounding
PREFIX_LOGP_TOL = 5e-2  # K1's bf16 roundings against the forward's, through the projection

_VARIABLES = {}


def _models(method, seed, dim_hidden=TOY["dim_hidden"], **kw):
    """Both packages' models with the same weights; ``kw`` replaces config
    fields after the method's defaults."""
    over = dict(TOY, dim_hidden=dim_hidden)
    jcfg = jax_default_config(method, dataset="MSRVTT", **over).replace(max_len=MAX_LEN, **kw)
    cfg = default_config(method, dataset="MSRVTT", **over).replace(max_len=MAX_LEN, **kw)
    assert cfg.to_dict() == jcfg.to_dict()
    jmodel = jax_build_model(jcfg)
    key = (method, seed, cfg.dim_hidden, cfg.with_category)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax.tree_util.tree_map(
            np.asarray, init_params(jmodel, jax.random.PRNGKey(seed), jcfg))
    variables = _VARIABLES[key]
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, cfg, model


def _inputs(cfg, b, seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, cfg.n_frames, d).astype(np.float32) for d in cfg.modality_dims]
    return feats, rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32)


def _id_permutation(seed):
    """A student->teacher vocab map that keeps the special tokens."""
    perm = np.arange(TOY["vocab_size"], dtype=np.int32)
    perm[6:] = 6 + np.random.RandomState(seed).permutation(TOY["vocab_size"] - 6)
    return perm


def _decode_both_jitted(student, teacher, feats, cat, dict_mapping=None):
    """navc_tpu's jitted generator and the port's compiled one (and its
    eager one, for the rounds) on the same inputs."""
    jcfg, jmodel, jvars, cfg, model = student
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        enc = model.encode(tf)
    targs, jtargs = (None, None), (None, None)
    if teacher is not None:
        _, tjmodel, tjvars, _, tmodel = teacher
        jtargs = (tjvars, tjmodel.apply(tjvars, feats, method=lambda m, f: m.encode(f)))
        with torch.no_grad():
            targs = (tmodel, tmodel.encode(tf))
    gen_j = jax_make_nar_generator(jcfg, jmodel, None if teacher is None else tjmodel,
                                   jit=True)
    ref = gen_j(jvars, enc_j, cat, jtargs[0], jtargs[1], dict_mapping)
    dm = None if dict_mapping is None else torch.from_numpy(dict_mapping)
    gens = {jit: make_nar_generator(cfg, model, targs[0], jit=jit) for jit in (True, False)}
    outs = {jit: g(enc, torch.from_numpy(cat), targs[1], dm) for jit, g in gens.items()}
    return outs, gens, np.asarray(ref)


@pytest.mark.parametrize("q", [1, 2, 3])
@pytest.mark.parametrize("use_ct", [False, True], ids=["no-ct", "ct"])
def test_compiled_left2right_f32_identical_to_navc_tpu_jit(use_ct, q):
    student = _models("NACF", 0, paradigm="l2r", use_ct=use_ct, q=q, q_iterations=1, **F32)
    feats, cat = _inputs(student[3], 3, seed=5)
    outs, gens, ref = _decode_both_jitted(student, None, feats, cat)
    assert gens[True].graphed and not gens[False].graphed
    assert outs[True].dtype == torch.int32 and outs[True].shape == (3, MAX_LEN)
    np.testing.assert_array_equal(outs[True].numpy(), ref)
    np.testing.assert_array_equal(outs[True].numpy(), outs[False].numpy())


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("use_ct", [False, True], ids=["no-ct", "ct"])
def test_compiled_easy_first_f32_identical_to_navc_tpu_jit(use_ct, q):
    student = _models("NACF", 0, paradigm="ef", use_ct=use_ct, q=q, q_iterations=1,
                      no_candidate_decision=False, **F32)
    teacher = _models("ARB", 1, **F32)
    feats, cat = _inputs(student[3], 4, seed=7)
    outs, gens, ref = _decode_both_jitted(student, teacher, feats, cat,
                                          dict_mapping=_id_permutation(2))
    gen = gens[True]
    assert gen.graphed and not gens[False].graphed
    np.testing.assert_array_equal(outs[True].numpy(), ref)
    np.testing.assert_array_equal(outs[True].numpy(), outs[False].numpy())
    rounds = int(gen.rounds)
    assert rounds == gens[False].rounds
    first_done = max(math.ceil(rounds / EF_BLOCK), 1) - 1  # the block its flag says done
    assert gen.blocks_run == first_done + 2 and gen.flag_reads == first_done + 1
    assert gen.blocks_run <= ef_block_cap(MAX_LEN, EF_BLOCK)


def _rigged_canvas():
    """A canvas and a predict that re-predicts <mask> into slot 0 with the
    highest confidence (tests/test_torch_port_paradigms.py's rig)."""
    max_len = MAX_LEN
    lengths = np.asarray([max_len - 1, 5, max_len - 1], np.int32)
    pad_mask = np.arange(max_len)[None, :] >= lengths[:, None]
    tokens = np.where(pad_mask, C.PAD, C.MASK).astype(np.int32)
    cols = np.arange(max_len)
    ids_row = np.where(cols == 0, C.MASK, 6 + cols).astype(np.int32)
    probs_row = np.where(cols == 0, 0.9, 0.5 / (cols + 1.0)).astype(np.float32)

    def rig(lib, asarray):
        return lambda t: (lib.broadcast_to(asarray(ids_row), (t.shape[0], max_len)),
                          lib.broadcast_to(asarray(probs_row), (t.shape[0], max_len)))
    return tokens, pad_mask, lengths, rig


@pytest.mark.parametrize("block", [1, 2, 4])
def test_compiled_easy_first_runs_past_ceil_l_over_q_in_blocks(block):
    kw = dict(max_len=MAX_LEN, paradigm="ef", q=2, q_iterations=0, use_ct=False)
    cfg = default_config("NAB", dataset="MSRVTT", **TOY).replace(**kw)
    jcfg = jax_default_config("NAB", dataset="MSRVTT", **TOY).replace(**kw)
    tokens, pad_mask, lengths, rig = _rigged_canvas()
    predict = rig(torch, torch.from_numpy)
    args = (predict, None, torch.from_numpy(tokens), torch.from_numpy(pad_mask),
            torch.from_numpy(lengths))

    run = _EasyFirst(lambda: args + (3,),
                     lambda hyp, lprobs, lens, bsz: ((hyp, lprobs), None), cfg, block, (), {})
    ((toks, lprobs), rounds), blocks, reads = graphs.run_loop(run)
    stats = {}
    etoks, _ = _easy_first(*args, cfg, stats=stats)
    jtoks, jlprobs = jax_easy_first(rig(jnp, jnp.asarray), None, jnp.asarray(tokens),
                                    jnp.asarray(pad_mask), jnp.asarray(lengths), jcfg)
    assert (toks.numpy()[:, 0] == C.MASK).all()
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(toks.numpy(), etoks.numpy())
    np.testing.assert_allclose(lprobs.numpy(), np.asarray(jlprobs), rtol=0, atol=1e-6)
    # rows 0 and 2 reveal one slot a round for 8 rounds (slot 0 comes back
    # <mask>), then one round finds every row stalled: 9 rounds, past
    # ceil(10 / 2) = 5, and the stop rule reads the flag of the block that
    # ran the last of them after one block more
    assert int(rounds) == stats["rounds"] == 9 > math.ceil(MAX_LEN / cfg.q)
    assert blocks == math.ceil(9 / block) + 1 and reads == blocks - 1
    assert blocks <= run.n_blocks == ef_block_cap(MAX_LEN, block)


def test_ef_blocks_refuse_a_loop_past_its_cap():
    """Blocks whose flag never says done: the cap ends an open-ended loop
    (ef's) with an error (a go without the stall term would loop for
    ever), and a bounded one (the beam's) at its last block."""
    queued = []

    def run_block(j):
        queued.append(j)
        return torch.tensor(False)
    with pytest.raises(RuntimeError, match="did not stop within 5 blocks"):
        graphs.lagged_blocks(run_block, 5, None, open_ended=True)
    assert queued == [0, 1, 2, 3, 4]
    assert graphs.lagged_blocks(run_block, 5, None, open_ended=False) == (5, 4)
    blocks, reads = graphs.lagged_blocks(lambda j: torch.tensor(j >= 2), 5, None, True)
    assert (blocks, reads) == (4, 3)  # block 2's flag read after block 3 ran


@pytest.mark.parametrize("canvas,block,cap", [(10, 1, 12), (10, 4, 4), (32, 4, 10),
                                              (32, 1, 34), (8, 2, 6)])
def test_ef_block_cap(canvas, block, cap):
    assert ef_block_cap(canvas, block) == cap


def test_compiled_generators_report_graphed_and_refuse_collect():
    *_, cfg, model = _models("NACF", 0, **F32)
    for paradigm in ("mp", "l2r", "ef"):
        gen = make_nar_generator(cfg.replace(paradigm=paradigm), model)
        assert gen.graphed
        assert not make_nar_generator(cfg.replace(paradigm=paradigm), model,
                                      jit=False).graphed
    for paradigm in ("l2r", "ef"):
        with pytest.raises(NotImplementedError):
            make_nar_generator(cfg.replace(paradigm=paradigm), model, collect=True)


# ---------------------------------------------------------------------------
# the full-prefix ARB route (NAVC_NO_KVCACHE)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(beam_size=3, use_pallas=True)],
                         ids=["default", "beam3-use_pallas"])
def test_full_prefix_beam_identical_to_navc_tpu_under_no_kvcache(kw, monkeypatch):
    monkeypatch.setenv("NAVC_NO_KVCACHE", "1")
    jcfg, jmodel, jvars, cfg, model = _models("ARB", 1, **kw, **F32)
    assert not kv_cached_beam_eligible(cfg)
    feats, cat = _inputs(cfg, 5, seed=9)
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    ref_hyp, ref_sc = jax_make_ar_generator(jcfg, jmodel, jit=True)(
        jvars, enc_j, jnp.asarray(cat))
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    for jit in (True, False):
        hyp, sc = make_ar_generator(cfg, model, jit=jit)(enc, torch.from_numpy(cat))
        np.testing.assert_array_equal(hyp.numpy(), np.asarray(ref_hyp))
        np.testing.assert_allclose(sc.numpy(), np.asarray(ref_sc), rtol=1e-6, atol=1e-6)


def _teacher_forced(cfg, model, enc, cat, seqs, through_k1, **edit):
    """Log-probs (N, L, V) of every prefix position of ``seqs`` (N = B x
    beam rows), the full-prefix step's arithmetic: K1 (``prefix_hidden``,
    its operands with ``edit``'s fields replaced) or the model's own
    forward, then the projection and log-softmax."""
    k = seqs.shape[0] // enc.shape[0]
    cat_tiled = enlarge(cat, k)
    with torch.no_grad():
        if through_k1:
            ops = dataclasses.replace(KernelOperands.of(model), **edit)
            static = prefix_static(ops, seqs.shape[0], seqs.shape[1],
                                   cat_tiled if cfg.with_category else None)
            hidden = prefix_hidden(ops, seqs, static, *ops.cross_kv(enc, k))
        else:
            hidden, _ = model.decode(seqs, enlarge(enc, k), cat_tiled, "ARFormer")
        return torch.log_softmax(model.project(hidden).float(), -1)


@pytest.mark.parametrize("with_category", [True, False])
def test_prefix_step_teacher_forced_log_probs_match_the_forward(with_category, monkeypatch):
    """The full-prefix step's K1 arithmetic (its plain version here) gives
    the log-probs of the model's own forward (navc_tpu's CPU route, which
    the CPU beam takes: no K1 call) on the same prefixes within
    PREFIX_LOGP_TOL, and a ``static`` without its position rows does
    not."""
    import navc_tpu_torch.decoding.beam as beam

    monkeypatch.setenv("NAVC_NO_KVCACHE", "1")
    *_, cfg, model = _models("ARB", 1, dim_hidden=128, use_pallas=True,
                             with_category=with_category)
    feats, cat = _inputs(cfg, 3, seed=19)
    cat = torch.from_numpy(cat)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    calls, fused = [], beam.fused_layer
    monkeypatch.setattr(beam, "fused_layer",
                        lambda *a, **kw: (calls.append(kw["causal"]), fused(*a, **kw))[1])
    hyp, _ = make_ar_generator(cfg, model, jit=False)(enc, cat)
    assert calls == []  # navc_tpu's CPU route: the model's own forward
    rng = np.random.RandomState(23)
    seqs = np.full((3 * cfg.beam_size, MAX_LEN), C.PAD, np.int32)
    seqs[:, 1:] = rng.randint(C.NUM_SPECIAL_TOKENS, cfg.vocab_size, (len(seqs), MAX_LEN - 1))
    seqs[::cfg.beam_size, 1:] = hyp.numpy()  # each video's own hypothesis first
    seqs[:, 0] = C.BOS
    upto = rng.randint(2, MAX_LEN + 1, len(seqs))
    seqs[np.arange(MAX_LEN)[None, :] >= upto[:, None]] = C.PAD
    seqs = torch.from_numpy(seqs)
    enc = enc["enc_output"]
    k1 = _teacher_forced(cfg, model, enc, cat, seqs, True)
    forward = _teacher_forced(cfg, model, enc, cat, seqs, False)
    valid = seqs != C.PAD  # the positions a beam step projects
    gap = float((k1 - forward).abs()[valid].max())
    assert gap <= PREFIX_LOGP_TOL, "max |log p| gap %.3g" % gap
    pos = model.decoder.embedding.position_embeddings.weight
    broken = _teacher_forced(cfg, model, enc, cat, seqs, True,  # no position rows
                             pos_table=torch.zeros_like(pos, dtype=torch.float32))
    assert float((broken - forward).abs()[valid].max()) > 4 * PREFIX_LOGP_TOL


def test_no_kvcache_switch_reads_the_environment(monkeypatch):
    cfg = default_config("ARB", dataset="MSRVTT", **TOY)
    monkeypatch.delenv("NAVC_NO_KVCACHE", raising=False)
    assert kv_cached_beam_eligible(cfg)
    monkeypatch.setenv("NAVC_NO_KVCACHE", "")
    assert kv_cached_beam_eligible(cfg)
    monkeypatch.setenv("NAVC_NO_KVCACHE", "1")
    assert not kv_cached_beam_eligible(cfg)


@pytest.mark.parametrize("with_category", [True, False])
def test_prefix_step_k1_matches_interpret_pallas(with_category):
    """The beam step's K1 operands (raw bf16 word rows, ``static`` = the
    position rows + the category row, PAD keys, cross K/V hoisted from the
    encoder output) through the plain version, against navc_tpu's causal
    kernel with ``static=`` in interpret mode on the same prefix."""
    jcfg, jmodel, jvars, cfg, model = _models("ARB", 1, dim_hidden=128, use_pallas=True,
                                              with_category=with_category)
    b, k, l = 2, 3, MAX_LEN
    n = b * k
    feats, cat = _inputs(cfg, b, seed=13)
    rng = np.random.RandomState(17)
    seqs = rng.randint(C.NUM_SPECIAL_TOKENS, cfg.vocab_size, (n, l)).astype(np.int32)
    seqs[:, 0] = C.BOS
    upto = rng.randint(2, l + 1, n)  # each row's written prefix; PAD after it
    seqs[np.arange(l)[None, :] >= upto[:, None]] = C.PAD
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])["enc_output"]
    ops = KernelOperands.of(model)
    cat_tiled = enlarge(torch.from_numpy(cat), k) if with_category else None
    static = prefix_static(ops, n, l, cat_tiled)
    ke, ve = ops.cross_kv(enc, k)
    got = prefix_hidden(ops, torch.from_numpy(seqs), static, ke, ve)
    assert got.dtype == torch.float32 and got.shape == (n, l, cfg.dim_hidden)

    emb = jvars["params"]["decoder"]["embedding"]
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))["enc_output"]
    jstatic = np.broadcast_to(np.asarray(emb["position_embeddings"]["embedding"])[None, :l],
                              (n, l, cfg.dim_hidden))
    if with_category:
        jstatic = jstatic + np.asarray(emb["category_embeddings"]["embedding"])[
            np.repeat(cat[:, 0], k)][:, None, :]
    want = fused_nar_decoder_layer(
        jnp.asarray(emb["word_embeddings"]["embedding"])[seqs], jnp.repeat(enc_j, k, axis=0),
        jnp.asarray(seqs == C.PAD),
        layer_weights_from_params(jvars["params"]["decoder"]["layer_0"]),
        n_head=cfg.num_attention_heads, tb=4, causal=True, static=jnp.asarray(jstatic),
        ln_scale=emb["LayerNorm"]["scale"], ln_bias=emb["LayerNorm"]["bias"],
        ln_eps=cfg.layer_norm_eps, interpret=True)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= HID_TOL, "max |K1 - navc_tpu| %.3g" % err
    assert float(np.abs(np.asarray(want)).max()) > 10 * HID_TOL  # not all near zero


# ---------------------------------------------------------------------------
# when, the deferred launch counts, lagged_blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pred", [True, False])
def test_when_merges_the_body_outside_a_capture(pred):
    """Outside a capture ``when`` runs the body and keeps its results where
    the predicate holds: the bits of ``lax.cond``, with every body run."""
    calls = []
    toks = torch.arange(12, dtype=torch.int32).view(3, 4)
    probs = torch.linspace(0, 1, 12).view(3, 4)

    def body(t, p):
        calls.append(1)
        return t * 2 + 1, p.sqrt()
    out = graphs.when(torch.tensor(pred), body, (toks, probs))
    want = body(toks, probs) if pred else (toks, probs)
    assert len(calls) == 1 + pred
    assert [o.dtype for o in out] == [torch.int32, torch.float32]
    assert all(torch.equal(o, w) for o, w in zip(out, want))


def test_launches_settle_deferred_counts_on_every_read():
    launches = _build.Launches({"a": 1, "b": 0})
    launches.defer("g", lambda: {"a": 5})
    launches.defer("g", lambda: {"a": 2, "b": 1})  # the later deferral replaces it
    launches.add({"b": 10})  # a replay's own counts: no settling
    assert dict.__getitem__(launches, "a") == 1 and launches._pending
    assert launches["a"] == 3 and not launches._pending
    launches.defer("h", lambda: {"b": 4})
    assert dict(launches) == {"a": 3, "b": 15}
    for read in (lambda d: list(d.items()), lambda d: list(d.values()), lambda d: d.get("a"),
                 lambda d: list(d), lambda d: list(d.keys())):
        launches.defer("h", lambda: {"a": 1})
        read(launches)
        assert not launches._pending
    assert dict(launches) == {"a": 8, "b": 15}


def test_launches_count_leaves_deferred_counts_pending():
    """A wrapper's count (``Launches.count``) settles nothing: an eager
    launch queued behind a replay does not wait for it."""
    launches = _build.Launches({"a": 0, "b": 0})
    waited = []
    launches.defer("g", lambda: (waited.append(1), {"b": 2})[1])
    launches.count("a")
    launches.count("a", 3)
    assert not waited and launches._pending
    assert dict.__getitem__(launches, "a") == 4
    assert dict(launches) == {"a": 4, "b": 2} and waited == [1]


def test_graph_settles_each_body_by_its_runs():
    """A replay's bodies count what their cumulative device counters say
    since the last settling, times their launches."""
    class Done:
        def synchronize(self):
            pass

    runs = graphs.BodyRuns.__new__(graphs.BodyRuns)  # its pinned buffer needs a card
    runs.launches = [{"fused_layer": 1, "project_argmax": 1}, {"fused_layer": 1}]
    runs.seen = [0, 0]
    runs.host = torch.tensor([3, 1], dtype=torch.int32)
    assert runs.settle(Done()) == {"fused_layer": 4, "project_argmax": 3}
    runs.host = torch.tensor([3, 4], dtype=torch.int32)
    assert runs.settle(Done()) == {"fused_layer": 3, "project_argmax": 0}
    assert runs.seen == [3, 4]


def test_run_blocks_on_an_unbounded_loop_reads_each_flag_one_block_late(monkeypatch):
    """``graphs.lagged_blocks`` on an open-ended loop: block j's flag is
    read after block j + 1 was queued (the readers here record when the
    card's pinned-flag readers would wait), and the loop ends one block
    after the first flag that says done."""
    order = []

    def queue_block(j):
        order.append(("run", j))
        return torch.tensor(j >= 3)

    def reader(done, flags, j):
        return lambda: (order.append(("read", j)), bool(done))[1]
    monkeypatch.setattr(graphs, "flag_reader", reader)
    assert graphs.lagged_blocks(queue_block, 100, None, open_ended=True) == (5, 4)
    assert order == [("run", 0), ("run", 1), ("read", 0), ("run", 2), ("read", 1),
                     ("run", 3), ("read", 2), ("run", 4), ("read", 3)]
    monkeypatch.undo()
    assert graphs.flag_reader(torch.tensor(True), None, 0)() is True
