"""The port's l2r and ef paradigms and mask-predict's collect modes vs
navc_tpu, on the CPU.

Same flax weights (bridged by navc_tpu_torch.convert), same seeded numpy
features and categories, toy sizes (d 16, 2 heads, vocab 40, max_len 10):

  * plain route, float32: tokens IDENTICAL to navc_tpu's
    ``make_nar_generator(jit=False)`` and to ``tests/np_reference.py``;
    the refinement's log-probs within 1e-5 of navc_tpu's (atol, rtol 0);
  * with an ARB teacher and a student -> teacher ``dict_mapping``: tokens
    identical;
  * kernel route (``use_pallas``): the port's plain K1/K3/K4 against
    navc_tpu's interpret-mode Pallas, tokens agreeing on >= 99% of
    positions (the value is in the message);
  * collect: the per-iteration token stacks identical (f32) and the prob
    stacks within 1e-6 (atol, rtol 0), the last iteration the returned
    hypothesis; ``collect_attentions``: the
    layer-0 maps within 1e-5 (atol, rtol 0);
  * ``get_dict_mapping``, ``get_words_with_specified_tags`` and the
    dataset's ``specific`` give what navc_tpu's give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_reference as npref
from navc_tpu import constants as JC
from navc_tpu.config import default_config as jax_default_config
from navc_tpu.data.dataset import VideoDataset as JaxVideoDataset
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.decoding.mask_predict import _easy_first as jax_easy_first
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.runtime import sentence as jax_sentence
from navc_tpu_torch import constants as C
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.data.dataset import VideoDataset
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from navc_tpu_torch.decoding import build_canvas, make_nar_generator, predict_length_beam
from navc_tpu_torch.decoding.length_beam import enlarge
from navc_tpu_torch.decoding.mask_predict import (NARContext, _easy_first, _left2right,
                                                  _predict_fn)
from navc_tpu_torch.models import build_model
from navc_tpu_torch.runtime import sentence

TOY = dict(vocab_size=40, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi")
MAX_LEN = 10  # set after the dataset's defaults (MSRVTT's is 30)
F32 = dict(compute_dtype="float32")
LPROB_TOL = 1e-5
PROB_TOL = 1e-6

_VARIABLES = {}


def _models(method, seed, **kw):
    """Both packages' models with the same weights; ``kw`` replaces config
    fields after the method's defaults (as translate's options do)."""
    jcfg = jax_default_config(method, dataset="MSRVTT", **TOY).replace(
        max_len=MAX_LEN, **kw)
    cfg = default_config(method, dataset="MSRVTT", **TOY).replace(max_len=MAX_LEN, **kw)
    assert cfg.to_dict() == jcfg.to_dict()
    jmodel = jax_build_model(jcfg)
    key = (method, seed)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax.tree_util.tree_map(
            np.asarray, init_params(jmodel, jax.random.PRNGKey(seed), jcfg))
    variables = _VARIABLES[key]
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, cfg, model


def _inputs(cfg, b, seed=3):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, cfg.n_frames, d).astype(np.float32) for d in cfg.modality_dims]
    return feats, rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32)


def _id_permutation(seed):
    """A student->teacher vocab map that keeps the special tokens."""
    perm = np.arange(TOY["vocab_size"], dtype=np.int32)
    perm[6:] = 6 + np.random.RandomState(seed).permutation(TOY["vocab_size"] - 6)
    return perm


def _generate_both(student, teacher, feats, cat, dict_mapping=None, **gen_kw):
    """navc_tpu's generator (jit=False) and the port's on the same inputs."""
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
                                   jit=False, **gen_kw)
    ref = gen_j(jvars, enc_j, cat, jtargs[0], jtargs[1], dict_mapping)
    gen = make_nar_generator(cfg, model, targs[0], **gen_kw)
    out = gen(enc, torch.from_numpy(cat), targs[1],
              None if dict_mapping is None else torch.from_numpy(dict_mapping))
    return out, ref


def _canvas(student, b=2, seed=1):
    """The port's plain predict and a length-beam canvas for the algorithms."""
    _, _, _, cfg, model = student
    feats, cat = _inputs(cfg, b, seed)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    lbs = cfg.length_beam_size
    beam = predict_length_beam(enc["pred_length"], lbs, 0, cfg.max_len)
    tokens, pad_mask, lengths = build_canvas(beam, cfg.max_len)
    ctx = NARContext(enlarge(enc["enc_output"], lbs),
                     enlarge(torch.from_numpy(cat), lbs), None, None, None)
    predict = _predict_fn(cfg, model, None, None, ctx, cfg.max_len, enc["enc_output"])
    return predict, tokens, pad_mask, lengths, (feats, cat)


def _jax_algorithm(student, name, inputs, tokens, pad_mask, lengths):
    from navc_tpu.decoding import mask_predict as jmp

    jcfg, jmodel, jvars, _, _ = student
    feats, cat = inputs
    lbs = jcfg.length_beam_size
    enc = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    ctx = jmp.NARContext(jmp.enlarge(enc["enc_output"], lbs),
                         jmp.enlarge(jnp.asarray(cat), lbs), None, None, None)
    predict = jmp._predict_fn(jmodel, jvars, ctx)
    return jmp.ALGORITHMS[name](predict, None, jnp.asarray(tokens.numpy()),
                                jnp.asarray(pad_mask.numpy()),
                                jnp.asarray(lengths.numpy()), jcfg)


def _np_predict(predict):
    def run(tokens):
        with torch.no_grad():
            ids, probs = predict(torch.from_numpy(np.asarray(tokens, np.int32)))
        return ids.numpy(), probs.numpy().astype(np.float64)
    return run


def _paradigm_case(name, use_ct, q, qi):
    student = _models("NACF", 0, paradigm=name, use_ct=use_ct, q=q, q_iterations=qi,
                      **F32)
    predict, tokens, pad_mask, lengths, inputs = _canvas(student)
    algo = {"l2r": _left2right, "ef": _easy_first}[name]
    with torch.no_grad():
        toks, lprobs = algo(predict, None, tokens, pad_mask, lengths, student[3])
    jtoks, jlprobs = _jax_algorithm(student, name, inputs, tokens, pad_mask, lengths)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(lprobs.numpy(), np.asarray(jlprobs), rtol=0,
                               atol=LPROB_TOL)
    np_algo = {"l2r": npref.np_left2right, "ef": npref.np_easy_first}[name]
    ref_toks, _ = np_algo(_np_predict(predict), None, tokens.numpy().copy(),
                          pad_mask.numpy(), lengths.numpy(), q, qi, use_ct)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)

    feats, cat = _inputs(student[3], 3, seed=5)
    out, ref = _generate_both(student, None, feats, cat)
    assert out.dtype == torch.int32 and out.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("qi", [0, 1])
@pytest.mark.parametrize("use_ct,q", [(False, 1), (False, 2), (True, 2)])
def test_left2right_f32_identical(use_ct, q, qi):
    _paradigm_case("l2r", use_ct, q, qi)


@pytest.mark.parametrize("use_ct,q", [(False, 1), (True, 3)])
def test_easy_first_f32_identical(use_ct, q):
    _paradigm_case("ef", use_ct, q, 1)


def test_easy_first_mask_repredicting_model():
    """A model that predicts <mask> into a revealed slot runs the reveal loop
    past ceil(max_len / q) rounds until the batch-global count stalls; the
    slot stays a literal <mask>, as in navc_tpu and the reference."""
    cfg = default_config("NAB", dataset="MSRVTT", **TOY).replace(
        max_len=MAX_LEN, paradigm="ef", q=2, q_iterations=0, use_ct=False)
    max_len = cfg.max_len
    lengths = np.asarray([max_len - 1, 5, max_len - 1], np.int32)
    pad_mask = np.arange(max_len)[None, :] >= lengths[:, None]
    tokens = np.where(pad_mask, C.PAD, C.MASK).astype(np.int32)
    cols = np.arange(max_len)
    ids_row = np.where(cols == 0, C.MASK, 6 + cols).astype(np.int32)
    probs_row = np.where(cols == 0, 0.9, 0.5 / (cols + 1.0)).astype(np.float32)

    def rig(lib, asarray):
        return lambda t: (lib.broadcast_to(asarray(ids_row), (t.shape[0], max_len)),
                          lib.broadcast_to(asarray(probs_row), (t.shape[0], max_len)))

    toks, lprobs = _easy_first(rig(torch, torch.from_numpy), None,
                               torch.from_numpy(tokens), torch.from_numpy(pad_mask),
                               torch.from_numpy(lengths), cfg)
    jcfg = jax_default_config("NAB", dataset="MSRVTT", **TOY).replace(
        max_len=MAX_LEN, paradigm="ef", q=2, q_iterations=0, use_ct=False)
    jtoks, jlprobs = jax_easy_first(rig(jnp, jnp.asarray), None, jnp.asarray(tokens),
                                    jnp.asarray(pad_mask), jnp.asarray(lengths), jcfg)
    ref_toks, _ = npref.np_easy_first(rig(np, np.asarray), None, tokens.copy(), pad_mask,
                                      lengths, cfg.q, cfg.q_iterations, False)
    assert (toks.numpy()[:, 0] == C.MASK).all()
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_allclose(lprobs.numpy(), np.asarray(jlprobs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("paradigm,kw", [
    ("l2r", dict(use_ct=True, q=1, q_iterations=1, masking_decision=True)),
    ("ef", dict(use_ct=False, q=2, q_iterations=1, no_candidate_decision=False))],
    ids=["l2r-ct-masking_decision", "ef-candidate_decision"])
def test_paradigms_with_teacher_and_dict_mapping(paradigm, kw):
    student = _models("NACF", 0, paradigm=paradigm, **kw, **F32)
    teacher = _models("ARB", 1, **F32)
    feats, cat = _inputs(student[3], 4, seed=7)
    out, ref = _generate_both(student, teacher, feats, cat,
                              dict_mapping=_id_permutation(2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("paradigm,kw", [
    ("l2r", dict(use_ct=True, q=1, q_iterations=1)),
    ("ef", dict(use_ct=False, q=1, q_iterations=1))])
def test_kernel_route_agrees_with_interpret_pallas(paradigm, kw):
    """K1 (NAR and the teacher's causal pass), K3 and K4 on the 8-aligned
    canvas, their plain versions here against navc_tpu's Pallas kernels in
    interpret mode."""
    student = _models("NACF", 0, paradigm=paradigm, use_pallas=True, **kw)
    teacher = _models("ARB", 1, use_pallas=True)
    feats, cat = _inputs(student[3], 4, seed=11)
    out, ref = _generate_both(student, teacher, feats, cat)
    agree = float((out.numpy() == np.asarray(ref)).mean())
    assert agree >= 0.99, "token agreement %.4f" % agree


@pytest.mark.parametrize("iterations", [1, 5])
@pytest.mark.parametrize("use_ct", [False, True])
def test_collect_stacks_identical(use_ct, iterations):
    student = _models("NACF", 0, use_ct=use_ct, iterations=iterations, **F32)
    teacher = _models("ARB", 1, **F32)
    feats, cat = _inputs(student[3], 3, seed=13)
    (best, (toks, probs)), (jbest, (jtoks, jprobs)) = _generate_both(
        student, teacher, feats, cat, collect=True)
    t = iterations + 1 if use_ct else iterations
    assert toks.shape == (3, t, MAX_LEN) and probs.shape == toks.shape
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    # the probs are exp(log_softmax) from torch and from XLA: their last
    # bits differ (a few 1e-8), so they are held to a tolerance
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(toks[:, -1].numpy(), best.numpy())


def test_collect_attentions_within_tolerance():
    """Layer-0 (self, cross) maps of every iteration, (B, T, n_head,
    max_len, L_k), from the plain decoder on the unaligned canvas — here
    with use_pallas set, so the teacher keeps its kernels."""
    student = _models("NACF", 0, use_pallas=True, iterations=3, **F32)
    teacher = _models("ARB", 1, use_pallas=True, **F32)
    feats, cat = _inputs(student[3], 2, seed=17)
    (best, (toks, _), attns), (jbest, (jtoks, _), jattns) = _generate_both(
        student, teacher, feats, cat, collect_attentions=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    t, nh, l = 4, TOY["num_attention_heads"], MAX_LEN
    assert [tuple(a.shape) for a in attns] == [(2, t, nh, l, l),
                                              (2, t, nh, l, 2 * TOY["n_frames"])]
    for a, ja in zip(attns, jattns):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-5)


def test_unknown_paradigm_and_collect_refusals_match_navc_tpu():
    student = _models("NACF", 0, **F32)
    jcfg, jmodel, _, cfg, model = student
    for make, c, m in ((make_nar_generator, cfg, model),
                       (jax_make_nar_generator, jcfg, jmodel)):
        with pytest.raises(ValueError):
            make(c.replace(paradigm="bogus"), m)
        for paradigm in ("l2r", "ef"):
            with pytest.raises(NotImplementedError):
                make(c.replace(paradigm=paradigm), m, collect=True)
            with pytest.raises(NotImplementedError):
                make(c.replace(paradigm=paradigm), m, collect_attentions=True)


def test_get_dict_mapping_matches_navc_tpu():
    cfg = default_config("NACF", dataset="MSRVTT", **TOY)
    tcfg = cfg.replace(vocab_size=TOY["vocab_size"] + 3)
    corpus, _ = make_synthetic_corpus(cfg, n_videos=6, n_caps=2, vocab_size=TOY["vocab_size"])
    itow = corpus["info"]["itow"]
    words = [itow[i] for i in sorted(itow)]
    rng = np.random.RandomState(0)
    # the teacher's vocabulary: the student's words shuffled past the
    # specials, one dropped (-> UNK) and a few of its own
    body = list(rng.permutation(words[6:]))[1:] + ["extra%d" % i for i in range(4)]
    teacher = {"info": {"itow": {i: w for i, w in enumerate(words[:6] + body)}}}
    for t in (tcfg, cfg, None):
        got = sentence.get_dict_mapping(cfg, t, corpus, teacher)
        want = jax_sentence.get_dict_mapping(cfg, t, corpus, teacher)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    mapped = sentence.get_dict_mapping(cfg, tcfg, corpus, teacher)
    assert mapped is not None and (mapped[C.NUM_SPECIAL_TOKENS:] == C.UNK).sum() == 1
    assert sentence.get_dict_mapping(cfg, tcfg, corpus, corpus) is None


def test_get_words_with_specified_tags_matches_navc_tpu(nltk_pos_tagger):
    vocab = {w: i for i, w in enumerate(
        "<pad> a man is riding horse in the field dog runs are <mask>".split())}
    for seq in ("a man is riding a horse in the field", "a dog runs <mask> are field"):
        got, want = set(), set()
        sentence.get_words_with_specified_tags(vocab, seq, got)
        jax_sentence.get_words_with_specified_tags(vocab, seq, want)
        assert got == want
    assert C.pos_tag_mapping == JC.pos_tag_mapping


@pytest.mark.parametrize("mode", ["validate", "test"])
def test_specific_category_matches_navc_tpu(mode):
    cfg = default_config("NACF", dataset="MSRVTT", **TOY)
    jcfg = jax_default_config("NACF", dataset="MSRVTT", **TOY)
    corpus, _ = make_synthetic_corpus(cfg, n_videos=30, n_caps=2, vocab_size=TOY["vocab_size"])
    feats = make_synthetic_feats(cfg, n_videos=30, n_total_frames=8)
    seen = 0
    for specific in [-1] + sorted(corpus["info"]["split_category"][mode]):
        ours = VideoDataset(cfg, mode, corpus, feats, specific=specific)
        theirs = JaxVideoDataset(jcfg, mode, corpus, in_memory_feats=feats,
                                 specific=specific)
        assert [i["vid"] for i in ours.infoset] == [i["vid"] for i in theirs.infoset]
        for k in range(len(ours)):
            a, b = ours[k], theirs[k]
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
        seen += specific >= 0 and len(ours) > 0
    assert seen >= 2
