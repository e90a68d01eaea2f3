"""The port's NACF decode and serving path vs navc_tpu, on the CPU.

Same flax weights (bridged by navc_tpu_torch.convert), same seeded numpy
features and categories:

  * plain route (use_pallas=False, float32): tokens must be IDENTICAL — the
    repo's float32 parity rule;
  * kernel route (use_pallas=True): the port's wrappers run their plain
    versions on CPU tensors, navc_tpu runs its Pallas kernels in interpret
    mode; both round to bf16 at the same points, so tokens must agree on at
    least 99% of positions (the observed value is in the assertion message);
  * StreamingCaptioner returns, in submission order, what direct generator
    calls return;
  * importing the port loads neither jax, flax nor navc_tpu.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.decoding.length_beam import predict_length_beam as jax_plb
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.ops.select import rank_mask_smallest as jax_rank_smallest
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.decoding import make_nar_generator, predict_length_beam
from navc_tpu_torch.decoding.mask_predict import query_index
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops.select import rank_mask_smallest
from navc_tpu_torch.runtime.serving import StreamingCaptioner

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi", max_len=10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_VARIABLES = {}


def _models(method, seed, **kw):
    over = dict(TOY, **kw)
    jcfg = jax_default_config(method, dataset="MSRVTT", **over)
    cfg = default_config(method, dataset="MSRVTT", **over)
    jmodel = jax_build_model(jcfg)
    # the weights depend on the method and the layer count only; initialise
    # each set once per process (flax init traces the whole model)
    key = (method, seed, cfg.num_hidden_layers_decoder)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax.tree_util.tree_map(
            np.asarray, init_params(jmodel, jax.random.PRNGKey(seed), jcfg))
    variables = _VARIABLES[key]
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, cfg, model


def _nacf(**kw):
    """NACF student + ARB teacher, both packages, same weights."""
    return _models("NACF", 0, **kw), _models("ARB", 1, **kw)


def _requests(cfg, n, b, seed=3):
    rng = np.random.RandomState(seed)
    return [([rng.randn(b, cfg.n_frames, d).astype(np.float32)
              for d in cfg.modality_dims],
             rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32))
            for _ in range(n)]


def _decode_both(student, teacher, feats, cat, jit, dict_mapping=None):
    jcfg, jmodel, jvars, cfg, model = student
    tjcfg, tjmodel, tjvars, tcfg, tmodel = teacher
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    tenc_j = tjmodel.apply(tjvars, feats, method=lambda m, f: m.encode(f))
    gen_j = jax_make_nar_generator(jcfg, jmodel, tjmodel, jit=jit)
    ref = np.asarray(gen_j(jvars, enc_j, cat, tjvars, tenc_j, dict_mapping))

    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        enc, tenc = model.encode(tf), tmodel.encode(tf)
    out = make_nar_generator(cfg, model, tmodel)(
        enc, torch.from_numpy(cat), tenc,
        None if dict_mapping is None else torch.from_numpy(dict_mapping))
    return out.numpy(), ref


def _id_permutation(seed):
    """A student->teacher vocab map that keeps the special tokens."""
    perm = np.arange(TOY["vocab_size"], dtype=np.int32)
    rng = np.random.RandomState(seed)
    perm[6:] = 6 + rng.permutation(TOY["vocab_size"] - 6)
    return perm


@pytest.mark.parametrize("kw,mapped", [
    ({}, False), (dict(masking_decision=True, use_ct=False), True)],
    ids=["default", "masking_decision-noct-dict_mapping"])
def test_plain_route_f32_tokens_identical(kw, mapped):
    student, teacher = _nacf(compute_dtype="float32", **kw)
    (feats, cat), = _requests(student[0], 1, 6)
    out, ref = _decode_both(student, teacher, feats, cat, jit=True,
                            dict_mapping=_id_permutation(2) if mapped else None)
    assert out.dtype == np.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kw", [
    {}, dict(num_hidden_layers_decoder=2, compute_dtype="float32")],
    ids=["all-kernels", "vocab-kernels-only"])
def test_kernel_route_agrees_with_interpret_pallas(kw):
    """all-kernels: K1-K4 on the 8-aligned canvas. vocab-kernels-only: two
    decoder layers are outside K1, so the plain decoder feeds K3 and the
    teacher takes the plain route on the max_len canvas. That decoder runs
    in float32: XLA's CPU backend may keep bf16 intermediates in excess
    precision, so a bf16 plain decoder is not rounded at the same points."""
    student, teacher = _nacf(use_pallas=True, **kw)
    (feats, cat), = _requests(student[0], 1, 8, seed=5)
    # the kernels run as Pallas interpret mode op by op (jit=False), the
    # way tests/test_pallas_ops.py runs the fused generator
    out, ref = _decode_both(student, teacher, feats, cat, jit=not kw)
    agree = float((out == ref).mean())
    assert agree >= 0.99, "token agreement %.4f" % agree


def test_sparse_steps_match_dense_steps(monkeypatch):
    """The sparse-query refinement (K2 + scatter) gives the tokens of the
    dense steps (K1 on the full canvas), as in navc_tpu."""
    (_, _, _, cfg, model), (_, _, _, _, tmodel) = _nacf(use_pallas=True)
    (feats, cat), = _requests(cfg, 1, 4, seed=7)
    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        enc, tenc = model.encode(tf), tmodel.encode(tf)
    cat = torch.from_numpy(cat)
    sparse = make_nar_generator(cfg, model, tmodel)(enc, cat, tenc)
    import navc_tpu_torch.decoding.mask_predict as mp
    monkeypatch.setattr(mp, "fused_sparse_eligible", lambda c: False)
    dense = make_nar_generator(cfg, model, tmodel)(enc, cat, tenc)
    np.testing.assert_array_equal(sparse.numpy(), dense.numpy())


def test_streaming_captioner_order_and_values():
    (_, _, _, cfg, model), (_, _, _, tcfg, tmodel) = _nacf(use_pallas=True)
    reqs = _requests(cfg, 4, 2, seed=9)
    gen = make_nar_generator(cfg, model, tmodel)
    direct = []
    for feats, cat in reqs:
        tf = [torch.from_numpy(f) for f in feats]
        with torch.no_grad():
            direct.append(gen(model.encode(tf), torch.from_numpy(cat),
                              tmodel.encode(tf)).numpy())
    for depth in (0, 2):
        cap = StreamingCaptioner(cfg, model, (tcfg, tmodel), depth=depth,
                                 device="cpu")
        tickets, done = [], []
        for feats, cat in reqs:
            t, d = cap.submit(feats, cat)
            tickets.append(t)
            done.extend(d)
            assert len(cap._inflight) <= depth
        done.extend(cap.flush())
        assert [t for t, _ in done] == tickets
        for (_, hyp), ref in zip(done, direct):
            np.testing.assert_array_equal(hyp, ref)


def test_length_beam_and_rank_masks_keep_jax_tie_order():
    rng = np.random.RandomState(0)
    # heavy ties: few distinct values (+ 0.0 turns -0.0 into 0.0, which
    # lax.top_k would order below 0.0)
    pred = (np.round(rng.randn(5, 12), 0) + 0.0).astype(np.float32)
    np.testing.assert_array_equal(
        predict_length_beam(torch.from_numpy(pred), 6, 0, 12).numpy(),
        np.asarray(jax_plb(pred, 6, 0, 12)))
    vals = np.round(rng.rand(5, 12) * 3, 0).astype(np.float32)
    k = rng.randint(1, 12, 5).astype(np.int32)
    np.testing.assert_array_equal(
        rank_mask_smallest(torch.from_numpy(vals), torch.from_numpy(k)).numpy(),
        np.asarray(jax_rank_smallest(vals, k)))


def test_query_index_is_the_one_hot_selection():
    rng = np.random.RandomState(4)
    mask_ind = rng.rand(6, 16) < 0.3
    k = 8
    qidx = query_index(torch.from_numpy(mask_ind), k).numpy()
    ranks = np.cumsum(mask_ind, axis=1) - 1
    sel = (ranks[:, None, :] == np.arange(k)[None, :, None]) & mask_ind[:, None, :]
    np.testing.assert_array_equal(qidx, np.where(sel.any(-1), sel.argmax(-1), -1))


def test_unported_paradigms_raise():
    """Every paradigm is ported; the refusals left are navc_tpu's own: an
    unknown paradigm (ValueError) and collection with l2r or ef, which is
    mask-predict only (NotImplementedError)."""
    cfg = default_config("NACF", dataset="MSRVTT", **TOY)
    model = build_model(cfg, device="cpu")
    for bad in ("bogus", "MP", ""):
        with pytest.raises(ValueError):
            make_nar_generator(cfg.replace(paradigm=bad), model)
    for paradigm in ("l2r", "ef"):
        for kw in (dict(collect=True), dict(collect_attentions=True)):
            with pytest.raises(NotImplementedError):
                make_nar_generator(cfg.replace(paradigm=paradigm), model, **kw)
    for paradigm in ("mp", "l2r", "ef"):  # each builds without a refusal
        make_nar_generator(cfg.replace(paradigm=paradigm), model)
    make_nar_generator(cfg, model, collect=True)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import navc_tpu_torch\n"
        "for m in pkgutil.walk_packages(navc_tpu_torch.__path__, 'navc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        "for name, path in (('chip_smoke', 'chip_smoke.py'),"
        " ('torch_flagship', 'scripts/torch_flagship.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'navc_tpu'))\n"
        "assert not bad, bad\n"
        "train = ('ops.fused_layer_train', 'runtime.train_step', 'runtime.loop',"
        " 'runtime.crit', 'runtime.optim', 'runtime.logger', 'ops.vocab_ce',"
        " 'runtime.evaluate', 'data.loader', 'metrics.scorer', 'cli.train',"
        " 'api', 'cli.translate', 'cli.convert', 'runtime.torch_convert',"
        " 'parallel.mesh', 'parallel.distributed', 'runtime.distributed_loop',"
        " 'models.resnet', 'data.pretreatment')\n"
        "missing = [m for m in train if 'navc_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "import builtins, os\n"
        "from navc_tpu_torch.metrics import meteor15\n"
        "opened, real_open = [], builtins.open\n"
        "builtins.open = lambda f, *a, **k: (opened.append(os.path.abspath(str(f))),"
        " real_open(f, *a, **k))[1]\n"
        "meteor15._DEFAULT = None\n"
        "meteor15.default_scorer()\n"
        "builtins.open = real_open\n"
        "data = os.path.join(os.path.dirname(os.path.abspath(navc_tpu_torch.__file__)),"
        " 'metrics', 'data')\n"
        "tables = [f for f in opened if f.endswith(('.tsv', '.txt'))]\n"
        "assert len(tables) >= 2 and all(os.path.dirname(f) == data for f in tables), opened\n"
        "print('OK', len([n for n in sys.modules if n.startswith('navc_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("OK"), out.stderr
