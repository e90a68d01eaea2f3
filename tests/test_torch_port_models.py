"""Port model stack vs navc_tpu: the weight bridge and the float32 forward.

Same flax weights (converted by navc_tpu_torch.convert) and the same seeded
numpy inputs go through the flax model and the port on the CPU. Tolerance
atol = rtol = 1e-5: both run float32 with the same op order (flax LayerNorm
statistics, flax BN eval formula); what is left is summation order inside
the matmuls and ulp-level differences between XLA's and torch's exp / tanh.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.models import build_model

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi", max_len=10, compute_dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(method, seed=0, **kw):
    """(flax model, flax variables, port model) sharing weights."""
    over = dict(TOY, **kw)
    jcfg = jax_default_config(method, dataset="MSRVTT", **over)
    cfg = default_config(method, dataset="MSRVTT", **over)
    assert cfg.to_dict() == jcfg.to_dict()
    jmodel = jax_build_model(jcfg)
    variables = init_params(jmodel, jax.random.PRNGKey(seed), jcfg)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # non-trivial BN running statistics, so the bridge's stats mapping shows
    rng = np.random.RandomState(seed + 100)
    for bn in variables.get("batch_stats", {}).get("fusion", {}).values():
        bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, model


def _inputs(cfg, b=3, seed=1):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, cfg.n_frames, d).astype(np.float32)
             for d in cfg.modality_dims]
    cat = rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32)
    tokens = np.zeros((b, cfg.max_len), np.int32)
    for i in range(b):
        n = rng.randint(4, cfg.max_len)
        tokens[i, :n] = rng.randint(1, cfg.vocab_size, n)
    return feats, cat, tokens


CASES = {
    "NACF": ("NACF", {}),                           # with_category, untied
    "ARB": ("ARB", {}),                             # causal teacher
    "tied": ("NAB", dict(tie_weights=True)),        # tied projection
    "nocat-enh0": ("NAB", dict(with_category=False, enhance_input=0)),
    "2layer-ln": ("NACF", dict(num_hidden_layers_decoder=2, with_layernorm=True)),
    "enh1-posattn": ("NAB", dict(enhance_input=1, pos_attention=True)),
    "watch-sigmoid": ("ARB", dict(watch=3, use_sigmoid_to_get_attprob=True)),
    "addition-ln-m": ("NAB", dict(fusion="addition", norm_type="ln", modality="m")),
    "none-nobn-relu": ("NAB", dict(fusion="none", no_encoder_bn=True,
                                   hidden_act="relu")),
    "parallel_mlm-gelu": ("NAB", dict(parallel_mlm=True, hidden_act="gelu")),
}


@pytest.mark.parametrize("method,kw", CASES.values(), ids=list(CASES))
def test_forward_matches_flax_f32(method, kw):
    jcfg, jmodel, variables, model = _pair(method, **kw)
    feats, cat, tokens = _inputs(jcfg)
    dtype = "ARFormer" if jcfg.decoding_type == "ARFormer" else "NARFormer"
    cat_j = cat if jcfg.with_category else None

    enc_j = jmodel.apply(variables, [np.asarray(f) for f in feats],
                         method=lambda m, f: m.encode(f))
    hid_j, _, _ = jmodel.apply(variables, tokens, enc_j["enc_output"], cat_j,
                               dtype, True, method=lambda m, *a: m.decode(*a))
    logits_j = jmodel.apply(variables, hid_j, method=lambda m, h: m.project(h))

    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
        hid, _ = model.decode(torch.from_numpy(tokens), enc["enc_output"],
                              None if cat_j is None else torch.from_numpy(cat),
                              dtype)
        logits = model.project(hid)

    np.testing.assert_allclose(enc["enc_output"].numpy(),
                               np.asarray(enc_j["enc_output"]), **TOL)
    if "pred_length" in enc_j:
        np.testing.assert_allclose(enc["pred_length"].numpy(),
                                   np.asarray(enc_j["pred_length"]), **TOL)
    else:
        assert "pred_length" not in enc
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_bridge_fills_every_tensor_and_rejects_shape_mismatch():
    _, _, variables, model = _pair("NACF")
    # every flax leaf lands on the port tensor of the same role
    k = variables["params"]["decoder"]["layer_0"]["intermediate"]["dense"]["kernel"]
    np.testing.assert_array_equal(
        model.decoder.layers[0].intermediate.dense.weight.numpy(), k.T)
    bs = variables["batch_stats"]["fusion"]["bn1"]
    np.testing.assert_array_equal(
        model.fusion.norms["bn1"].running_var.numpy(), bs["var"])
    ln = variables["params"]["decoder"]["embedding"]["LayerNorm"]["scale"]
    np.testing.assert_array_equal(
        model.decoder.embedding.LayerNorm.weight.numpy(), ln)
    # a tree missing a leaf is refused, as is a wrong shape
    broken = jax.tree_util.tree_map(lambda x: x, variables)
    del broken["params"]["decoder"]["embedding"]["position_embeddings"]
    with pytest.raises(KeyError):
        load_flax_variables(build_model(default_config(
            "NACF", dataset="MSRVTT", **TOY), device="cpu"), broken)
    wrong = jax.tree_util.tree_map(lambda x: x, variables)
    wrong["params"]["tgt_word_prj"]["kernel"] = np.zeros((16, 49), np.float32)
    with pytest.raises(ValueError):
        load_flax_variables(build_model(default_config(
            "NACF", dataset="MSRVTT", **TOY), device="cpu"), wrong)


def test_seeded_init_is_reproducible_and_follows_torch_laws():
    cfg = default_config("NACF", dataset="MSRVTT", **TOY)
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.decoder.layers[0].intermediate.dense.weight
    assert w.abs().max() <= 1.0 / np.sqrt(w.shape[1])
    assert torch.all(a.decoder.embedding.word_embeddings.weight[0] == 0)
    assert not any(p.requires_grad for p in a.parameters())


def test_entry_points_default_to_cuda():
    """Without a card, the entry points refuse to run unless asked for the
    CPU (run in a subprocess that hides every CUDA device)."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from navc_tpu_torch.config import default_config\n"
        "from navc_tpu_torch.models import build_model\n"
        "from navc_tpu_torch.runtime.serving import StreamingCaptioner\n"
        "cfg = default_config('NACF', dataset='MSRVTT', vocab_size=50,"
        " dim_hidden=16, num_attention_heads=2, intermediate_size=32,"
        " n_frames=4, dim_i=12, dim_m=10, max_len=10)\n"
        "for call in (lambda: build_model(cfg),"
        " lambda: StreamingCaptioner(cfg, build_model(cfg, device='cpu'))):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without CUDA')\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_no_cuda_env(), timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


def _no_cuda_env():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
