"""Batch independence of the port's NACF decode, on the CPU.

navc_tpu's bench.py decodes 8192 videos in one call; chip_smoke.py's
``scale`` phase runs that decode on the card. Here, at toy widths, on the
plain route in float32 (``make_nar_generator(jit=True)``, eager on the
CPU), with an ARB teacher:

  * mp and l2r: the decode of 256 videos gives, bit for bit, the tokens of
    its four 64-video pieces, each encoded and decoded alone (every step
    of these paradigms is per row: the length beam, the canvas, the
    re-mask sets, the teacher's rescoring, the best length beam);
  * mp, l2r and ef: the 256-video decode gives navc_tpu's tokens for the
    same 256 videos, identically (the repo's float32 parity rule,
    docs/DESIGN.md §5), navc_tpu run as tests/test_torch_port_decode.py
    runs it. ef is held to navc_tpu's decode only: its stop rule is
    batch-global (navc_tpu mask_predict.py:565-568: the reveal rounds run
    while the batch's mask count falls), so a piece may stop at another
    round than the whole batch, in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.decoding import make_nar_generator
from navc_tpu_torch.models import build_model

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2, intermediate_size=32,
           n_frames=4, dim_i=12, dim_m=10, modality="mi", compute_dtype="float32")
MAX_LEN = 10
VIDEOS, PIECE = 256, 64

_VARIABLES = {}


def _models(method, seed, **kw):
    """Both packages' models with the same weights; ``kw`` replaces config
    fields after the method's defaults."""
    jcfg = jax_default_config(method, dataset="MSRVTT", **TOY).replace(max_len=MAX_LEN, **kw)
    cfg = default_config(method, dataset="MSRVTT", **TOY).replace(max_len=MAX_LEN, **kw)
    assert cfg.to_dict() == jcfg.to_dict()
    jmodel = jax_build_model(jcfg)
    if (method, seed) not in _VARIABLES:
        _VARIABLES[method, seed] = jax.tree_util.tree_map(
            np.asarray, init_params(jmodel, jax.random.PRNGKey(seed), jcfg))
    variables = _VARIABLES[method, seed]
    return jcfg, jmodel, variables, cfg, load_flax_variables(build_model(cfg, device="cpu"),
                                                             variables)


def _inputs(cfg, b, seed=5):
    rng = np.random.RandomState(seed)
    return ([rng.randn(b, cfg.n_frames, d).astype(np.float32) for d in cfg.modality_dims],
            rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32))


def _port_decode(student, teacher, feats, cat):
    """The port's request: encodes and the jit=True generator."""
    cfg, model, tmodel = student[3], student[4], teacher[4]
    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        enc, tenc = model.encode(tf), tmodel.encode(tf)
    gen = make_nar_generator(cfg, model, tmodel, jit=True)
    return gen(enc, torch.from_numpy(cat), tenc).numpy()


def _navc_decode(student, teacher, feats, cat):
    """navc_tpu's jitted generator on the same request."""
    jcfg, jmodel, jvars = student[:3]
    tjmodel, tjvars = teacher[1], teacher[2]
    enc = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    tenc = tjmodel.apply(tjvars, feats, method=lambda m, f: m.encode(f))
    gen = jax_make_nar_generator(jcfg, jmodel, tjmodel, jit=True)
    return np.asarray(gen(jvars, enc, cat, tjvars, tenc, None))


@pytest.mark.parametrize("paradigm", ["mp", "l2r", "ef"])
def test_decode_of_256_videos_is_batch_independent(paradigm):
    kw = dict(paradigm=paradigm) if paradigm == "mp" else dict(paradigm=paradigm, q=1)
    student, teacher = _models("NACF", 0, **kw), _models("ARB", 1)
    feats, cat = _inputs(student[3], VIDEOS)
    whole = _port_decode(student, teacher, feats, cat)
    assert whole.shape == (VIDEOS, MAX_LEN) and whole.dtype == np.int32
    np.testing.assert_array_equal(whole, _navc_decode(student, teacher, feats, cat))
    if paradigm == "ef":  # the stop rule counts the whole batch's masks
        return
    pieces = np.concatenate([
        _port_decode(student, teacher, [f[i:i + PIECE] for f in feats], cat[i:i + PIECE])
        for i in range(0, VIDEOS, PIECE)])
    np.testing.assert_array_equal(whole, pieces)
