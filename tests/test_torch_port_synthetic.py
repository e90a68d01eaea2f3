"""The port's learnable synthetic corpora against navc_tpu's, on the CPU.

``make_learnable_synthetic``, ``make_hard_synthetic`` and
``make_flagship_synthetic`` of ``navc_tpu_torch.data.synthetic`` must give,
for the same configuration and seed, the corpus (captions, POS tags, itow,
itop, itoc, ``length_info``, split, ``split_category``), the references,
the features and (``return_meta=True``) the meta of navc_tpu's generators
bit for bit: the same values of the same types, the arrays of the same
dtype and shape. They draw from one ``np.random.RandomState`` in the same
call order, which a moved call would break. ``make_hard_synthetic`` runs at
scripts/flagship_quality.py's ``--small`` settings (80 videos, 12 classes,
3 captions, vocab 700, ``adj_pool=80``, ``adv_pool=40``) with its corpus-v3
knobs off and on.

Run: ``python -m pytest tests/test_torch_port_synthetic.py -q``.
"""

import numpy as np
import pytest

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.data import synthetic as jax_synthetic
from navc_tpu_torch.config import default_config
from navc_tpu_torch.data import synthetic

TOY = dict(dataset="MSVD", vocab_size=40, dim_hidden=32, num_attention_heads=2,
           intermediate_size=64, n_frames=4, n_total_frames=10, dim_i=12, dim_m=10,
           modality="mi", max_len=10)
SMALL = dict(dataset="MSRVTT", vocab_size=700, n_frames=8, n_total_frames=16,
             dim_i=64, dim_m=48)


def configs(method, **over):
    cfg, jcfg = default_config(method, **over), jax_default_config(method, **over)
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


def assert_same(got, want, where="out"):
    """Equal values of equal types, recursively; arrays of equal dtype,
    shape and bits."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], "%s[%r]" % (where, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (where, i))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n_classes", [4, 6])
def test_learnable_synthetic_matches_navc_tpu(n_classes, seed):
    cfg, jcfg = configs("ARB", **TOY)
    kw = dict(n_videos=24, n_classes=n_classes, seed=seed)
    got = synthetic.make_learnable_synthetic(cfg, **kw)
    want = jax_synthetic.make_learnable_synthetic(jcfg, **kw)
    assert_same(got, want)
    corpus, _, feats = got
    assert sorted(feats) == ["feats_i", "feats_m"]
    assert corpus["captions"]["video0"] == corpus["captions"]["video%d" % n_classes]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_hard_synthetic_matches_navc_tpu(v3, seed):
    cfg, jcfg = configs("NACF", **SMALL)
    kw = dict(n_videos=80, n_classes=12, vocab_size=700, n_caps=3, n_total_frames=16,
              adj_pool=80, adv_pool=40, seed=seed, role_features=v3,
              modifier_distractors=v3, return_meta=True)
    got = synthetic.make_hard_synthetic(cfg, **kw)
    want = jax_synthetic.make_hard_synthetic(jcfg, **kw)
    assert len(got) == 4
    assert_same(got, want)
    corpus, refs, feats, meta = got
    assert len(corpus["info"]["itow"]) == 700
    assert all(len(refs["video%d" % v]) == 3 for v in range(80))
    assert feats["feats_m"]["video0"].shape == (16, 48)
    assert meta["role_features"] is v3 and meta["modifier_distractors"] is v3
    # without meta: the first three of the same draw
    kw["return_meta"] = False
    assert_same(synthetic.make_hard_synthetic(cfg, **kw), got[:3])


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("dataset", ["MSRVTT", "MSVD"])
def test_flagship_synthetic_matches_navc_tpu(dataset, seed):
    cfg, jcfg = configs("NACF", **dict(SMALL, dataset=dataset, vocab_size=300))
    kw = dict(n_videos=64, n_classes=8, vocab_size=300, n_total_frames=16, seed=seed,
              n_categories=20)
    got = synthetic.make_flagship_synthetic(cfg, **kw)
    want = jax_synthetic.make_flagship_synthetic(jcfg, **kw)
    assert_same(got, want)
    corpus = got[0]
    lengths = [len(c[0]) - 2 for c in corpus["captions"].values()]
    assert 8 <= min(lengths) and max(lengths) <= min(18, cfg.max_len - 2)
    info = corpus["info"]
    assert info["itoc"] == {v: (v % 8) % 20 for v in range(64)}
    assert sum(len(v) for v in info["split_category"]["train"].values()) == len(
        info["split"]["train"])
