"""The port's data and tensor parallelism (navc_tpu_torch.parallel) on the
CPU, against navc_tpu's single-process step and the port's own.

The rank grid and its groups; ``param_pspec`` on every parameter of a small
NACF and ARB model against navc_tpu's ``param_pspec`` on the matching flax
path (a Linear's dims flipped); the host-sharded loader's orders bit for
bit navc_tpu's, the lockstep permutations. Then two gloo clusters, each
started once for the module (``torch_port_dist_worker.start``): 2 ranks
(data 2: NACF and ARB, 3 steps each, and an uneven final partial batch;
data 1 x model 2: NACF; the sharded NAB sweep) and 4 ranks (data 2 x
model 2: NACF). Every step is float32 at dropout 0 from the same weights
on both sides (the port's seeded init carried to navc_tpu as a flax tree), on global batches of 8 rows whose second half has features
3x the first's, so each rank's BatchNorm statistics differ from the
global ones. Tolerances: the losses alike on every rank (digests of the
weights too, bit for bit), within rtol 1e-5 of the port's single-process
step on the whole batch and 2e-4 of navc_tpu's (test_distributed.py:115;
TP 1e-4, test_multichip.py:108); the global gradients within atol = rtol =
1e-5 of the single-process step's; weights within 2 x lr of both
(test_multichip.py:87: Adam turns float noise on a near-zero gradient into
a step of lr); BatchNorm running statistics within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from navc_tpu.data.dataset import VideoDataset as JaxVideoDataset
from navc_tpu.data.loader import BatchLoader as JaxBatchLoader
from navc_tpu.decoding import make_nar_generator as jax_make_nar_generator
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.parallel.mesh import param_pspec as jax_param_pspec
from navc_tpu.runtime.train_step import create_train_state as jax_create_state
from navc_tpu.runtime.train_step import make_train_step as jax_make_step

import torch_port_dist_worker as worker
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import export_flax_variables, load_flax_variables
from navc_tpu_torch.data.dataset import VideoDataset
from navc_tpu_torch.data.loader import BatchLoader, get_loader
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from navc_tpu_torch.decoding import make_nar_generator
from navc_tpu_torch.models import build_model
from navc_tpu_torch.parallel.mesh import Mesh, layout, make_mesh, param_pspec, shard_batch
from test_torch_port_train import NO_DROPOUT, TOY, configs, make_batch

GLOBAL_B = 8
STEPS = 3
OVER = dict(TOY, batch_size=GLOBAL_B, **NO_DROPOUT)
SINGLE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def global_batches(cfg, n=STEPS):
    out = []
    for s in range(n):
        b = make_batch(cfg, seed=s)
        b["valid_mask"] = np.ones(GLOBAL_B, np.float32)
        for ch in cfg.modality.lower():
            b["feats_%s" % ch][GLOBAL_B // 2:] *= 3.0
        out.append(b)
    return out


def uneven_batch(cfg):
    """A final partial batch: 5 valid rows, the padding zero as collate
    makes it; in halves, 4 valid rows on rank 0 and 1 on rank 1."""
    b = global_batches(cfg, 1)[0]
    for k, v in b.items():
        v[5:] = 0
    return b


def variables_of(method, seed=0, **kw):
    """(navc_tpu config, port config, the port's seeded init as a flax tree)."""
    jcfg, cfg = configs(method, **dict(OVER, **kw))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return jcfg, cfg, export_flax_variables(model)


def port_single(cfg, variables, batches):
    """The port's single-process steps: (losses, gradients of each step as
    flax trees, weights after the steps)."""
    model = load_flax_variables(build_model(cfg, device="cpu", train=True), variables)
    out = worker.single_steps(cfg, model, batches)
    return [m["total_loss"] for m in out["metrics"]], out["grads"], out["variables"]


def jax_single(jcfg, variables, runs):
    """navc_tpu's single-process steps over each list of batches in
    ``runs``, each from ``variables``, through one jitted step: [(losses,
    weights after the steps)]."""
    jmodel = jax_build_model(jcfg)
    out, step = [], None
    for batches in runs:
        state, tx = jax_create_state(jcfg, jmodel, variables)
        step = step or jax_make_step(jcfg, jmodel, tx)
        losses = []
        for b in batches:
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                  jax.random.PRNGKey(7))
            losses.append(float(metrics["total_loss"]))
        out.append((losses, jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    return out


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def assert_trees(got, want, what, **tol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg="%s %s" % (what, k), **tol)


def max_diff(got, want):
    got = dict(leaves(got))
    return max(float(np.abs(got[k] - v).max()) for k, v in leaves(want))


# ---------------------------------------------------------------------------
# the grid, the rules, the loader: no cluster
# ---------------------------------------------------------------------------


def test_mesh_layout_keeps_model_groups_adjacent():
    grid = layout(2, 2)
    assert grid.tolist() == [[0, 1], [2, 3]]  # 'model' groups are runs of ranks
    assert layout(4, 1)[:, 0].tolist() == [0, 1, 2, 3]
    mesh = Mesh(2, 2, rank=3)
    assert (mesh.data_index, mesh.model_index) == (1, 1)
    assert (Mesh(2, 2, rank=2).data_index, Mesh(2, 2, rank=2).model_index) == (1, 0)
    single = make_mesh()  # no process group: one rank, no collective
    assert (single.data, single.model, single.data_group, single.backend) == (1, 1, None, None)
    with pytest.raises(AssertionError, match="does not cover"):
        make_mesh({"data": 2, "model": 1})


@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_param_pspec_matches_navc_tpu(method):
    """Every parameter's spec equals navc_tpu's on its flax path; the
    parameters are found there by a distinct fill each."""
    _, cfg = configs(method, **OVER)
    model = build_model(cfg, device="cpu")
    named = list(model.named_parameters())
    with torch.no_grad():
        for i, (_, p) in enumerate(named):
            p.fill_(i + 1)
    flax = dict(leaves(export_flax_variables(model)["params"]))
    sharded = 0
    for i, (name, p) in enumerate(named):
        (path, leaf), = [(k, v) for k, v in flax.items() if (v == i + 1).all()]
        want = tuple(jax_param_pspec(path, leaf))
        want += (None,) * (leaf.ndim - len(want))
        if path.endswith("kernel"):  # flax (in, out) against torch (out, in)
            want = want[::-1]
        got = param_pspec(name, p)
        got += (None,) * (p.ndim - len(got))
        assert got == want, (name, path, got, want)
        sharded += "model" in got
    assert sharded == 5, sharded  # word table, projection, FFN weight, bias, reduce


class _Items:
    def __init__(self, n, seed=0):
        self.n = n
        self.random = np.random.RandomState(seed)
        self.structure_random = np.random.RandomState(seed + 0x5eed)

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,shards", [(10, 2), (12, 4), (7, 3), (3, 5), (1, 4)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_shard_orders_match_navc_tpu(n, shards, shuffle):
    """Every shard's epoch order and batch count bit for bit navc_tpu's,
    two epochs running; the shards cover the items, wrap-padded to one
    length (more shards than items too)."""
    port = [BatchLoader(_Items(n), 2, shuffle=shuffle, num_shards=shards, shard_id=i)
            for i in range(shards)]
    ref = [JaxBatchLoader(_Items(n), 2, shuffle=shuffle, num_shards=shards, shard_id=i)
           for i in range(shards)]
    for _ in range(2):
        orders = [p._order() for p in port]
        for o, r in zip(orders, ref):
            np.testing.assert_array_equal(o, r._order())
        assert len({len(o) for o in orders}) == 1
        assert set(np.concatenate(orders).tolist()) == set(range(n))
        assert [len(p) for p in port] == [len(r) for r in ref]


def test_epoch_permutations_stay_lockstep_across_hosts():
    """Per-item draws consume dataset.random differently on each shard;
    the epoch-2 permutation still agrees (the structure stream), and with
    navc_tpu's (port of test_distributed.py's test)."""
    cfg = default_config("NAB", dataset="MSVD", vocab_size=40, dim_hidden=16,
                         num_attention_heads=2, intermediate_size=32, n_frames=4,
                         n_total_frames=10, dim_i=12, dim_m=10, modality="mi",
                         max_len=8, batch_size=2)
    cfg = cfg.replace(teacher_path="", load_teacher_weights=False, with_teacher=False)
    corpus, _ = make_synthetic_corpus(cfg, n_videos=10, n_caps=3, vocab_size=40)
    feats = make_synthetic_feats(cfg, n_videos=10, n_total_frames=10)
    loaders, jloaders = [], []
    for shard in range(2):
        ds = VideoDataset(cfg, "train", info_corpus=corpus, in_memory_feats=feats)
        ds.host_lockstep = True
        loaders.append(BatchLoader(ds, 2, shuffle=True, num_shards=2, shard_id=shard))
        jds = JaxVideoDataset(cfg, "train", info_corpus=corpus, in_memory_feats=feats)
        jds.host_lockstep = True
        jloaders.append(JaxBatchLoader(jds, 2, shuffle=True, num_shards=2, shard_id=shard))
    for ld, jld in zip(loaders, jloaders):
        for b, jb in zip(ld, jld):
            np.testing.assert_array_equal(b["tokens"], jb["tokens"])
            np.testing.assert_array_equal(b["feats_i"], jb["feats_i"])
    for ld in loaders + jloaders:
        ld.dataset.shuffle()
    o0, o1 = loaders[0]._order(), loaders[1]._order()
    assert set(o0.tolist()).isdisjoint(set(o1.tolist()))
    assert sorted(np.concatenate([o0, o1]).tolist()) == list(range(len(loaders[0].dataset)))
    np.testing.assert_array_equal(o0, jloaders[0]._order())
    assert [it["cap_id"] for it in loaders[1].dataset.infoset] == \
        [it["cap_id"] for it in jloaders[1].dataset.infoset]


def test_get_loader_shards_over_the_data_coordinate():
    """Ranks of one 'model' group load the same rows: the shard is the
    'data' index, over 'data' shards."""
    cfg = default_config("ARB", dataset="MSVD", **OVER)
    corpus, _ = make_synthetic_corpus(cfg, n_videos=10, n_caps=2, vocab_size=40)
    feats = make_synthetic_feats(cfg, n_videos=10, n_total_frames=10)
    orders = {}
    for rank in range(4):
        ld = get_loader(cfg, "train", corpus, feats, batch_size=2, host_shard=True,
                        mesh=Mesh(2, 2, rank=rank))
        assert (ld.num_shards, ld.shard_id) == (2, rank // 2) and ld.dataset.host_lockstep
        orders[rank] = ld._order().tolist()
    assert orders[0] == orders[1] and orders[2] == orders[3] and orders[0] != orders[2]
    single = get_loader(cfg, "train", corpus, feats)
    assert (single.num_shards, single.shard_id, single.dataset.host_lockstep) == (1, 0, False)


def test_shard_batch_takes_the_data_rows():
    batch = {"a": np.arange(8), "ids": list("abcdefgh"), "n": 8}
    got = shard_batch(batch, Mesh(2, 2, rank=3))
    assert got["a"].tolist() == [4, 5, 6, 7] and got["ids"] == list("efgh") and got["n"] == 8


# ---------------------------------------------------------------------------
# the clusters, started once for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    refs = {}
    for method in ("NACF", "ARB"):
        refs[method] = variables_of(method)
    jn, cfg_n, var_n = refs["NACF"]
    ja, cfg_a, var_a = refs["ARB"]
    batches_n, batches_a = global_batches(cfg_n), global_batches(cfg_a)
    uneven = [uneven_batch(cfg_n)]

    def case(name, method, variables, batches, mesh=None):
        return dict(name=name, method=method, over=dict(OVER, dataset="MSVD"),
                    variables=variables, batches=batches, mesh=mesh)

    jnab, cfg_nab, var_nab = variables_of("NAB", 1, length_beam_size=2, iterations=2)
    rng = np.random.RandomState(1)
    sweep_feats = [rng.randn(GLOBAL_B, cfg_nab.n_frames, d).astype(np.float32)
                   for d in (cfg_nab.dim_m, cfg_nab.dim_i)]
    def sweep(mesh=None):
        return dict(name="nab", method="NAB", mesh=mesh, variables=var_nab, feats=sweep_feats,
                    over=dict(OVER, dataset="MSVD", length_beam_size=2, iterations=2))

    two = worker.start("steps,sweep", 2, dict(device="cpu", steps=[
        case("dp_NACF", "NACF", var_n, batches_n),
        case("dp_ARB", "ARB", var_a, batches_a),
        case("uneven", "NACF", var_n, uneven),
        case("tp_1x2", "NACF", var_n, batches_n, {"data": 1, "model": 2}),
    ], sweep=[sweep()]), os.path.join(root, "two"))
    four = worker.start("steps,sweep", 4, dict(device="cpu", steps=[
        case("tp_2x2", "NACF", var_n, batches_n, {"data": 2, "model": 2})],
        sweep=[sweep({"data": 2, "model": 2})]), os.path.join(root, "four"))

    out = {"single": {}, "navc": {}, "batches": {"NACF": batches_n, "ARB": batches_a}}
    for name, cfg, var, batches in (("NACF", cfg_n, var_n, batches_n),
                                    ("ARB", cfg_a, var_a, batches_a),
                                    ("uneven", cfg_n, var_n, uneven)):
        out["single"][name] = port_single(cfg, var, batches)
    out["navc"]["NACF"], out["navc"]["uneven"] = jax_single(jn, var_n, [batches_n, uneven])
    out["navc"]["ARB"], = jax_single(ja, var_a, [batches_a])
    # the sweep's references: the port's decode of every row at once, navc_tpu's
    model = load_flax_variables(build_model(cfg_nab, device="cpu"), var_nab)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in sweep_feats])
        out["sweep_single"] = make_nar_generator(cfg_nab, model)(enc).numpy()
    jmodel = jax_build_model(jnab)
    jvars = jax.tree_util.tree_map(jnp.asarray, var_nab)
    jenc = jmodel.apply(jvars, [jnp.asarray(f) for f in sweep_feats],
                        method=lambda m, f: m.encode(f))
    out["sweep_navc"] = np.asarray(jax_make_nar_generator(jnab, jmodel)(jvars, jenc, None))
    out["lr"] = cfg_n.learning_rate
    out["two"], out["four"] = two(), four()
    return out


def _ranks_agree(outs, name, model_groups=1):
    """Every rank's losses, and weights bit for bit; the TP slices alike
    within each 'data' group."""
    first = outs[0]["steps"][name]
    for o in outs[1:]:
        r = o["steps"][name]
        assert [m["total_loss"] for m in r["metrics"]] == \
            [m["total_loss"] for m in first["metrics"]]
        assert r["digests"] == first["digests"], "weights differ across ranks"
    for j in range(model_groups):
        group = [o["steps"][name]["shard_digests"] for o in outs[j::model_groups]]
        assert all(g == group[0] for g in group), "TP slices differ across a 'data' group"
    return first


def _check_against_single(runs, got, ref_name, navc_tol):
    losses, grads, weights = runs["single"][ref_name]
    jlosses, jweights = runs["navc"][ref_name]
    mine = [m["total_loss"] for m in got["metrics"]]
    np.testing.assert_allclose(mine, losses, **SINGLE_TOL)
    np.testing.assert_allclose(mine, jlosses, rtol=navc_tol)
    for g, want in zip(got["grads"], grads):
        assert_trees(g, want, "gradient", **GRAD_TOL)
    assert max_diff(got["variables"]["params"], weights["params"]) < 2 * runs["lr"]
    assert max_diff(got["variables"]["params"], jweights["params"]) < 2 * runs["lr"]
    assert_trees(got["variables"]["batch_stats"], weights["batch_stats"], "BN", atol=1e-6,
                 rtol=0)
    assert_trees(got["variables"]["batch_stats"], jweights["batch_stats"], "BN", atol=1e-6,
                 rtol=1e-6)


@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_data_parallel_step_matches_single_process(runs, method):
    got = _ranks_agree(runs["two"], "dp_" + method)
    assert not got["shards"] and len(got["metrics"]) == STEPS
    _check_against_single(runs, got, method, navc_tol=2e-4)


def test_uneven_final_partial_batch_gives_the_single_process_loss(runs):
    got = _ranks_agree(runs["two"], "uneven")
    assert got["metrics"][0]["num_samples"] == 5.0
    _check_against_single(runs, got, "uneven", navc_tol=2e-4)


@pytest.mark.parametrize("name,world,model", [("tp_1x2", "two", 2), ("tp_2x2", "four", 2)])
def test_tensor_parallel_step_matches_single_process(runs, name, world, model):
    """Each rank keeps 1/2 of every TP parameter's rows or columns, and only
    those in its optimizer; the step holds against the single-process one."""
    outs = runs[world]
    got = _ranks_agree(outs, name, model_groups=model)
    assert len(got["shards"]) == 5
    for pname, (shape, dim) in got["shards"].items():
        full = got["full_shapes"][pname]
        assert shape[dim] * model == full[dim] and \
            shape[:dim] + shape[dim + 1:] == full[:dim] + full[dim + 1:], pname
    n_model = sum(v.size for _, v in leaves(got["variables"]["params"]))
    n_tp = sum(int(np.prod(f)) for f in got["full_shapes"].values())
    n_opt = sum(int(np.prod(s)) for s in got["optimizer_shapes"])
    assert n_opt == n_model - n_tp + n_tp // model, (n_opt, n_model, n_tp)
    for o in outs:  # the slices differ between the ranks of a 'model' group
        assert o["steps"][name]["shards"] == got["shards"]
    assert outs[0]["steps"][name]["shard_digests"] != outs[1]["steps"][name]["shard_digests"]
    _check_against_single(runs, got, "NACF", navc_tol=1e-4)


def test_sharded_nab_sweep_matches_single_process_and_navc_tpu(runs):
    for o in runs["two"]:
        tokens = o["sweep"]["nab"]["tokens"]
        np.testing.assert_array_equal(tokens, runs["sweep_single"])
        np.testing.assert_array_equal(tokens, runs["sweep_navc"])


def test_sharded_nab_sweep_on_a_2x2_mesh(runs):
    """Data 2 x model 2 on four ranks: the ranks of a 'model' group decode
    the same rows, the 'data' groups gather them; every rank holds the
    whole batch's tokens, the single process's and navc_tpu's."""
    for o in runs["four"]:
        tokens = o["sweep"]["nab"]["tokens"]
        np.testing.assert_array_equal(tokens, runs["sweep_single"])
        np.testing.assert_array_equal(tokens, runs["sweep_navc"])
