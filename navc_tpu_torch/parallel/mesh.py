"""The ('data', 'model') rank grid and the sharding rules.

Port of navc_tpu/parallel/mesh.py. navc_tpu lays a 2-D device mesh over
the TPU slice and lets GSPMD insert the collectives; the port runs one rank
per device (``parallel/distributed.py``) and makes them itself:

  * ``make_mesh``: the world as a (data, model) grid, rank = data_index * m
    + model_index, so each 'model' group is a run of adjacent ranks (navc_tpu
    keeps its TP groups on adjacent chips for the same reason), with one
    process group per 'model' group and one per 'data' group;
  * data parallel: a rank's batch is its part of the global batch (its rows:
    ``shard_batch``; a host-sharded ``data.loader``); the training step
    divides the losses by the global counts, all-reduces the gradients and
    BatchNorm's statistics over 'data' (``runtime/train_step.py``,
    ``runtime/crit.py``, ``models/fusion.py``);
  * tensor parallel (``TP_RULES``): the vocab projection, the word-embedding
    table and the FFN's expand / reduce weights are split over 'model'. A
    rank keeps its 1/m slice of each (``shard_params``), which is all the
    optimizer updates, so it holds 1/m of their Adam moments. Before a
    forward ``gather`` all-gathers the slices into the model's full
    weights, which the kernels (K9-K12) read as they are, as GSPMD hands a
    Pallas operand its full array; each slice's gradient is the rank's part
    of the full gradient. The products themselves are not split;
  * the (batch x length beam) inference sweep: ``generate_sharded`` decodes
    a rank's rows and all-gathers the tokens.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import distributed as D


def layout(data: int, model: int) -> np.ndarray:
    """The (data, model) grid of ranks: rank = data_index * model + model_index."""
    return np.arange(data * model).reshape(data, model)


@dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups (None
    without a process group: no collective then runs)."""
    data: int
    model: int
    rank: int = 0
    data_group: Any = None    # the ranks of this rank's 'model' coordinate
    model_group: Any = None   # the ranks of this rank's 'data' coordinate

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def backend(self) -> Optional[str]:
        return D.group_backend(self.data_group) if self.data_group is not None else None


def make_mesh(shape: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh of ``shape`` (e.g. {'data': 2, 'model': 2}; default all
    'data') over the process group's ranks. Every rank calls it: it makes
    every group, in one order on all of them."""
    world = D.process_count()
    if not shape:
        shape = {"data": world, "model": 1}
    d, m = shape.get("data", 1), shape.get("model", 1)
    assert d * m == world, "mesh %s does not cover %d ranks" % (shape, world)
    mesh = Mesh(d, m, D.process_index())
    if not torch.distributed.is_initialized():
        return mesh
    grid = layout(d, m)
    for i in range(d):
        g = torch.distributed.new_group(grid[i].tolist())
        if i == mesh.data_index:
            mesh.model_group = g
    for j in range(m):
        g = torch.distributed.new_group(grid[:, j].tolist())
        if j == mesh.model_index:
            mesh.data_group = g
    return mesh


# ---------------------------------------------------------------------------
# Batch sharding: leading dim over 'data'
# ---------------------------------------------------------------------------


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: a contiguous 1/d of every array,
    tensor or list, by the data coordinate (GSPMD's layout of one array
    sharded over 'data'); other entries pass through."""
    def rows(v):
        n = len(v) // mesh.data
        assert n * mesh.data == len(v), "batch of %d rows over %d" % (len(v), mesh.data)
        return v[mesh.data_index * n:(mesh.data_index + 1) * n]

    return {k: rows(v) if isinstance(v, list) or getattr(v, "ndim", 0) > 0 else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Parameter sharding: tensor-parallel rules by parameter name
# ---------------------------------------------------------------------------

# (name regex, spec over the tensor's dims). First match wins; default
# replicated. navc_tpu's rules (mesh.py:86-100) name flax paths, whose Dense
# kernel is (in, out); a torch Linear.weight is (out, in), so a Linear's
# sharded dim is the other one. Embedding tables are (V, H) in both.
TP_RULES = [
    # vocab projection (V, H): shard the vocab
    (re.compile(r"tgt_word_prj\.weight$"), ("model", None)),
    # word embedding table (V, H): shard vocab rows
    (re.compile(r"word_embeddings\.weight$"), ("model", None)),
    # FFN expand (4H, H) / reduce (H, 4H): Megatron's column / row split.
    # The reduce rule takes the layer-level FFN only: every attention block
    # has an 'output.dense' (its (H, H) out-projection) too, whose input is
    # replicated, and it stays replicated.
    (re.compile(r"intermediate\.dense\.weight$"), ("model", None)),
    (re.compile(r"layers\.\d+\.output\.dense\.weight$"), (None, "model")),
    (re.compile(r"intermediate\.dense\.bias$"), ("model",)),
]


def param_pspec(name: str, leaf) -> Tuple:
    """The parameter's spec: one entry per dim ('model' where it is split),
    () when replicated."""
    for rx, spec in TP_RULES:
        if rx.search(name):
            if len(spec) <= getattr(leaf, "ndim", 0):
                return spec
    return ()


@dataclass
class _Shard:
    name: str
    full: nn.Parameter    # the model's: the forward's operand, its grad the full gradient
    shard: nn.Parameter   # this rank's slice: what the optimizer updates
    dim: int


class ShardedParams:
    """A model's parameters on one rank of ``mesh``: every TP parameter
    (``TP_RULES``) with this rank's 1/m slice of it, which the optimizer
    updates in its place (``parameters``)."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.model, self.mesh = model, mesh
        self.shards: List[_Shard] = []
        if mesh.model == 1:
            return
        for name, p in model.named_parameters():
            spec = param_pspec(name, p)
            if "model" not in spec:
                continue
            dim = spec.index("model")
            n = p.shape[dim] // mesh.model
            assert n * mesh.model == p.shape[dim], \
                "%s: dim %d of %s over %d ranks" % (name, dim, tuple(p.shape), mesh.model)
            piece = p.detach().narrow(dim, mesh.model_index * n, n).clone()
            self.shards.append(_Shard(name, p, nn.Parameter(piece), dim))

    def parameters(self) -> List[nn.Parameter]:
        """The model's parameters, each TP one replaced by this rank's slice."""
        sliced = {id(s.full): s.shard for s in self.shards}
        return [sliced.get(id(p), p) for p in self.model.parameters()]

    def gather(self) -> None:
        """The slices of every rank of this rank's 'model' group into the
        model's full parameters: one all-gather, a collective every rank of
        the group calls (before evaluation and checkpoints too)."""
        if not self.shards:
            return
        flat = torch.cat([s.shard.detach().reshape(-1) for s in self.shards])
        parts = D.all_gather(flat, self.mesh.model_group)
        off = 0
        with torch.no_grad():
            for s in self.shards:
                k = s.shard.numel()
                s.full.copy_(torch.cat([parts[r, off:off + k].view(s.shard.shape)
                                        for r in range(self.mesh.model)], s.dim))
                off += k

    def zero_full_grads(self) -> None:
        for s in self.shards:
            if s.full.grad is not None:
                s.full.grad.zero_()

    def slice_grads(self) -> None:
        """Each slice's gradient: this rank's part of its full gradient."""
        for s in self.shards:
            n = s.shard.shape[s.dim]
            part = s.full.grad.narrow(s.dim, self.mesh.model_index * n, n)
            if s.shard.grad is None:
                s.shard.grad = part.clone()
            else:
                s.shard.grad.copy_(part)


def shard_params(model: nn.Module, mesh: Mesh) -> ShardedParams:
    """``model``'s parameters sharded over ``mesh``'s 'model' axis."""
    return ShardedParams(model, mesh)


# ---------------------------------------------------------------------------
# The sharded inference sweep
# ---------------------------------------------------------------------------


def generate_sharded(generate, mesh: Mesh, enc_results: Dict[str, torch.Tensor],
                     category=None, teacher_enc_results=None, **kwargs) -> torch.Tensor:
    """``generate``'s hypotheses for every row of the global batch: this
    rank decodes its rows (``shard_batch``'s) through ``generate`` (e.g.
    ``make_nar_generator``'s) and the tokens of the 'data' group are
    all-gathered, in row order. Every rank of the group calls it."""
    local = shard_batch(enc_results, mesh)
    if category is not None:
        category = shard_batch({"c": category}, mesh)["c"]
    if teacher_enc_results is not None:
        teacher_enc_results = shard_batch(teacher_enc_results, mesh)
    hyp = generate(local, category, teacher_enc_results, **kwargs)
    if mesh.data_group is None:
        return hyp
    return D.all_gather(hyp, mesh.data_group).reshape(-1, *hyp.shape[1:])
