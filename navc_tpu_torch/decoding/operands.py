"""The kernel operands of a decoder model, shared by the NAR decodes
(decoding/mask_predict.py) and the beam search's full-prefix step
(decoding/beam.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.fused_layer import LayerWeights, hoist_cross_kv, layer_weights
from ..ops.vocab_fused import projection_weights
from .length_beam import enlarge


@dataclass
class KernelOperands:
    """A model's kernel operands, made once per generator: bf16 layer
    weights and word table, float32 embedding LN, position and category
    tables, and the (V, D) bf16 projection."""
    layer: LayerWeights
    word16: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    pos_table: torch.Tensor
    cat_table: Optional[torch.Tensor]
    proj_w: torch.Tensor
    proj_b: Optional[torch.Tensor]
    n_head: int
    ln_eps: float

    @classmethod
    def of(cls, model) -> "KernelOperands":
        emb = model.decoder.embedding
        cat = getattr(emb, "category_embeddings", None)
        w, b = projection_weights(model)
        return cls(
            layer=layer_weights(model.decoder.layers[0]),
            word16=emb.word_embeddings.weight.detach().to(torch.bfloat16),
            ln_scale=emb.LayerNorm.weight.detach().float().contiguous(),
            ln_bias=emb.LayerNorm.bias.detach().float().contiguous(),
            pos_table=emb.position_embeddings.weight.detach().float(),
            cat_table=None if cat is None else cat.weight.detach().float(),
            proj_w=w, proj_b=b, n_head=model.cfg.num_attention_heads,
            ln_eps=model.cfg.layer_norm_eps)

    def static(self, n_rows: int, l: int, category=None, enc_output=None):
        """Iteration-invariant embedding parts as bf16 (N, l, H): position
        rows (zeros past the table end — the 8-aligned canvas tail, always
        PAD) + category + the mean-pooled enc_output (enhance_input 2)."""
        h = self.pos_table.shape[1]
        pos = self.pos_table[:l]
        if l > pos.shape[0]:
            pos = torch.cat([pos, pos.new_zeros(l - pos.shape[0], h)])
        static = pos[None].expand(n_rows, l, h)
        if self.cat_table is not None:
            if category is None:
                raise ValueError("with_category model requires category ids")
            cat = self.cat_table[category.reshape(n_rows, -1)[:, 0].long()]
            static = static + cat[:, None, :]
        if enc_output is not None:
            static = static + enc_output.mean(dim=1, keepdim=True)
        return static.to(torch.bfloat16).contiguous()

    def cross_kv(self, enc_unique: torch.Tensor, lbs: int):
        """Hoisted cross K/V, projected once per video and tiled over the
        length beams."""
        ke, ve = hoist_cross_kv(enc_unique, self.layer)
        return enlarge(ke, lbs).contiguous(), enlarge(ve, lbs).contiguous()
