"""NACF's mask-predict decode and ARB's beam search, in plain PyTorch.

Written from the reference code's decoding/na_generate.py,
decoding/algorithms.py (MaskPredict) and models/Beam.py +
models/Translator.py, over ``model.py``'s float32 forward. Videos are
independent, so both run in blocks of videos and give the same captions
at any block size. Ties break as the reference code's stable sorts do:
the lower position (or index) first.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import model as R
from .model import BOS, EOS, FP32, MASK, PAD, VIS, Precision


def _ranks(values: torch.Tensor) -> torch.Tensor:
    """Ordinal rank of each entry of a row in ascending order, ties to the
    lower position first."""
    order = torch.sort(values, dim=-1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(values.shape[-1], device=values.device)
                   .expand_as(order))
    return ranks


def _scores(sd, m, tokens, enc, cat, causal, p, kv):
    """(logits, their max, sum of exp(logit - max)) of a forward."""
    s = R.project(sd, R.decode(sd, m, tokens, enc, cat, causal, p, kv), p)
    top = s.amax(-1, keepdim=True)
    return s, top, torch.exp(s - top).sum(-1, keepdim=True)


def _predict(sd, m, tokens, enc, cat, pad_mask, p, kv):
    """One NAR forward: (argmax ids, max probs), PAD slots PAD and 1.0
    (algorithms.py:7-15, 143-167)."""
    s, _, total = _scores(sd, m, tokens, enc, cat, False, p, kv)
    ids, maxp = s.argmax(-1), 1.0 / total[..., 0]
    return torch.where(pad_mask, PAD, ids), torch.where(pad_mask, 1.0, maxp)


def _teacher_probs(tsd, tm, tokens, tenc, cat, pad_mask, p, kv):
    """The AR teacher's probability of each token after BOS and the tokens
    before it (algorithms.py:175-204); 1.0 on PAD."""
    inp = torch.cat([torch.full_like(tokens[:, :1], BOS), tokens[:, :-1]], 1)
    s, top, total = _scores(tsd, tm, inp, tenc, cat, True, p, kv)
    got = torch.exp(s.gather(-1, tokens.long()[..., None]) - top) / total
    return torch.where(pad_mask, 1.0, got[..., 0])


def _tiled_kv(sd, enc, n, p):
    """The cross keys and values, once per video, tiled n times."""
    return [x.repeat_interleave(n, 0) for x in R.cross_kv(sd, enc, p)]


def nacf_block(sd, m, tsd, tm, feats: List[torch.Tensor], cat: torch.Tensor,
               p: Precision = FP32) -> torch.Tensor:
    """Captions (B, max_len) of one block of videos: the length beam, the
    coarse-template pass, mask-predict with the teacher's final rescoring,
    the best length beam by sum(log p) / len**beam_alpha."""
    lbs, L = m["length_beam_size"], m["max_len"]
    enc = R.encode(sd, m, feats, p)
    tenc = R.encode(tsd, tm, feats, p)["enc_output"]
    b = cat.shape[0]
    # the length beam (na_generate.py:39-50): the top lengths, clamped
    top = torch.sort(enc["pred_length"], dim=-1, descending=True, stable=True).indices
    lengths = (top[:, :lbs] + m["length_bias"]).clamp(4, L - 1).reshape(-1)
    pos = torch.arange(L, device=cat.device)
    pad_mask = pos[None] >= lengths[:, None]
    tokens = torch.where(pad_mask, PAD, MASK)
    enc_t = enc["enc_output"].repeat_interleave(lbs, 0)
    tenc_t = tenc.repeat_interleave(lbs, 0)
    cat_t = cat.repeat_interleave(lbs, 0)
    kv = _tiled_kv(sd, enc["enc_output"], lbs, p)
    tkv = _tiled_kv(tsd, tenc, lbs, p)
    T = m["iterations"] + (1 if m["use_ct"] else 0)
    if m["use_ct"]:
        ids, probs = _predict(sd, m, torch.where(tokens == MASK, VIS, tokens), enc_t, cat_t,
                              pad_mask, p, kv)
        tokens, probs = ids, torch.where(ids == MASK, 0.0, probs)
    else:
        tokens, probs = _predict(sd, m, tokens, enc_t, cat_t, pad_mask, p, kv)
    seq_lens = lengths.float()
    for c in range(1, T):
        if m["use_ct"] and c == 1:
            remask = tokens == MASK
        else:
            # the count floor(len * (1 - c/T)) at least 1, in float32
            # (algorithms.py:255-257)
            ratio = float(np.float32(1.0 - c / T))
            count = (seq_lens * ratio).to(torch.int64).clamp(min=1)
            remask = _ranks(probs) < count[:, None]
        masked = torch.where(remask, MASK, tokens)
        ids, new_p = _predict(sd, m, masked, enc_t, cat_t, pad_mask, p, kv)
        tokens = torch.where(remask, ids, masked)
        probs = torch.where(remask, new_p, probs)
    lprobs = torch.log(probs * _teacher_probs(tsd, tm, tokens, tenc_t, cat_t, pad_mask, p, tkv))
    score = lprobs.reshape(b, lbs, L).sum(-1) / lengths.reshape(b, lbs).float() ** m["beam_alpha"]
    best = score.argmax(-1)
    return tokens.reshape(b, lbs, L)[torch.arange(b, device=cat.device), best]


def beam_block(sd, m, feats: List[torch.Tensor], cat: torch.Tensor,
               p: Precision = FP32) -> torch.Tensor:
    """Captions (B, max_len - 1) of one block of videos by beam search
    (Beam.py, Translator.py): k beams; the first step draws from beam 0
    alone; a beam that ended in EOS proposes nothing more; a video is done
    once k hypotheses ended; at max_len a video with none takes every beam;
    the best by score / length**beam_alpha. Each step recomputes the whole
    prefix (causal), which gives the cached decode's numbers."""
    k, L, alpha = m["beam_size"], m["max_len"], m["beam_alpha"]
    enc = R.encode(sd, m, feats, p)["enc_output"]
    b, dev = cat.shape[0], cat.device
    n = b * k
    enc_t, cat_t = enc.repeat_interleave(k, 0), cat.repeat_interleave(k, 0)
    kv = _tiled_kv(sd, enc, k, p)
    seqs = torch.zeros((b, k, L), dtype=torch.long, device=dev)
    seqs[:, :, 0] = BOS
    scores = torch.full((b, k), -1e20, device=dev)
    scores[:, 0] = 0.0
    last = torch.full((b, k), BOS, dtype=torch.long, device=dev)
    finished: List[List[tuple]] = [[] for _ in range(b)]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(1, L):
        hidden = R.decode(sd, m, seqs.reshape(n, L), enc_t, cat_t, True, p, kv)[:, t - 1]
        s = R.project(sd, hidden, p)
        top = s.amax(-1, keepdim=True)
        logp = ((s - top) - torch.log(torch.exp(s - top).sum(-1, keepdim=True))).view(b, k, -1)
        v = logp.shape[-1]
        cand = torch.where((last == EOS)[:, :, None], -1e20, logp + scores[:, :, None])
        best, flat = torch.sort(cand.reshape(b, k * v), dim=-1, descending=True, stable=True)
        best, flat = best[:, :k], flat[:, :k]
        prev, word = flat // v, flat % v
        new = torch.gather(seqs, 1, prev[:, :, None].expand(b, k, L)).clone()
        new[:, :, t] = word
        active = ~done
        seqs = torch.where(active[:, None, None], new, seqs)
        scores = torch.where(active[:, None], best, scores)
        last = torch.where(active[:, None], word, last)
        ended = ((word == EOS) & active[:, None]).cpu().numpy()
        for i, j in zip(*np.nonzero(ended)):
            if len(finished[i]) < k:
                finished[i].append((float(best[i, j]), t, new[i, j]))
        if t == L - 1:
            for i in np.nonzero(active.cpu().numpy())[0]:
                if not finished[i]:
                    finished[i] = [(float(best[i, j]), t, new[i, j]) for j in range(k)]
        done |= torch.tensor([len(f) >= k for f in finished], device=dev)
        if bool(done.all()):
            break
    out = torch.zeros((b, L - 1), dtype=torch.long, device=dev)
    for i, hyps in enumerate(finished):
        norm = [s / max(length, 1) ** alpha for s, length, _ in hyps]
        out[i] = hyps[int(np.argmax(norm))][2][1:]
    return out


def captions(kind: str, weights: Dict, m: Dict, feats: List[torch.Tensor],
             cat: torch.Tensor, precision: str = "bf16", block: int = 128) -> torch.Tensor:
    """The reference's captions of every video in ``feats``, ``block``
    videos at a time; ``weights`` {"student": sd[, "teacher": sd]},
    ``m`` {"student": model entry[, "teacher": ...]}; ``precision`` one of
    model.PRECISIONS."""
    p = R.PRECISIONS[precision](kind)
    with _no_tf32(), torch.no_grad():
        outs = []
        for s in range(0, cat.shape[0], block):
            part = slice(s, s + block)
            f = [x[part] for x in feats]
            if kind == "nacf":
                outs.append(nacf_block(weights["student"], m["student"], weights["teacher"],
                                       m["teacher"], f, cat[part], p))
            else:
                outs.append(beam_block(weights["student"], m["student"], f, cat[part], p))
        return torch.cat(outs)


class _no_tf32:
    """float32 products in float32: TF32 off for the block, as it was after."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
        return False
