"""Embedding extraction and pooling, the port of
sparkinfer_tpu/runtime/embeddings.py (ref: tools/server /embeddings and
examples/embedding; the pooling modes mirror llama_pooling_type).

Each input runs one prompt forward (`make_forward(with_hidden=True,
head=False)`: the hidden states alone, no logits) on the model's device
over a fresh cache of its own length, and is pooled on the host from the
final-normed hidden states in f32 (a non-causal encoder's, bert's,
neo-bert's or gemma-embedding's, from bidirectional attention over the
input; bert's from its last post-sum norm): "mean", "last",
"cls" (the first token), "none" (every token's vector) or "rank" (a
reranker's classification head on the first token, computed in f32 as
the JAX Embedder computes it, one score, never normalized). Unlike the
JAX Embedder, an input is not padded to a length bucket: the forward runs
at its own length, so an input's vector does not depend on the inputs
beside it (the JAX Embedder hides an encoder's pads at position -1, which
gives the same vector). An input is cut to max_seq, which a model with
learned positions caps at their count (bert's 512).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import clamp_max_seq, make_forward
from .kv_cache import init_cache

POOLINGS = ("mean", "last", "cls", "none", "rank")


class Embedder:
    """Pooled embeddings of token lists. The model's params must lie on
    `device` (None: the card; pass "cpu" to run on the CPU)."""

    def __init__(self, model, max_seq: int = 512, pooling: str = "mean", device=None):
        if pooling not in POOLINGS:
            raise ValueError(f"pooling {pooling!r} (want one of {POOLINGS})")
        self.model = model
        self.cfg = model.config
        self.max_seq = clamp_max_seq(self.cfg, model.params, max_seq)
        self.pooling = pooling
        self.device = resolve_device(device)
        self._fwd = make_forward(self.cfg, with_hidden=True, fresh_prefill=True, head=False)

    @torch.inference_mode()
    def hidden(self, ids: list[int]) -> np.ndarray:
        """(n, E) f32 final-normed hidden states of one input (cut to max_seq)."""
        if not ids:
            raise ValueError("empty input")
        ids = list(ids)[: self.max_seq]
        n = len(ids)
        toks = torch.tensor([ids], dtype=torch.long, device=self.device)
        pos = torch.arange(n, device=self.device)[None]
        cache = init_cache(self.cfg, 1, max(n, 8), torch.float32, self.device)
        _, h = self._fwd(self.model.params, toks, pos, cache)
        return h[0].float().cpu().numpy()

    def _rank(self, h: np.ndarray) -> np.ndarray:
        """The classification head on the first token (ref build_pooling
        LLAMA_POOLING_TYPE_RANK, llama-graph.cpp:2277-2303), in f32 on the
        host."""
        p = self.model.params

        def f32(key):
            return p[key].float().cpu().numpy()

        v = h[0]
        if "cls_w" in p:
            v = f32("cls_w") @ v
            if "cls_b" in p:
                v = v + f32("cls_b")
            v = np.tanh(v)
        if "cls_out_w" in p:
            v = f32("cls_out_w") @ v
            if "cls_out_b" in p:
                v = v + f32("cls_out_b")
        return np.atleast_1d(v)[:1]

    def embed_tokens(self, token_lists: list[list[int]], normalize: bool = True):
        """(len(token_lists), E) pooled embeddings, f32; with pooling "none"
        a list of (n, E) arrays, with "rank" (len, 1) scores."""
        out = []
        for ids in token_lists:
            h = self.hidden(ids)
            if self.pooling == "none":
                out.append(h)
                continue
            if self.pooling == "rank":
                out.append(self._rank(h))
                continue
            v = {"mean": lambda: h.mean(0), "last": lambda: h[-1],
                 "cls": lambda: h[0]}[self.pooling]()
            if normalize:
                v = v / max(np.linalg.norm(v), 1e-12)
            out.append(v)
        return out if self.pooling == "none" else np.stack(out)

    def rerank_scores(self, pairs: list[list[int]]) -> list[float]:
        """pairs: tokenized [bos]query[eos][sep]doc[eos] sequences -> one
        relevance score each (rank pooling)."""
        if self.pooling != "rank":
            raise ValueError("rerank_scores needs pooling='rank'")
        return [float(s[0]) for s in self.embed_tokens(pairs, normalize=False)]
