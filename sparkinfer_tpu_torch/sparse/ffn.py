"""Predictor-gated sparse FFN, the port of the main path of
sparkinfer_tpu/sparse/ffn.py.

Every FFN neuron whose predicted activation probability is >= threshold is
computed; the others contribute exactly zero. Neurons are handled in
GROUPS of `group_size`: per token the top-`capacity` groups by active-neuron
count are computed, and sub-threshold neurons inside them are masked.

  - prefill: masked-dense FFN (`make_sparse_ffn`), which reads all weights;
    the cross-token union of active groups is large there;
  - decode: one-layer-ahead pipelined selection
    (`make_pipelined_sparse_ffn`) over flat (L*ng, E, G) / (L*ng, G, E)
    stores addressed at row il*ng + group, through the hand-written
    `sparse_ffn_block_v6` kernel ("kernel") or its plain torch version
    ("gather").

The non-pipelined gather/pallas modes, the v1 row layout, Q8_0 stores and
the union kernel for batched decode come with later slices.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.config import ModelConfig
from ..ops.sparse_ffn import combine, sparse_ffn_block_v6, sparse_ffn_block_v6_plain
from .config import SparseConfig
from .predictor import predict_activations, predict_from

PRED_KEYS = ("pred_up", "pred_up_b", "pred_down", "pred_down_b")


def select_groups(probs: torch.Tensor, scfg: SparseConfig, n_ff: int) -> torch.Tensor:
    """probs (..., F) -> idx (..., C) int32 group ids, best first.

    Score = active-neuron count per group (threshold crossings), with the max
    prob as tiebreak so near-threshold groups order stably. Exact ties may
    order differently from the JAX package's lax.top_k."""
    G = scfg.group_size
    ng = scfg.n_groups(n_ff)
    C = scfg.capacity(n_ff)
    gp = probs.reshape(probs.shape[:-1] + (ng, G))
    active = (gp >= scfg.threshold).float()
    score = active.sum(-1) + gp.amax(-1)  # max < 1 breaks ties only
    return torch.topk(score, C, dim=-1).indices.to(torch.int32)


def make_sparse_ffn(cfg: ModelConfig, scfg: SparseConfig,
                    mode: str = "dense") -> Callable:
    """ffn(lp, x) for models.transformer.make_forward: the masked-dense FFN
    (`mode="dense"`, the prefill path). lp carries the predictor and the
    dense w_up/w_gate/w_down."""
    if mode != "dense":
        raise NotImplementedError(f"sparse FFN mode {mode!r} is not ported yet")
    act, fat_thr = cfg.traits.sparse_act, cfg.fatrelu_threshold
    gated = act in ("fatrelu", "drelu")
    thr = scfg.threshold

    def dense_ffn(lp, x):
        probs = predict_activations(lp, x)  # (..., F) f32
        mask = (probs >= thr).to(x.dtype)
        up = x @ lp["w_up"]
        if "b_up" in lp:
            up = up + lp["b_up"].to(up.dtype)
        gate = x @ lp["w_gate"] if gated and "w_gate" in lp else None
        hidden = combine(act, fat_thr, gate, up) * mask
        out = hidden @ lp["w_down"]
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out

    return dense_ffn


def prepare_pipelined_params(params: dict, cfg: ModelConfig,
                             scfg: SparseConfig) -> dict:
    """A new params dict (sharing the dense tensors) that adds

      - layers[k + "_nx"]: the predictor rolled one layer down (layer il's
        slice holds layer (il+1) % L's predictor), so layer il can select
        for layer il+1;
      - params["sparse_flat"]: w_upT_flat / w_gateT_flat (L*ng, E, G) and
        w_down_flat (L*ng, G, E), the kernel's stores, row il*ng + group.

    The up/gate stores are transposed copies, filled one layer at a time so
    no transient ever holds a second copy of a whole projection. The down
    store has the dense layout already and is a view of w_down (no bytes)."""
    L, E, F = cfg.n_layer, cfg.n_embd, cfg.n_ff
    G = scfg.group_size
    ng = scfg.n_groups(F)
    layers = dict(params["layers"])
    for k in PRED_KEYS:
        layers[k + "_nx"] = torch.roll(layers[k], -1, dims=0)

    def transposed(w):  # (L, E, F) -> (L*ng, E, G)
        flat = torch.empty((L * ng, E, G), dtype=w.dtype, device=w.device)
        for il in range(L):
            flat[il * ng:(il + 1) * ng].copy_(
                w[il].reshape(E, ng, G).permute(1, 0, 2))
        return flat

    flat = {"w_upT_flat": transposed(layers["w_up"])}
    if "w_gate" in layers:
        flat["w_gateT_flat"] = transposed(layers["w_gate"])
    flat["w_down_flat"] = layers["w_down"].reshape(L * ng, G, E)
    return {**params, "layers": layers, "sparse_flat": flat}


def make_pipelined_sparse_ffn(cfg: ModelConfig, scfg: SparseConfig,
                              mode: str = "kernel"):
    """Returns (ffn, carry_init) for make_forward(..., ffn_carry_init=...).

    ffn(lp, x, carry, il): layer 0 selects from its own predictor; every
    other layer uses the selection that the previous layer computed with the
    rolled (`_nx`) predictor. Each layer also emits the next layer's
    selection. mode "kernel" runs `sparse_ffn_block_v6` (the CUDA kernel on
    the card), "gather" its plain torch version on any device."""
    if mode not in ("kernel", "gather"):
        raise ValueError(f"pipelined sparse FFN mode {mode!r}")
    block = sparse_ffn_block_v6 if mode == "kernel" else sparse_ffn_block_v6_plain
    G = scfg.group_size
    F = cfg.n_ff
    ng = scfg.n_groups(F)
    C = scfg.capacity(F)
    thr = scfg.threshold

    def _select(pu, pub, pd, pdb, xt):
        probs = predict_from(pu, pub, pd, pdb, xt)
        idx = select_groups(probs, scfg, F)
        gp = probs.reshape(-1, ng, G)
        gp_sel = torch.gather(gp, 1, idx.long()[..., None].expand(-1, -1, G))
        return idx, gp_sel

    def carry_init(B: int, T: int, device) -> dict:
        N = B * T
        return {"idx": torch.zeros((N, C), dtype=torch.int32, device=device),
                "gp_sel": torch.zeros((N, C, G), dtype=torch.float32, device=device)}

    def ffn(lp, x, carry, il):
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        if il == 0:
            idx, gp_sel = _select(*(lp[k] for k in PRED_KEYS), xt)
        else:
            idx, gp_sel = carry["idx"], carry["gp_sel"]
        bu_sel = None
        if "b_up" in lp:
            bu_sel = lp["b_up"].reshape(ng, G).float()[idx.long()]
        out = block(xt, idx + il * ng, gp_sel, lp["w_upT_flat"],
                    lp.get("w_gateT_flat"), lp["w_down_flat"],
                    act=cfg.traits.sparse_act,
                    fatrelu_threshold=cfg.fatrelu_threshold,
                    prob_threshold=thr, bu_sel=bu_sel)
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        nx_idx, nx_gp = _select(*(lp[k + "_nx"] for k in PRED_KEYS), xt)
        return out.reshape(B, T, E).to(x.dtype), {"idx": nx_idx, "gp_sel": nx_gp}

    return ffn, carry_init
