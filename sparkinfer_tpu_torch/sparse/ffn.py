"""Predictor-gated sparse FFN, the port of sparkinfer_tpu/sparse/ffn.py.

Every FFN neuron whose predicted activation probability is >= threshold is
computed; the others contribute exactly zero. Neurons are handled in
GROUPS of `group_size`: per token the top-`capacity` groups by active-neuron
count are computed, and sub-threshold neurons inside them are masked.

  - prefill: masked-dense FFN (`make_sparse_ffn(mode="dense")`), which reads
    all weights (the dense ones, or the row or flat stores when the dense
    weights were dropped);
  - non-pipelined decode, the serving Scheduler's: `make_sparse_ffn` mode
    "kernel" (the JAX "pallas") through the hand-written v1 kernel
    `sparse_ffn_block` over the row stores of `prepare_sparse_params`
    (L, ng, G, E), or mode "gather" (plain torch on any device);
  - pipelined decode: one-layer-ahead selection
    (`make_pipelined_sparse_ffn`) over flat (L*ng, E, G) / (L*ng, G, E)
    stores addressed at row il*ng + group (`prepare_pipelined_params`
    layout "v6", the Engine's), through `sparse_ffn_block_v6`, or
    `sparse_ffn_block_v6q` over Q8_0 stores ("kernel"), their plain torch
    versions ("gather"), or for batched decode over the cross-token union
    of selected groups (`union_from_selection`) through
    `sparse_ffn_block_v7u` ("kernel_union", the JAX "pallas_union") or plain
    torch ("gather_union"); or over the per-layer row stores (layout "v1",
    `sparkinfer-bench --sparse`'s) through v1 or, with SPIF_KERNEL_V2 set,
    `sparse_ffn_block_v2` over the concatenated store w_all_rows ("kernel"),
    or the JAX gather math ("gather").
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from ..models.config import ModelConfig
from ..ops.quant_matmul import W8A8Tensor, is_quantized
from ..ops.sparse_ffn import dequant_rows as _dequant_sub_nd  # sparse/ffn.py:61
from ..ops.sparse_ffn import (
    combine,
    quantize_rows_q8_0,
    sparse_ffn_block,
    sparse_ffn_block_v2,
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
    sparse_ffn_block_v6q,
    sparse_ffn_block_v6q_plain,
    sparse_ffn_block_v7u,
)
from .config import SparseConfig
from .predictor import predict_activations, predict_from, resolve_predictor

PRED_KEYS = ("pred_up", "pred_up_b", "pred_down", "pred_down_b")
STACK_KEYS = ("pred_up_all", "pred_up_qt", "pred_up_w8")  # the predictor stacks' forms


def select_groups(probs: torch.Tensor, scfg: SparseConfig, n_ff: int) -> torch.Tensor:
    """probs (..., F) -> idx (..., C) int32 group ids, best first.

    Score = active-neuron count per group (threshold crossings), with the max
    prob as tiebreak so near-threshold groups order stably. The ranking is a
    stable descending sort, so exact ties keep the lower group id first, as
    the JAX package's lax.top_k does."""
    G = scfg.group_size
    ng = scfg.n_groups(n_ff)
    C = scfg.capacity(n_ff)
    gp = probs.reshape(probs.shape[:-1] + (ng, G))
    active = (gp >= scfg.threshold).float()
    score = active.sum(-1) + gp.amax(-1)  # max < 1 breaks ties only
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :C].to(torch.int32)


def _gather_sel(probs: torch.Tensor, idx: torch.Tensor, ng: int, G: int) -> torch.Tensor:
    """gp_sel (N, C, G): the probabilities of each token's selected groups."""
    gp = probs.reshape(-1, ng, G)
    return torch.gather(gp, 1, idx.long()[..., None].expand(-1, -1, G))


def _gather_rows(lp, xt, idx, keep, act, fat_thr, gated, ng, G):
    """The JAX "gather" math over the row stores (ng, G, E) of one layer:
    xt (N, E), idx (N, C) group ids, keep (N, C, G) the neurons at or above
    the threshold; the gathered rows are cast to xt's dtype."""
    il = idx.long()
    up = torch.einsum("ne,ncge->ncg", xt, lp["w_up_rows"][il].to(xt.dtype))
    if "b_up" in lp:
        up = up + lp["b_up"].reshape(ng, G)[il].to(up.dtype)
    gate = None
    if gated and "w_gate_rows" in lp:
        gate = torch.einsum("ne,ncge->ncg", xt, lp["w_gate_rows"][il].to(xt.dtype))
    hidden = combine(act, fat_thr, gate, up) * keep.to(up.dtype)
    return torch.einsum("ncg,ncge->ne", hidden, lp["w_down_rows"][il].to(hidden.dtype))


def sparse_layout(lp: dict, cfg: ModelConfig, scfg: SparseConfig) -> dict:
    """A new layer-param dict (possibly L-stacked) with neuron-major row
    stores w_up_rows / w_gate_rows / w_down_rows (..., ng, G, E) beside the
    dense weights. The up and gate stores are transposed one layer at a
    time into their destination, so no transient holds a second copy of a
    projection; w_down_rows is a view of w_down."""
    G = scfg.group_size
    F, E = cfg.n_ff, cfg.n_embd
    ng = scfg.n_groups(F)
    for k in ("w_up", "w_gate", "w_down"):
        if is_quantized(lp.get(k)):
            raise ValueError(f"sparse FFN needs dense (bf16/f32) {k}; load the "
                             "model with keep_quantized=False")

    def rows_from_col(w):  # (..., E, F) -> (..., ng, G, E)
        rows = torch.empty(w.shape[:-2] + (ng, G, E), dtype=w.dtype, device=w.device)
        src, dst = w.reshape((-1, E, F)), rows.reshape((-1, ng, G, E))
        for i in range(src.shape[0]):
            dst[i].copy_(src[i].T.reshape(ng, G, E))
        return rows

    out = dict(lp)
    out["w_up_rows"] = rows_from_col(lp["w_up"])
    if "w_gate" in lp:
        out["w_gate_rows"] = rows_from_col(lp["w_gate"])
    out["w_down_rows"] = lp["w_down"].reshape(lp["w_down"].shape[:-2] + (ng, G, E))
    return out


def prepare_sparse_params(params: dict, cfg: ModelConfig, scfg: SparseConfig,
                          drop_dense: bool = False) -> dict:
    """A new params dict (sharing the other tensors) whose stacked layers
    carry the `sparse_layout` row stores (L, ng, G, E), the stores of the
    non-pipelined "kernel"/"gather" decode. drop_dense=True leaves the dense
    w_up/w_gate/w_down out of the result; the masked-dense prefill then
    reads the row stores."""
    layers = sparse_layout(params["layers"], cfg, scfg)
    if drop_dense:
        for k in ("w_up", "w_gate", "w_down"):
            layers.pop(k, None)
    return {**params, "layers": layers}


def make_sparse_ffn(cfg: ModelConfig, scfg: SparseConfig,
                    mode: str = "dense") -> Callable:
    """ffn(lp, x) for models.transformer.make_forward.

      - "dense": the masked-dense FFN (the prefill). lp carries the
        predictor and the dense w_up/w_gate/w_down or, when they were
        dropped, the row stores (`prepare_sparse_params`) or the flat stores
        (bf16/f32 `*T_flat` or Q8_0 `qw_*`) with the layer index `flat_il`;
      - "kernel" (the JAX "pallas"): per-token top-C groups through the v1
        kernel `sparse_ffn_block` over the row stores, the Scheduler's
        sparse decode (its plain version on the CPU);
      - "gather": the same selection in plain torch on any device, the
        gathered rows cast to x's dtype as the JAX "gather" mode does."""
    if mode not in ("dense", "gather", "kernel"):
        raise ValueError(f"sparse FFN mode {mode!r}")
    act, fat_thr = cfg.traits.sparse_act, cfg.fatrelu_threshold
    gated = act in ("fatrelu", "drelu")
    thr = scfg.threshold
    F, G = cfg.n_ff, scfg.group_size
    ng = scfg.n_groups(F)

    def layer_flat(lp, key):
        # this layer's ng groups of the flat (L*ng, ...) store
        il = lp["flat_il"]
        return lp[key][il * ng:(il + 1) * ng]

    def col_mm(lp, x, name):  # x @ W_name (E, F), from whichever store lp has
        if "w_" + name in lp:
            return x @ lp["w_" + name]
        if f"w_{name}T_flat" in lp:  # v6 transposed flat store (L*ng, E, G)
            w = layer_flat(lp, f"w_{name}T_flat").to(x.dtype)
        elif f"qw_{name}T_flat" in lp:  # Q8_0 flat store: dequantize, contract
            w = _dequant_sub_nd(layer_flat(lp, f"qw_{name}T_flat"),
                                layer_flat(lp, f"s_{name}T_flat")).to(x.dtype)
        else:  # row store (ng, G, E)
            w = lp[f"w_{name}_rows"].to(x.dtype).transpose(-1, -2)
        y = torch.einsum("...e,neg->...ng", x, w)
        return y.reshape(y.shape[:-2] + (F,))

    def dense_ffn(lp, x):
        probs = predict_activations(lp, x)  # (..., F) f32
        mask = (probs >= thr).to(x.dtype)
        up = col_mm(lp, x, "up")
        if "b_up" in lp:
            up = up + lp["b_up"].to(up.dtype)
        gate = (col_mm(lp, x, "gate") if gated and any(k in lp for k in (
            "w_gate", "w_gate_rows", "w_gateT_flat", "qw_gateT_flat")) else None)
        hidden = combine(act, fat_thr, gate, up) * mask
        if "w_down" in lp:
            out = hidden @ lp["w_down"]
        else:
            h3 = hidden.reshape(hidden.shape[:-1] + (ng, G))
            if "w_down_rows" in lp:
                wd = lp["w_down_rows"]
            elif "w_down_flat" in lp:
                wd = layer_flat(lp, "w_down_flat")
            else:
                wd = _dequant_sub_nd(layer_flat(lp, "qw_down_flat"),
                                     layer_flat(lp, "s_down_flat"))
            out = torch.einsum("...ng,nge->...e", h3, wd.to(hidden.dtype))
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out

    def gather_ffn(lp, x):
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        probs = predict_activations(lp, xt)  # (N, F)
        idx = select_groups(probs, scfg, F)  # (N, C)
        out = _gather_rows(lp, xt, idx, _gather_sel(probs, idx, ng, G) >= thr, act,
                           fat_thr, gated, ng, G)
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out.reshape(B, T, E)

    def kernel_ffn(lp, x):
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        probs = predict_activations(lp, xt)
        idx = select_groups(probs, scfg, F)
        bu_sel = None
        if "b_up" in lp:
            bu_sel = lp["b_up"].reshape(ng, G).float()[idx.long()]
        out = sparse_ffn_block(xt, idx, _gather_sel(probs, idx, ng, G), lp["w_up_rows"],
                               lp.get("w_gate_rows"), lp["w_down_rows"], act=act,
                               fatrelu_threshold=fat_thr, prob_threshold=thr,
                               bu_sel=bu_sel)
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out.reshape(B, T, E).to(x.dtype)

    return {"dense": dense_ffn, "gather": gather_ffn, "kernel": kernel_ffn}[mode]


def _roll_predictors(layers: dict) -> dict:
    """A copy of layers with each per-layer predictor k beside its slices
    rolled one layer down, k + "_nx" (layer il holds layer (il+1) % L's)."""
    out = dict(layers)
    for k in PRED_KEYS:
        if k in layers:
            w = layers[k]
            out[k + "_nx"] = w.roll(-1) if isinstance(w, W8A8Tensor) else torch.roll(w, -1, dims=0)
    return out


def prepare_pipelined_params(params: dict, cfg: ModelConfig, scfg: SparseConfig,
                             drop_dense: bool = False, layout: str = "v1",
                             quant: str | None = None) -> dict:
    """A new params dict (sharing the dense tensors) that adds
    layers[k + "_nx"]: the per-layer predictor rolled one layer down (layer
    il's slice holds layer (il+1) % L's predictor), so layer il can select
    for layer il+1 (stacked predictors need no copy), and the stores of
    `layout`:

      - "v1" (the default, as in the JAX package): `prepare_sparse_params`'
        row stores w_up_rows / w_gate_rows / w_down_rows (L, ng, G, E) in
        layers, the stores of v1; with the environment variable
        SPIF_KERNEL_V2 set, also v2's concatenated store
        w_all_rows (L, P*ng, G, E), [up; (gate;) down] per layer;
      - "v6": params["sparse_flat"], the kernel's flat stores, row
        il*ng + group: w_upT_flat / w_gateT_flat (L*ng, E, G) and
        w_down_flat (L*ng, G, E); with quant="q8_0" (layout "v6" only)
        instead qw_upT_flat / qw_gateT_flat int8 (L*ng, E, G) with
        s_upT_flat / s_gateT_flat f32 (L*ng, E/32, G), and qw_down_flat int8
        (L*ng, G, E) with s_down_flat (L*ng, G/32, E). SPIF_KERNEL_V2 adds
        nothing here: the JAX package reads the row stores it has just
        replaced (a KeyError), and the v6 route would never read them.

    Every store is filled (and quantized) one layer at a time on the device,
    so no transient holds a second copy of a whole projection; the bf16
    down stores have the dense layout already and are views of w_down.
    drop_dense=True leaves the dense w_up/w_gate/w_down out of the result;
    the masked-dense prefill then reads the sparse stores."""
    if layout not in ("v1", "v6"):
        raise ValueError(f"sparse store layout {layout!r} (v1 or v6)")
    if quant not in (None, "q8_0"):
        raise ValueError(f"quantized sparse stores: {quant!r} (q8_0 only)")
    if quant is not None and layout != "v6":
        raise ValueError("quantized sparse stores require layout='v6'")
    if layout == "v1":
        out = prepare_sparse_params(params, cfg, scfg, drop_dense=drop_dense)
        layers = _roll_predictors(out["layers"])
        if os.environ.get("SPIF_KERNEL_V2"):
            parts = [layers[k] for k in ("w_up_rows", "w_gate_rows", "w_down_rows")
                     if k in layers]
            L, ng = parts[0].shape[:2]
            w_all = torch.empty((L, len(parts) * ng) + parts[0].shape[2:],
                                dtype=parts[0].dtype, device=parts[0].device)
            for il in range(L):
                for p, w in enumerate(parts):
                    w_all[il, p * ng:(p + 1) * ng].copy_(w[il])
            layers["w_all_rows"] = w_all
        return {**out, "layers": layers}
    L, E, F = cfg.n_layer, cfg.n_embd, cfg.n_ff
    G = scfg.group_size
    ng = scfg.n_groups(F)
    for k in ("w_up", "w_gate", "w_down"):
        if is_quantized(params["layers"].get(k)):
            raise ValueError(f"sparse FFN needs dense (bf16/f32) {k}; load the "
                             "model with keep_quantized=False")
    layers = _roll_predictors(params["layers"])

    def fill(w, rows_of, name, store_shape):
        """Flat store `name` from w (L, ...), layer by layer via rows_of."""
        dev = w.device
        if quant is None:
            flat = {name: torch.empty((L * ng,) + store_shape, dtype=w.dtype, device=dev)}
        else:
            B, C = store_shape
            qn, sn = "q" + name, "s" + name[1:]  # qw_*_flat, s_*_flat
            flat = {qn: torch.empty((L * ng, B, C), dtype=torch.int8, device=dev),
                    sn: torch.empty((L * ng, B // 32, C), dtype=torch.float32, device=dev)}
        for il in range(L):
            rows = rows_of(w[il])
            sl = slice(il * ng, (il + 1) * ng)
            if quant is None:
                flat[name][sl].copy_(rows)
            else:
                q, s = quantize_rows_q8_0(rows)
                flat[qn][sl].copy_(q)
                flat[sn][sl].copy_(s)
        return flat

    def up_rows(w):  # (E, F) -> (ng, E, G)
        return w.reshape(E, ng, G).permute(1, 0, 2)

    flat = {}
    for name in ("up", "gate"):
        if "w_" + name in layers:
            flat.update(fill(layers["w_" + name], up_rows, f"w_{name}T_flat", (E, G)))
    if quant is None:
        flat["w_down_flat"] = layers["w_down"].reshape(L * ng, G, E)
    else:
        flat.update(fill(layers["w_down"], lambda w: w.reshape(ng, G, E),
                         "w_down_flat", (G, E)))
    if drop_dense:
        for k in ("w_up", "w_gate", "w_down"):
            layers.pop(k, None)
    return {**params, "layers": layers, "sparse_flat": flat}


def union_from_selection(idx: torch.Tensor, gp_sel: torch.Tensor, ng: int,
                         Cu: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-token union of selected groups. idx (B, C) per-token group ids;
    gp_sel (B, C, G) their probabilities. Returns (union (Cu,) int32 group
    ids ranked by how many tokens selected them, gp_u (B, Cu, G) per-token
    probabilities, zero where the token did not select the group). Exact
    when Cu >= |union|; otherwise the least-shared groups are dropped. The
    ranking is a stable descending sort, so equal counts keep the lower
    group id first, as the JAX package's lax.top_k does."""
    B = idx.shape[0]
    G = gp_sel.shape[-1]
    il = idx.long()
    pres = torch.zeros((B, ng), dtype=torch.float32, device=idx.device).scatter_(1, il, 1.0)
    union = torch.sort(pres.sum(0), descending=True, stable=True).indices[:Cu]
    gp_full = torch.zeros((B, ng, G), dtype=gp_sel.dtype, device=idx.device).scatter_(
        1, il[..., None].expand(-1, -1, G), gp_sel)
    return union.to(torch.int32), gp_full[:, union] * pres[:, union][..., None]


def make_pipelined_sparse_ffn(cfg: ModelConfig, scfg: SparseConfig,
                              mode: str = "kernel", union_groups: int | None = None):
    """Returns (ffn, carry_init) for make_forward(..., ffn_carry_init=...).

    ffn(lp, x, carry, il): layer 0 selects from its own predictor; every
    other layer uses the selection that the previous layer computed with the
    next layer's predictor (the rolled `_nx` slices, or layer il+1 of the
    stacks). Each layer also emits the next layer's selection. mode "kernel"
    runs `sparse_ffn_block_v6q` when lp holds Q8_0 flat stores,
    `sparse_ffn_block_v6` over the bf16/f32 flat stores, and over the v1
    layout's per-layer row stores `sparse_ffn_block_v2` when lp holds
    w_all_rows and SPIF_KERNEL_V2 is set, else `sparse_ffn_block` (v1), as
    the JAX "pallas" mode routes (the CUDA kernels on the card). "gather"
    runs the plain torch versions of the flat-store kernels, or the JAX
    gather math over the row stores, on any device. The batched-decode
    modes read the cross-token union of the tokens' selected groups,
    `union_groups` of them (default
    min(ng, 4C), exact when it covers the union), once for all tokens:
    "kernel_union" (the JAX "pallas_union") through `sparse_ffn_block_v7u`,
    "gather_union" in plain torch and f32 (no bf16 rounding).
    "kernel_union" needs the bf16/f32 flat stores; "gather_union" also reads
    the v1 layout's row stores, as the JAX package's does."""
    if mode not in ("kernel", "gather", "kernel_union", "gather_union"):
        raise ValueError(f"pipelined sparse FFN mode {mode!r}")
    block = sparse_ffn_block_v6 if mode == "kernel" else sparse_ffn_block_v6_plain
    block_q = sparse_ffn_block_v6q if mode == "kernel" else sparse_ffn_block_v6q_plain
    G = scfg.group_size
    F = cfg.n_ff
    L = cfg.n_layer
    ng = scfg.n_groups(F)
    C = scfg.capacity(F)
    Cu = union_groups or min(ng, 4 * C)
    thr = scfg.threshold
    act, fat_thr = cfg.traits.sparse_act, cfg.fatrelu_threshold
    gated = act in ("fatrelu", "drelu")

    def _select(pu, pub, pd, pdb, xt):
        probs = predict_from(pu, pub, pd, pdb, xt)
        idx = select_groups(probs, scfg, F)
        return idx, _gather_sel(probs, idx, ng, G)

    def _union(lp, xt, idx, gp_sel, il):
        flat_form = "w_upT_flat" in lp
        if mode == "kernel_union" and not flat_form:
            raise ValueError("kernel_union needs the bf16/f32 flat stores")
        union, gp_u = union_from_selection(idx, gp_sel, ng, Cu)
        ul = union.long()
        if mode == "kernel_union":
            bu_u = None
            if "b_up" in lp:
                bu_u = lp["b_up"].reshape(ng, G).float()[ul][None].expand(gp_u.shape)
            return sparse_ffn_block_v7u(
                xt, union + il * ng, gp_u, lp["w_upT_flat"], lp.get("w_gateT_flat"),
                lp["w_down_flat"], act=act, fatrelu_threshold=fat_thr,
                prob_threshold=thr, bu_u=bu_u)
        # the flat stores at row il*ng + group, or this layer's row stores
        rows = ul + il * ng if flat_form else ul

        def col(name):  # (B, Cu, G), the stores in x's dtype
            if flat_form:
                w = lp[f"w_{name}T_flat"][rows].to(xt.dtype)
                return torch.einsum("be,ueg->bug", xt, w)
            return torch.einsum("be,uge->bug", xt, lp[f"w_{name}_rows"][rows].to(xt.dtype))

        up = col("up")
        if "b_up" in lp:
            up = up + lp["b_up"].reshape(ng, G)[ul].to(up.dtype)[None]
        has_gate = "w_gateT_flat" in lp or "w_gate_rows" in lp
        gate = col("gate") if gated and has_gate else None
        hidden = combine(act, fat_thr, gate, up)
        hidden = hidden * (gp_u >= thr).to(hidden.dtype)
        wd = lp["w_down_flat" if flat_form else "w_down_rows"][rows]
        return torch.einsum("bug,uge->be", hidden, wd.to(hidden.dtype))

    def _pred(lp, il, nxt):
        """Own (il) or next-layer ((il+1) mod L) predictor weights. The JAX
        package routes on "pred_up_all" alone, so there Q8_0 or W8A8 stacks
        need a bf16 pred_up_all beside them; routing on any stack's key gives
        the same function without that copy (as its sparse_tp.py:154 does). Per-layer
        slices, where lp has them, win, as in resolve_predictor."""
        if "pred_up" not in lp and any(k in lp for k in STACK_KEYS):
            return resolve_predictor(lp, (il + 1) % L if nxt else il)
        sfx = "_nx" if nxt else ""
        return tuple(lp[k + sfx] for k in PRED_KEYS)

    def carry_init(B: int, T: int, device) -> dict:
        N = B * T
        return {"idx": torch.zeros((N, C), dtype=torch.int32, device=device),
                "gp_sel": torch.zeros((N, C, G), dtype=torch.float32, device=device)}

    def ffn(lp, x, carry, il):
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        if il == 0:
            idx, gp_sel = _select(*_pred(lp, il, False), xt)
        else:
            idx, gp_sel = carry["idx"], carry["gp_sel"]
        if mode in ("kernel_union", "gather_union"):
            out = _union(lp, xt, idx, gp_sel, il)
        else:
            bu_sel = None
            if "b_up" in lp:
                bu_sel = lp["b_up"].reshape(ng, G).float()[idx.long()]
            kw = dict(act=act, fatrelu_threshold=fat_thr, prob_threshold=thr, bu_sel=bu_sel)
            if "qw_upT_flat" in lp:
                out = block_q(xt, idx + il * ng, gp_sel, lp["qw_upT_flat"],
                              lp["s_upT_flat"], lp.get("qw_gateT_flat"),
                              lp.get("s_gateT_flat"), lp["qw_down_flat"],
                              lp["s_down_flat"], **kw)
            elif "w_upT_flat" in lp:
                out = block(xt, idx + il * ng, gp_sel, lp["w_upT_flat"],
                            lp.get("w_gateT_flat"), lp["w_down_flat"], **kw)
            elif mode == "gather":  # the v1 layout's per-layer row stores
                out = _gather_rows(lp, xt, idx, gp_sel >= thr, act, fat_thr, gated, ng, G)
            elif "w_all_rows" in lp and os.environ.get("SPIF_KERNEL_V2"):
                out = sparse_ffn_block_v2(xt, idx, gp_sel, lp["w_all_rows"], gated=gated,
                                          R=ng, **kw)
            else:
                out = sparse_ffn_block(xt, idx, gp_sel, lp["w_up_rows"],
                                       lp.get("w_gate_rows"), lp["w_down_rows"], **kw)
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        nx_idx, nx_gp = _select(*_pred(lp, il, True), xt)
        return out.reshape(B, T, E).to(x.dtype), {"idx": nx_idx, "gp_sel": nx_gp}

    return ffn, carry_init
