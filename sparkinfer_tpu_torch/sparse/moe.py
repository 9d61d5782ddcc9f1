"""Mixture-of-Experts FFN, the port of sparkinfer_tpu/sparse/moe.py: routing,
the dense and the fused ("pallas") expert FFN, and expert hot/cold tiering.

MoE is the sparse FFN's problem again: a per-token top-k over blocks of
neuron rows. Each expert's Fe rows split into Fe/G groups of G rows; a token
routed to expert e reads groups [e*Fe/G, (e+1)*Fe/G) with its router weight
as the scale mask, so the fused mode runs the v1 row kernel
(`ops/sparse_ffn.py:sparse_ffn_block`, mask_mode "scale") and reads only the
routed experts' rows.

One resident copy of the experts. The port keeps every expert stack
(w_up_exps, w_gate_exps, w_down_exps, and grovemoe's chunk experts) in one
orientation, (..., X, Fe, E): expert-major neuron rows, the GGUF's own
order for up and gate. Read as (..., X*Fe/G, G, E) that is exactly the row
store of v1 and of the tiering machinery, so `moe_layout` and
`moe_rows_layout` add views, never copies. (The JAX package keeps up and
gate as (X, E, Fe); `models/from_jax.py` turns its params into this
orientation.)

grovemoe's chunk experts (of expert id // experts_per_group, on the routed
output, scaled by expert_group_scale) run in both modes: gathered in
"dense", a second row-kernel call over their own row stores in "pallas"
(the JAX package's fused mode leaves them out). The fused mode takes the
row kernel's activations only: smallthinker's reglu experts run in "dense",
and "pallas" refuses them by name, as the JAX row kernel does.

Routing follows llama.cpp's build_moe_ffn: softmax (default), sigmoid, or
softmax over the k selected raw logits ("softmax_topk"), an optional
selection-only bias (exp_probs_b), top-k renormalization (norm_topk_prob)
and a routed scale (expert_weights_scale). Shared experts (qwen2moe's,
with their sigmoid gate scalar; deepseek2's two, stored as one expert of
twice the width, with none) are added to the routed output. The ranking
is a stable descending sort, so exact ties keep the lower expert id
first, as `lax.top_k` does; it runs on the device with no
synchronization.

Expert tiering (`moe_rows_layout`, `MoEColdStore`, `make_tiered_moe_ffn`)
feeds the expert rows to the port's `init_tiered` / `Balancer`: hot experts'
groups live in the flat hot store on the card, cold experts are dropped
("drop": their router mass is lost) or computed on the host ("host"), and
the DFR statistic is each group's routed frequency, so the balancer swaps
whole experts. As the JAX package, no Engine option wires it: a caller
builds `make_forward(cfg, ffn_fn=make_tiered_moe_ffn(...), stateful_ffn=True)`.
It refuses, by name, what the JAX package's tiered FFN computes wrong or
not at all: arctic's parallel MoE block, grovemoe's chunk experts and
deepseek2's layer segments.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..ops.activations import act_fn
from ..ops.sparse_ffn import GATED_ACTS_V1, sparse_ffn_block
from .tiering import DFRState, PinnedStaging, host_rows

MODES = ("dense", "pallas")
TIERED_MODES = ("drop", "host")


def expert_groups(cfg: ModelConfig, group_size: int, width: int = 0) -> tuple[int, int]:
    """(G, ng_e): the group size, halved until it divides the expert width
    (`width`, or the model's expert width), and the groups of one expert."""
    Fe = width or cfg.n_ff_exp or cfg.n_ff
    G = min(group_size, Fe)
    while Fe % G:
        G //= 2
    return G, Fe // G


def moe_layout(lp: dict, cfg: ModelConfig, group_size: int = 128) -> dict:
    """lp with the fused mode's row stores moe_up_rows / moe_gate_rows /
    moe_down_rows (..., X*ng_e, G, E), views of the expert stacks, and the
    gpt-oss up/gate biases as (..., X*ng_e, G) rows (the down bias is per
    (expert, E) and is mixed outside the kernel); grovemoe's chunk experts
    as moe_up_ch_rows / moe_gate_ch_rows / moe_down_ch_rows, grouped by
    their own width."""
    E, X = cfg.n_embd, cfg.n_expert
    G, ng_e = expert_groups(cfg, group_size)

    def rows(w, g=G):  # (..., X, Fe, E) -> (..., X*Fe/g, g, E)
        return w.reshape(w.shape[:-3] + (w.shape[-3] * w.shape[-2] // g, g, E))

    def bias_rows(b):  # (..., X, Fe) -> (..., X*ng_e, G)
        return b.reshape(b.shape[:-2] + (X * ng_e, G))

    out = dict(lp)
    out["moe_up_rows"] = rows(lp["w_up_exps"])
    if "w_gate_exps" in lp:
        out["moe_gate_rows"] = rows(lp["w_gate_exps"])
    out["moe_down_rows"] = rows(lp["w_down_exps"])
    if "w_up_exps_b" in lp:
        out["moe_up_b_rows"] = bias_rows(lp["w_up_exps_b"])
    if "w_gate_exps_b" in lp:
        out["moe_gate_b_rows"] = bias_rows(lp["w_gate_exps_b"])
    if "w_up_chexps" in lp:
        Gc = expert_groups(cfg, group_size, lp["w_up_chexps"].shape[-2])[0]
        for nm in ("up", "gate", "down"):
            out[f"moe_{nm}_ch_rows"] = rows(lp[f"w_{nm}_chexps"], Gc)
    return out


def moe_params(params: dict, cfg: ModelConfig, group_size: int = 128) -> dict:
    """params with `moe_layout`'s row stores in every stack that holds
    experts (params["layers"], or each of params["layer_segments"]: the
    JAX Engine lays out each segment), the expert stacks themselves left
    out of the new stacks (the rows are views of them); the model's own
    params are not changed."""
    def rows(lay):
        if "w_up_exps" not in lay:
            return lay
        lay = moe_layout(lay, cfg, group_size)
        for k in ("w_up_exps", "w_gate_exps", "w_down_exps", "w_up_chexps", "w_gate_chexps",
                  "w_down_chexps"):
            lay.pop(k, None)
        return lay

    segs = params.get("layer_segments")
    if segs is None:
        return {**params, "layers": rows(params["layers"])}
    segs = [rows(s) for s in segs]
    return {**params, "layers": segs[0], "layer_segments": segs}


def route(cfg: ModelConfig, lp: dict, xt: torch.Tensor, norm_topk: bool | None = None):
    """xt (N, E) -> (expert ids (N, k) int32, weights (N, k) f32)."""
    if norm_topk is None:
        norm_topk = cfg.norm_topk_prob
    if "router_logits" in lp:
        # smallthinker lookahead routing: logits from the layer's input
        logits = lp["router_logits"].reshape(-1, cfg.n_expert).float()
    else:
        logits = (xt @ lp["w_router"].to(xt.dtype)).float()  # (N, X)
    if "w_router_b" in lp:  # gpt-oss router bias (on the logits)
        logits = logits + lp["w_router_b"].float()
    if cfg.expert_gating == "sigmoid":
        probs = torch.sigmoid(logits)
    elif cfg.expert_gating == "softmax_topk":
        probs = logits  # select on raw logits, softmax over the k selected
    else:
        probs = torch.softmax(logits, dim=-1)
    sel = probs
    if "router_bias" in lp:  # deepseek3 score correction: selection only
        sel = probs + lp["router_bias"].float()
    idx = torch.sort(sel, dim=-1, descending=True, stable=True).indices[..., :cfg.n_expert_used]
    w = torch.gather(probs, -1, idx)
    if cfg.expert_gating == "softmax_topk":
        w = torch.softmax(w, dim=-1)
    if norm_topk:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.expert_weights_scale:
        w = w * cfg.expert_weights_scale
    return idx.to(torch.int32), w


def _shared_expert(cfg: ModelConfig, lp: dict, xt: torch.Tensor, act: str) -> torch.Tensor:
    """The always-on shared expert added to the routed output (qwen2moe
    ffn_*_shexp, with its sigmoid gate scalar where it has one)."""
    up = xt @ lp["w_up_shexp"].to(xt.dtype)
    if "w_gate_shexp" in lp:
        gate = (xt @ lp["w_gate_shexp"].to(xt.dtype)).float()
        g = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
        hidden = g.to(up.dtype) * up
    else:
        hidden = F.silu(up.float()).to(up.dtype)
    out = hidden @ lp["w_down_shexp"].to(hidden.dtype)
    if "w_gate_inp_shexp" in lp:
        g = torch.sigmoid((xt @ lp["w_gate_inp_shexp"].to(xt.dtype)).float())
        out = out * g[..., None].to(out.dtype)
    return out


def expert_rows(idx: torch.Tensor, ng_e: int) -> torch.Tensor:
    """Expert ids (N, k) -> their group rows (N, k*ng_e), expert by expert."""
    offs = torch.arange(ng_e, dtype=idx.dtype, device=idx.device)
    return (idx[:, :, None] * ng_e + offs).reshape(idx.shape[0], -1)


def make_moe_ffn(cfg: ModelConfig, group_size: int = 128, mode: str = "pallas",
                 norm_topk: bool | None = None):
    """ffn(lp, x) for make_forward. lp needs w_router and the expert stacks
    (dense) or `moe_layout`'s row stores (pallas). "pallas" runs the v1 row
    kernel on a CUDA tensor and its plain version on a CPU one."""
    if mode not in MODES:
        raise ValueError(f"moe mode {mode!r} (one of {MODES})")
    E, k = cfg.n_embd, cfg.n_expert_used
    if not (cfg.n_expert > 0 and k > 0):
        raise ValueError("a MoE FFN needs n_expert and n_expert_used")
    G, ng_e = expert_groups(cfg, group_size)
    act = cfg.traits.act
    gated, actf = act_fn(act)
    if mode == "pallas" and act not in GATED_ACTS_V1:  # as the JAX row kernel refuses it
        raise NotImplementedError(f"the fused MoE mode with the {act} activation "
                                  f"(smallthinker's experts) is not ported: the row kernel "
                                  f"has no such activation; run moe_mode='dense'")

    def experts(xt, up_w, gate_w, down_w, up_b=None, gate_b=None):
        """Each token's k experts over the gathered stacks (N, k, Fe, E):
        (N, k, E), before the router weights."""
        up = torch.einsum("ne,nkfe->nkf", xt, up_w.to(xt.dtype))
        if up_b is not None:
            up = up + up_b.to(up.dtype)
        if gate_w is None:
            hidden = F.silu(up.float()).to(up.dtype)
        else:
            gate = torch.einsum("ne,nkfe->nkf", xt, gate_w.to(xt.dtype))
            if gate_b is not None:
                gate = gate + gate_b.to(gate.dtype)
            hidden = actf(gate, up) if gated else actf(up)
        return torch.einsum("nkf,nkfe->nke", hidden, down_w.to(hidden.dtype))

    def dense(lp, x):
        B, T, _ = x.shape
        xt = x.reshape(B * T, E)
        idx, w = route(cfg, lp, xt, norm_topk)
        il = idx.long()

        def take(key):
            return lp[key][il] if key in lp else None

        out = experts(xt, lp["w_up_exps"][il], take("w_gate_exps"), lp["w_down_exps"][il],
                      take("w_up_exps_b"), take("w_gate_exps_b"))
        if "w_down_exps_b" in lp:
            out = out + lp["w_down_exps_b"][il].to(out.dtype)
        out = (out * w[..., None].to(out.dtype)).sum(1)
        if "w_up_chexps" in lp and cfg.n_group_experts > 0:
            # grovemoe adjugate experts: the routed OUTPUT feeds chunk experts
            # selected by expert id // experts_per_group, with the same router
            # weights, scaled by expert_group_scale
            ci = (idx // cfg.n_group_experts).long()
            adj = experts(out.to(xt.dtype), lp["w_up_chexps"][ci], lp["w_gate_chexps"][ci],
                          lp["w_down_chexps"][ci])
            out = out + cfg.expert_group_scale * (adj * w[..., None].to(adj.dtype)).sum(1)
        if "w_up_shexp" in lp:
            out = out + _shared_expert(cfg, lp, xt, act).to(out.dtype)
        return out.reshape(B, T, E).to(x.dtype)

    def pallas(lp, x):
        B, T, _ = x.shape
        N = B * T
        xt = x.reshape(N, E)
        idx, w = route(cfg, lp, xt, norm_topk)
        rows = expert_rows(idx, ng_e)  # (N, k*ng_e)
        scale = w[:, :, None, None].float().expand(N, k, ng_e, G).reshape(N, k * ng_e, G)
        bu_sel = lp["moe_up_b_rows"][rows.long()] if "moe_up_b_rows" in lp else None
        bg_sel = lp["moe_gate_b_rows"][rows.long()] if "moe_gate_b_rows" in lp else None
        out = sparse_ffn_block(xt, rows, scale, lp["moe_up_rows"], lp.get("moe_gate_rows"),
                               lp["moe_down_rows"], act=act, mask_mode="scale",
                               bu_sel=bu_sel, bg_sel=bg_sel)
        if "w_down_exps_b" in lp:  # per (expert, E): mixed with the router weights
            db = lp["w_down_exps_b"][idx.long()]  # (N, k, E)
            out = out + (db * w[..., None]).sum(1).to(out.dtype)
        if "moe_up_ch_rows" in lp and cfg.n_group_experts > 0:
            # grovemoe: the chunk experts of expert id // experts_per_group on
            # the routed output, a second call of the row kernel (the JAX
            # package's fused mode leaves them out; its dense mode has them)
            Rc, Gc = lp["moe_up_ch_rows"].shape[-3:-1]
            ng_c = Rc // (cfg.n_expert // cfg.n_group_experts)  # groups a chunk expert
            crows = expert_rows(idx // cfg.n_group_experts, ng_c)
            cscale = w[:, :, None, None].float().expand(N, k, ng_c, Gc).reshape(N, k * ng_c, Gc)
            adj = sparse_ffn_block(out.to(xt.dtype), crows, cscale, lp["moe_up_ch_rows"],
                                   lp["moe_gate_ch_rows"], lp["moe_down_ch_rows"], act=act,
                                   mask_mode="scale")
            out = out + cfg.expert_group_scale * adj
        if "w_up_shexp" in lp:
            out = out + _shared_expert(cfg, lp, xt, act).to(out.dtype)
        return out.reshape(B, T, E).to(x.dtype)

    return {"dense": dense, "pallas": pallas}[mode]


# ---------------------------------------------------------------------------
# expert tiering


def moe_rows_layout(lp: dict, cfg: ModelConfig, group_size: int = 128) -> dict:
    """The L-stacked expert stacks as the tiering machinery's row stores
    w_up_rows / w_gate_rows / w_down_rows (L, X*ng_e, G, E), views: expert e
    owns groups [e*ng_e, (e+1)*ng_e). Fed to init_tiered, MoEColdStore and
    Balancer they tier whole experts."""
    E, X = cfg.n_embd, cfg.n_expert
    G, ng_e = expert_groups(cfg, group_size)
    out = dict(lp)
    for name in ("up", "gate", "down"):
        w = lp.get(f"w_{name}_exps")
        if w is not None:
            out[f"w_{name}_rows"] = w.reshape(w.shape[:-3] + (X * ng_e, G, E))
    return out


class MoEColdStore:
    """Every expert's rows in host RAM, and the host complement of a layer's
    cold routed experts. The storage contract of tiering.ColdStore (up, gate,
    down: (L, ng, G, E) torch tensors on the host), so the Balancer drives
    it unchanged. dtype: f16 by default, as the JAX package keeps it."""

    def __init__(self, cfg: ModelConfig, scfg, layers: dict, dtype: torch.dtype = torch.float16):
        self.dtype = dtype
        self.up = host_rows(layers["w_up_rows"], dtype)
        self.gate = (host_rows(layers["w_gate_rows"], dtype)
                     if "w_gate_rows" in layers else None)
        self.down = host_rows(layers["w_down_rows"], dtype)
        L, ng, G, E = self.up.shape
        self.ng_e = expert_groups(cfg, scfg.group_size)[1]
        self.act = cfg.traits.act
        k, f32 = cfg.n_expert_used, torch.float32
        self.staging = PinnedStaging(x=((E,), f32), idx=((k,), torch.int32), wts=((k,), f32),
                                     hot=((k,), torch.bool), out=((E,), f32))
        self.n_calls = 0
        print(f"moe cold store: {str(dtype).replace('torch.', '')}, {self.nbytes} bytes of "
              f"host RAM ({L} layers x {ng} groups x {G} rows)", file=sys.stderr, flush=True)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.up, self.gate, self.down) if t is not None)

    def _complement(self, l: int, x: np.ndarray, idx: np.ndarray, wts: np.ndarray,
                    expert_hot: np.ndarray, out: np.ndarray) -> np.ndarray:
        """The JAX package's complement_moe in numpy, its order of sums:
        out[n] += w * (h @ D) for each cold routed expert, in routing order."""
        N, E = x.shape
        ge = self.ng_e
        out[:] = 0.0
        up, down = self.up[l].numpy(), self.down[l].numpy()
        gate = None if self.gate is None else self.gate[l].numpy()
        for n in range(N):
            for j in range(idx.shape[1]):
                if expert_hot[n, j]:
                    continue
                sl = slice(int(idx[n, j]) * ge, (int(idx[n, j]) + 1) * ge)
                u = x[n] @ up[sl].reshape(-1, E).astype(np.float32).T
                if gate is not None:
                    g = x[n] @ gate[sl].reshape(-1, E).astype(np.float32).T
                    if self.act == "geglu":
                        h = 0.5 * g * (1.0 + np.tanh(
                            math.sqrt(2.0 / math.pi) * (g + 0.044715 * g ** 3))) * u
                    else:  # silu
                        h = g / (1.0 + np.exp(-g)) * u
                else:
                    h = u / (1.0 + np.exp(-u))
                D = down[sl].reshape(-1, E).astype(np.float32)
                out[n] += float(wts[n, j]) * (h @ D)
        return out

    def complement_moe(self, il: int, x: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor,
                       expert_hot: torch.Tensor) -> torch.Tensor:
        """x (N, E) f32, idx / wts / expert_hot (N, k), on the CPU or the card
        -> (N, E) f32 on x's device: the cold routed experts' contribution.
        On the card the inputs go to the pinned staging set, the stream is
        waited for, the host computes, and the result goes back on the
        stream."""
        self.n_calls += 1
        N, E = x.shape
        if x.device.type == "cpu":
            out = np.empty((N, E), np.float32)
            return torch.from_numpy(self._complement(
                int(il), x.float().numpy(), idx.numpy(), wts.float().numpy(),
                expert_hot.numpy(), out))
        xh, ih, wh, hh, oh = self.staging.rows(N, x.device)
        for dst, src in ((xh, x), (ih, idx), (wh, wts), (hh, expert_hot)):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        self._complement(int(il), xh.numpy(), ih.numpy(), wh.numpy(), hh.numpy(), oh.numpy())
        # the next layer writes oh only after its own wait on the stream
        return oh.to(x.device, non_blocking=True)


def make_tiered_moe_ffn(cfg: ModelConfig, scfg, cold: MoEColdStore | None,
                        mode: str = "drop"):
    """Expert-tiered ffn(lp, x, fs, il) -> y for make_forward(...,
    stateful_ffn=True), updating the DFRState fs in place. The hot experts'
    groups live in the flat hot store (params["sparse_flat"], the tiered
    FFN's layout: up/gate transposed (L*H, E, G), down (L*H, G, E)); lp
    carries group_map. A cold expert's groups read slot 0 with a zero
    weight; mode "drop" loses its contribution, "host" adds it from the
    cold store (eager steps only: a round trip to the host a layer).

    The math is the JAX package's plain gather math over the hot store; the
    DFR is each group's routed frequency (all of an expert's groups move
    together), `miss` counts the cold routed experts."""
    if mode not in TIERED_MODES:
        raise ValueError(f"tiered MoE mode {mode!r} (one of {TIERED_MODES})")
    if cfg.n_dense_lead > 0:
        raise NotImplementedError("expert tiering over layer segments (deepseek2's leading "
                                  "dense layers) is not ported yet")
    # the JAX package's tiered FFN computes neither: it would run arctic's
    # MoE in place of its dense FFN and drop grovemoe's chunk experts
    if cfg.traits.parallel_moe:
        raise NotImplementedError("expert tiering of arctic's parallel MoE block is not "
                                  "ported yet")
    if cfg.n_group_experts > 0:
        raise NotImplementedError("expert tiering with grovemoe's chunk experts is not "
                                  "ported yet")
    if mode == "host" and cold is None:
        raise ValueError("mode='host' needs a MoEColdStore")
    E, k, L = cfg.n_embd, cfg.n_expert_used, cfg.n_layer
    G, ng_e = expert_groups(cfg, scfg.group_size)
    ng = cfg.n_expert * ng_e
    act = cfg.traits.act
    lam = scfg.dfr_decay
    gated, actf = act_fn(act)

    def ffn(lp: dict, x: torch.Tensor, fs: DFRState, il: int) -> torch.Tensor:
        H = lp["hot_upT_flat"].shape[0] // L
        B, T, _ = x.shape
        N = B * T
        xt = x.reshape(N, E)
        idx, w = route(cfg, lp, xt)
        rows = expert_rows(idx, ng_e).long()  # (N, C)
        slots = lp["group_map"][rows]
        hot = slots >= 0
        flat = slots.clamp_min(0).long() + il * H
        up = torch.einsum("ne,nceg->ncg", xt, lp["hot_upT_flat"][flat].to(xt.dtype))
        gate = None
        if lp.get("hot_gateT_flat") is not None:
            gate = torch.einsum("ne,nceg->ncg", xt, lp["hot_gateT_flat"][flat].to(xt.dtype))
        hidden = (actf(gate, up) if gated and gate is not None
                  else F.silu(up.float()).to(up.dtype))
        # the router weight on each expert's groups, zero on a cold expert's
        scale = w[:, :, None].expand(N, k, ng_e).reshape(N, k * ng_e)
        scale = torch.where(hot, scale, 0.0)
        hidden = hidden * scale[..., None].to(hidden.dtype)
        out = torch.einsum("ncg,ncge->ne", hidden,
                           lp["hot_down_flat"][flat].to(hidden.dtype)).float()
        expert_hot = hot.reshape(N, k, ng_e).all(-1)  # (N, k)
        if mode == "host":
            out = out + cold.complement_moe(il, xt.float(), idx, w.float(), expert_hot)
        if "w_up_shexp" in lp:
            out = out + _shared_expert(cfg, lp, xt, act).to(out.dtype)
        fired = torch.zeros((ng,), dtype=torch.float32, device=x.device).index_add_(
            0, rows.reshape(-1), torch.ones((rows.numel(),), device=x.device)) / N
        dfr = fs.dfr[il]
        dfr.copy_(lam * dfr + (1.0 - lam) * fired if scfg.dfr_ema else dfr + fired)
        fs.miss[il].add_((~expert_hot).sum())
        fs.steps[il].add_(1.0)
        return out.reshape(B, T, E).to(x.dtype)

    return ffn
