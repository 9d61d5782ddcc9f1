"""Device / host-RAM neuron tiering, the port of
sparkinfer_tpu/sparse/tiering.py.

Hot neuron groups live on the card, cold ones in host RAM; decayed
firing-rate statistics (DFR), updated inside every step, drive the swaps
that `sparse/balancer.py` makes between steps.

  - The HOT store is flat over (layer, slot), up/gate transposed: v6's
    layout, block row il*H + slot, H hot groups a layer (`init_tiered`), in
    the model's dtype or Q8_0 (v6q's layout). `group_map` (L, ng) maps a
    group to its slot or -1 (cold); `hot_ids` (L, H) a slot to its group.
  - The COLD store (`ColdStore`) is every group's rows in host RAM, f16 by
    default (f32 where the host library has no _Float16). Cold groups that
    a token's predictor marks active (`cold_active`) are either computed by
    the host library (mode "host", exact: hot part on the card plus the
    complement), dropped (mode "drop"), or dropped and counted per group so
    the balancer brings them in at the next rebalance (mode "fetch").
  - The tiered FFN (`make_tiered_ffn`) selects each token's top-C groups
    from its own layer's predictor, runs the hot selections through
    `sparse_ffn_block_v6` (or `_v6q`) at rows il*H + slot, and a cold
    selection reads slot 0 with its probabilities zeroed, so it adds
    nothing. The sum per layer is: kernel output, plus the complement, plus
    b_down.

Everything the step reads or writes keeps its address: the balancer writes
the hot stores, their scales, `group_map` and `hot_ids` in place, and the
FFN updates the DFRState in place, so a CUDA graph of the step replays
over the current state. Host mode moves x, the probabilities and
cold_active to the host and the complement back at every layer, a
synchronization a graph cannot hold, so its steps run eagerly.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..models.config import ModelConfig
from ..ops.sparse_ffn import (
    quantize_rows_q8_0,
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
    sparse_ffn_block_v6q,
    sparse_ffn_block_v6q_plain,
)
from .config import SparseConfig
from .ffn import select_groups
from .predictor import predict_activations

MODES = ("host", "drop", "fetch")


def host_rows(w, dtype) -> torch.Tensor:
    """A contiguous host copy of a row store (L, ...) in `dtype`, made one
    layer at a time (so a card's store is never converted whole)."""
    w = torch.as_tensor(w)
    out = torch.empty(w.shape, dtype=dtype)
    for il in range(w.shape[0]):
        out[il].copy_(w[il])
    return out


class PinnedStaging:
    """Pinned host buffers for a layer's round trip between the card and the
    host, named with their per-row shape and dtype: one set a device, grown
    to the largest row count asked for, of which each call takes views of
    the first N rows. A prefill of any length thus reuses the one set; a
    buffer that a grown set replaces goes back to torch's pinned-memory
    cache, which holds it until the copies queued on it have run."""

    def __init__(self, **specs: tuple[tuple[int, ...], torch.dtype]):
        self.specs = specs
        self._sets: dict[str, tuple[int, tuple[torch.Tensor, ...]]] = {}

    def rows(self, N: int, device) -> tuple[torch.Tensor, ...]:
        """The buffers' first N rows, in the order of the specs."""
        key = str(device)
        have, bufs = self._sets.get(key, (0, ()))
        if N > have:
            bufs = tuple(torch.empty((N,) + shape, dtype=dtype, pin_memory=True)
                         for shape, dtype in self.specs.values())
            self._sets[key] = (N, bufs)
        return tuple(b[:N] for b in bufs)

    @property
    def nbytes(self) -> int:
        """The pinned bytes held, over every device's set."""
        return sum(b.numel() * b.element_size()
                   for _, bufs in self._sets.values() for b in bufs)


class ColdStore:
    """Every group's rows in host RAM, and the host complement of a layer.

    layers: the stacked row stores w_up_rows / w_down_rows (+ w_gate_rows,
    b_up), (L, ng, G, E), on the card or the host. dtype None: f16 where
    the host library has _Float16, else f32. The library is built here:
    there is no other way to compute the complement, so a failed build
    raises."""

    def __init__(self, cfg: ModelConfig, scfg: SparseConfig, layers: dict,
                 dtype: torch.dtype | None = None):
        self.cfg = cfg
        self.scfg = scfg
        if dtype is None:
            dtype = torch.float16 if native.has_f16() else torch.float32
        self.dtype = dtype
        self.up = host_rows(layers["w_up_rows"], dtype)
        self.gate = (host_rows(layers["w_gate_rows"], dtype)
                     if "w_gate_rows" in layers else None)
        self.down = host_rows(layers["w_down_rows"], dtype)
        L, ng, G, E = self.up.shape
        self.b_up = (host_rows(torch.as_tensor(layers["b_up"]).reshape(L, ng, G),
                                torch.float32) if "b_up" in layers else None)
        self.act = cfg.traits.sparse_act
        self.fatrelu_threshold = cfg.fatrelu_threshold
        f32 = torch.float32
        self.staging = PinnedStaging(x=((E,), f32), probs=((ng, G), f32),
                                     cold_active=((ng,), torch.bool), out=((E,), f32))
        self.t_call_s = 0.0  # the library's time, summed over calls
        self.t_layer_s = 0.0  # a layer's whole host part: copies, waits, the call
        self.n_calls = 0
        print(f"cold store: {str(dtype).replace('torch.', '')}, {self.nbytes} bytes of "
              f"host RAM ({L} layers x {ng} groups x {G} rows)", file=sys.stderr, flush=True)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.up, self.gate, self.down, self.b_up) if t is not None)

    def complement(self, il: int, x: torch.Tensor, probs: torch.Tensor,
                   cold_active: torch.Tensor) -> torch.Tensor:
        """x (N, E), probs (N, ng, G) f32, cold_active (N, ng) bool, on the CPU
        or the card -> (N, E) f32 on x's device. On the card x, probs and
        cold_active go to pinned host buffers, the stream is waited for, the
        library runs, and its result goes back on the stream."""
        t0 = time.perf_counter()
        N, E = x.shape
        ng, G = probs.shape[1:]
        args = (self.up[il], None if self.gate is None else self.gate[il], self.down[il],
                None if self.b_up is None else self.b_up[il])
        kw = dict(act=self.act, fatrelu_thr=self.fatrelu_threshold,
                  prob_thr=self.scfg.threshold)
        if x.device.type == "cpu":
            t1 = time.perf_counter()
            out = native.sparse_complement(x.float().contiguous(), *args,
                                           probs.float().contiguous(),
                                           cold_active.contiguous(), **kw)
            t2 = time.perf_counter()
        else:
            xh, ph, ch, oh = self.staging.rows(N, x.device)
            xh.copy_(x, non_blocking=True)
            ph.copy_(probs, non_blocking=True)
            ch.copy_(cold_active, non_blocking=True)
            torch.cuda.current_stream(x.device).synchronize()
            t1 = time.perf_counter()
            native.sparse_complement(xh, *args, ph, ch, out=oh, **kw)
            t2 = time.perf_counter()
            # the next layer writes oh only after its own wait on the
            # stream, which this copy precedes
            out = oh.to(x.device, non_blocking=True)
        self.t_call_s += t2 - t1
        self.t_layer_s += time.perf_counter() - t0
        self.n_calls += 1
        return out


class TieredParams(NamedTuple):
    """The card's tiered weight state, written in place by the balancer.

    The hot stores are FLAT over (layer, slot), up/gate transposed (v6's
    layout): block row il*H + slot."""

    hot_upT: torch.Tensor  # (L*H, E, G) model dtype, or int8 with s_upT
    hot_gateT: torch.Tensor | None
    hot_down: torch.Tensor  # (L*H, G, E)
    group_map: torch.Tensor  # (L, ng) int32: slot or -1
    hot_ids: torch.Tensor  # (L, H) int32: slot -> group id
    # Q8_0 per-32 scales (None: an unquantized store)
    s_upT: torch.Tensor | None = None  # (L*H, E/32, G) f32
    s_gateT: torch.Tensor | None = None
    s_down: torch.Tensor | None = None  # (L*H, G/32, E) f32

    @property
    def n_hot(self) -> int:
        return self.hot_ids.shape[1]

    @property
    def quantized(self) -> bool:
        return self.s_upT is not None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self if t is not None)


class DFRState(NamedTuple):
    """Per-layer statistics, updated in place by the tiered FFN."""

    dfr: torch.Tensor  # (L, ng) f32 decayed firing rate
    miss: torch.Tensor  # (L, 1) f32 active-but-cold group hits
    steps: torch.Tensor  # (L, 1) f32 forwards seen
    # fetch mode only: per-group cold∩active counts since the last
    # rebalance, which the balancer brings in first
    miss_g: torch.Tensor | None = None  # (L, ng) f32


def init_tiered(cfg: ModelConfig, scfg: SparseConfig, layers: dict, hot_groups: int,
                init_hot: np.ndarray | None = None, quant: str | None = None,
                track_miss_groups: bool = False, device=None
                ) -> tuple[TieredParams, DFRState]:
    """The first hot store, from the stacked row stores (L, ng, G, E) of
    `layers` (the card's or the host's), on `device` (default: the row
    stores' device). By default the FIRST H groups are hot, which after a
    split file's hot-first reorder are the profiled hottest. Rows on the
    host are gathered there and only the hot blocks are copied to the
    card. quant="q8_0" packs the hot store for v6q (quantized on `device`,
    one layer at a time)."""
    if quant not in (None, "q8_0"):
        raise ValueError(f"unsupported tiered store quant {quant!r}")
    L = cfg.n_layer
    w_up = torch.as_tensor(layers["w_up_rows"])
    ng = w_up.shape[1]
    H = min(hot_groups, ng)
    device = torch.device(device) if device is not None else w_up.device
    if init_hot is None:
        init_hot = np.tile(np.arange(H, dtype=np.int32), (L, 1))
    init_hot = np.asarray(init_hot, np.int32)
    gm = np.full((L, ng), -1, np.int32)
    for l in range(L):
        gm[l, init_hot[l]] = np.arange(H, dtype=np.int32)

    def gather(name, transpose):  # (L, ng, G, E) -> flat (L*H, ...) on device
        w = torch.as_tensor(layers[name])
        ids = torch.as_tensor(init_hot, dtype=torch.long, device=w.device)
        blocks = []
        for l in range(L):
            sel = w[l][ids[l]]  # (H, G, E)
            blocks.append((sel.transpose(-1, -2) if transpose else sel).contiguous())
        shape = (L * H,) + blocks[0].shape[1:]
        if quant is None:
            out = torch.empty(shape, dtype=w.dtype, device=device)
            for l in range(L):
                out[l * H:(l + 1) * H].copy_(blocks[l])
            return out, None
        B, C = shape[1:]
        q = torch.empty(shape, dtype=torch.int8, device=device)
        s = torch.empty((L * H, B // 32, C), dtype=torch.float32, device=device)
        for l in range(L):
            ql, sl = quantize_rows_q8_0(blocks[l].to(device))
            q[l * H:(l + 1) * H].copy_(ql)
            s[l * H:(l + 1) * H].copy_(sl)
        return q, s

    up, s_up = gather("w_up_rows", True)
    gate, s_gate = (gather("w_gate_rows", True) if "w_gate_rows" in layers
                    else (None, None))
    down, s_down = gather("w_down_rows", False)
    i32 = dict(dtype=torch.int32, device=device)
    tp = TieredParams(hot_upT=up, hot_gateT=gate, hot_down=down,
                      group_map=torch.tensor(gm, **i32), hot_ids=torch.tensor(init_hot, **i32),
                      s_upT=s_up, s_gateT=s_gate, s_down=s_down)
    f32 = dict(dtype=torch.float32, device=device)
    st = DFRState(dfr=torch.zeros((L, ng), **f32), miss=torch.zeros((L, 1), **f32),
                  steps=torch.zeros((L, 1), **f32),
                  miss_g=torch.zeros((L, ng), **f32) if track_miss_groups else None)
    return tp, st


def make_tiered_ffn(cfg: ModelConfig, scfg: SparseConfig, cold: ColdStore | None,
                    mode: str = "host", kernel: str = "kernel", stateless: bool = False):
    """ffn(lp, x, fs, il) -> y for make_forward(..., stateful_ffn=True),
    updating the DFRState fs in place (dfr, miss, steps; miss_g in fetch
    mode). lp carries group_map and the layer's predictor; the flat hot
    stores arrive through params["sparse_flat"].

    kernel "kernel" runs `sparse_ffn_block_v6` over a bf16/f32 hot store or
    `sparse_ffn_block_v6q` over a Q8_0 one (the CUDA kernels on the card,
    their plain versions on the CPU); "gather" runs the plain versions on
    any device. stateless=True returns ffn(lp, x) -> y (layer from
    lp["flat_il"], no statistics), for a fixed hot set."""
    if mode not in MODES:
        raise ValueError(f"tiered cold mode {mode!r} (one of {MODES})")
    if kernel not in ("kernel", "gather"):
        raise ValueError(f"tiered FFN kernel {kernel!r} (kernel or gather)")
    if mode == "host" and cold is None:
        raise ValueError("mode='host' needs a ColdStore")
    block = sparse_ffn_block_v6 if kernel == "kernel" else sparse_ffn_block_v6_plain
    block_q = sparse_ffn_block_v6q if kernel == "kernel" else sparse_ffn_block_v6q_plain
    act = cfg.traits.sparse_act
    G = scfg.group_size
    F = cfg.n_ff
    ng = scfg.n_groups(F)
    thr = scfg.threshold
    lam = scfg.dfr_decay
    L = cfg.n_layer

    def ffn(lp: dict, x: torch.Tensor, fs: DFRState | None, il: int) -> torch.Tensor:
        # the flat-store stride is the store's own hot-slot count
        q8 = "qhot_upT_flat" in lp
        H = lp["qhot_upT_flat" if q8 else "hot_upT_flat"].shape[0] // L
        B, T, E = x.shape
        N = B * T
        xt = x.reshape(N, E)
        probs = predict_activations(lp, xt)  # (N, F) f32
        gp = probs.reshape(N, ng, G)
        idx = select_groups(probs, scfg, F).long()  # (N, C) group ids
        gmap = lp["group_map"]  # (ng,)
        slots = gmap[idx]  # (N, C), -1 = cold
        hot = slots >= 0
        gp_sel = torch.gather(gp, 1, idx[..., None].expand(-1, -1, G))
        gp_hot = torch.where(hot[..., None], gp_sel, 0.0)
        bu_sel = None
        if "b_up" in lp:
            bu_sel = lp["b_up"].reshape(ng, G).float()[idx]
        rows = slots.clamp_min(0) + il * H
        kw = dict(act=act, fatrelu_threshold=cfg.fatrelu_threshold, prob_threshold=thr,
                  bu_sel=bu_sel)
        if q8:
            out = block_q(xt, rows, gp_hot, lp["qhot_upT_flat"], lp["s_hot_upT_flat"],
                          lp.get("qhot_gateT_flat"), lp.get("s_hot_gateT_flat"),
                          lp["qhot_down_flat"], lp["s_hot_down_flat"], **kw)
        else:
            out = block(xt, rows, gp_hot, lp["hot_upT_flat"], lp.get("hot_gateT_flat"),
                        lp["hot_down_flat"], **kw)
        active = gp >= thr  # (N, ng, G)
        cold_active = active.any(-1) & (gmap < 0)  # (N, ng)
        if mode == "host":
            out = out + cold.complement(il, xt, gp, cold_active)
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        y = out.reshape(B, T, E).to(x.dtype)
        if fs is None:
            return y
        # DFR EMA (ref: ggml_scale_add; delta = fired fraction per group)
        fired = active.float().sum(-1).sum(0) / (N * G)  # (ng,)
        dfr = fs.dfr[il]
        dfr.copy_(lam * dfr + (1.0 - lam) * fired if scfg.dfr_ema else dfr + fired)
        misses = cold_active.float()
        fs.miss[il].add_(misses.sum())
        fs.steps[il].add_(1.0)
        if mode == "fetch" and fs.miss_g is not None:
            fs.miss_g[il].add_(misses.sum(0))
        return y

    if stateless:
        def ffn_stateless(lp, x):
            return ffn(lp, x, None, lp["flat_il"])

        return ffn_stateless
    return ffn


def tiered_layer_params(layers: dict, tp: TieredParams) -> tuple[dict, dict]:
    """The tiered state for make_forward: (the layer dict, without the full
    row stores, with group_map; the flat dict for params["sparse_flat"],
    the hot stores). Both hold tp's tensors themselves, so the balancer's
    in-place writes reach every step that reads them."""
    out = {k: v for k, v in layers.items() if not k.endswith("_rows")}
    out["group_map"] = tp.group_map
    if tp.quantized:
        flat = {"qhot_upT_flat": tp.hot_upT, "s_hot_upT_flat": tp.s_upT,
                "qhot_down_flat": tp.hot_down, "s_hot_down_flat": tp.s_down}
        if tp.hot_gateT is not None:
            flat["qhot_gateT_flat"] = tp.hot_gateT
            flat["s_hot_gateT_flat"] = tp.s_gateT
    else:
        flat = {"hot_upT_flat": tp.hot_upT, "hot_down_flat": tp.hot_down}
        if tp.hot_gateT is not None:
            flat["hot_gateT_flat"] = tp.hot_gateT
    return out, flat
