"""LoRA adapters and control vectors, the port of sparkinfer_tpu/models/lora.py
(ref: src/llama-adapter.cpp and convert_lora_to_gguf.py's adapter GGUF).

Adapter GGUF: `general.type = "adapter"`, `adapter.type = "lora"`,
`adapter.lora.alpha`, and per target `<gguf-tensor-name>.lora_a` (r, in) and
`.lora_b` (out, r). The merged form W' = W + s*(B@A)^T (s = scale * alpha /
r) equals the reference's per-matmul W x + s B (A x), so an adapter is
merged into the params once: `apply_lora` returns new params, as the JAX
function does. A control vector (`direction.{l}` tensors) is a per-layer
bias of the residual stream, `layers["cvec"]`, which the forward adds.

`LoraMerger` re-merges adapters at new scales in place (the server's
`/lora-adapters`): it keeps the base slices of the weights the adapters
touch and writes base + deltas into the dense weights and into every sparse
store built from them (the v1 row stores w_*_rows (L, ng, G, E) and the v6
flat stores w_*T_flat (L*ng, E, G) and w_down_flat (L*ng, G, E)), so the
step graphs, which hold those tensors, read the merged weights at their
next replay. Packed (Q4_0/Q8_0) weights, W8A8 attention (--attn-w8a8),
Q8_0 stores and tiered hot stores cannot be merged and raise, as do
adapters and control vectors over layer segments (deepseek2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..ops.quant_matmul import W8A8Tensor, is_quantized
from .config import ModelConfig
from .transformer import one_stack

# gguf tensor base name -> params key
_TARGETS = {
    "attn_q": "wq",
    "attn_k": "wk",
    "attn_v": "wv",
    "attn_output": "wo",
    "ffn_up": "w_up",
    "ffn_gate": "w_gate",
    "ffn_down": "w_down",
}


def load_lora(path: str) -> dict:
    """Returns {"alpha": float, "deltas": {(layer, key): (A, B)}} with
    A (r, in), B (out, r) f32 numpy."""
    r = GGUFReader(path)
    alpha = float(r.kv.get("adapter.lora.alpha", 16.0))
    deltas: dict[tuple[int, str], tuple[np.ndarray, np.ndarray]] = {}
    for name, t in r.tensors.items():
        if not name.endswith(".lora_a"):
            continue
        base = name[: -len(".lora_a")]
        b_t = r.tensors.get(base + ".lora_b")
        if b_t is None:
            continue
        parts = base.split(".")
        if parts[0] != "blk":
            continue
        key = _TARGETS.get(parts[2])
        if key is None:
            continue
        deltas[(int(parts[1]), key)] = (t.to_f32(), b_t.to_f32())
    r.close()
    return {"alpha": alpha, "deltas": deltas}


def _scaled_deltas(ad: dict, scale: float) -> dict:
    """{(layer, key): (s, A, B)}, s from the rank of any delta (as the JAX
    function takes it)."""
    deltas = ad["deltas"]
    r = next(iter(deltas.values()))[0].shape[0]
    s = scale * ad["alpha"] / max(r, 1)
    return {lk: (s, A, B) for lk, (A, B) in deltas.items()}


def _merge(w: torch.Tensor, s: float, A: np.ndarray, B: np.ndarray) -> torch.Tensor:
    """w (in, out) + s * (B @ A)^T, the delta made in f32 and added in w's
    dtype, as the JAX function adds it."""
    delta = (torch.tensor(B, device=w.device) @ torch.tensor(A, device=w.device)).T
    return w + delta.to(w.dtype) * s


def _w8a8_refusal(key: str) -> ValueError:
    # the JAX package fails here too (its merge indexes the W8A8 object)
    return ValueError(f"LoRA targets {key}, which --attn-w8a8 re-quantized to row-wise "
                      "W8A8: --lora and --attn-w8a8 cannot be combined for an adapter "
                      "of the attention projections")


def _dense_weight(layers: dict, key: str):
    w = layers.get(key)
    if isinstance(w, W8A8Tensor):
        raise _w8a8_refusal(key)
    if w is None or not isinstance(w, torch.Tensor) or is_quantized(w):
        raise ValueError(f"LoRA targets {key} but model has no such weight "
                         "(quantized-packed weights can't be merged; load "
                         "with keep_quantized=False)")
    return w


def apply_lora(params: dict, cfg: ModelConfig, path: str, scale: float = 1.0) -> dict:
    """Merge a LoRA adapter into (stacked) params: W' = W + s*(B@A)^T for
    the (in, out) weight orientation. Returns a new params dict (the merged
    weights new tensors, the rest shared)."""
    one_stack(params, "a LoRA adapter")
    ad = load_lora(path)
    if not ad["deltas"]:
        raise ValueError(f"{path}: no LoRA tensors found")
    layers = dict(params["layers"])
    for key in {k for _, k in ad["deltas"]}:
        layers[key] = _dense_weight(layers, key).clone()
    for (layer, key), (s, A, B) in _scaled_deltas(ad, scale).items():
        layers[key][layer] = _merge(layers[key][layer], s, A, B)
    return {**params, "layers": layers}


def load_control_vector(path: str, n_layer: int, n_embd: int) -> np.ndarray:
    """Read a control-vector GGUF (`direction.{l}` tensors) into an
    (n_layer, n_embd) array; absent layers stay zero (ref:
    llama_adapter_cvec pads missing directions)."""
    r = GGUFReader(path)
    cv = np.zeros((n_layer, n_embd), np.float32)
    found = False
    for name, t in r.tensors.items():
        if not name.startswith("direction."):
            continue
        il = int(name.split(".")[1])
        if 0 <= il < n_layer:
            cv[il] = t.to_f32().reshape(-1)[:n_embd]
            found = True
    r.close()
    if not found:
        raise ValueError(f"{path}: no direction.* tensors found")
    return cv


def apply_control_vector(params: dict, cfg: ModelConfig, vectors: np.ndarray,
                         scale: float = 1.0) -> dict:
    """vectors (L, E): the per-layer residual bias (ref: llama_adapter_cvec),
    stored f32 under layers["cvec"] on the params' device."""
    one_stack(params, "a control vector")
    dev = params["tok_embd"].device
    layers = dict(params["layers"])
    layers["cvec"] = torch.as_tensor(vectors * scale, dtype=torch.float32).to(dev)
    return {**params, "layers": layers}


def _stores(params: dict, key: str) -> list[tuple[str, torch.Tensor, str]]:
    """The tensors of `params` that hold weight `key`, each with its name and
    layout: "dense" (L, in, out), "rows_T" (L, ng, G, E) of an (E, F) weight,
    "rows" (L, ng, G, E) of an (F, E) weight, "flat_T" (L*ng, E, G), "flat"
    (L*ng, G, E)."""
    layers, flat = params["layers"], params.get("sparse_flat") or {}
    out = []
    if isinstance(layers.get(key), torch.Tensor):
        out.append((key, layers[key], "dense"))
    if key in ("w_up", "w_gate", "w_down"):
        n = key[2:]
        if f"w_{n}_rows" in layers:
            out.append((f"w_{n}_rows", layers[f"w_{n}_rows"],
                        "rows" if n == "down" else "rows_T"))
        name = "w_down_flat" if n == "down" else f"w_{n}T_flat"
        if name in flat:
            out.append((name, flat[name], "flat" if n == "down" else "flat_T"))
        for bad in (f"qw_{n}T_flat", "qw_down_flat", "w_all_rows"):
            if bad in flat or bad in layers:
                raise ValueError(f"a LoRA re-merge cannot write the store {bad}")
    elif isinstance(layers.get(key), W8A8Tensor):
        raise _w8a8_refusal(key)
    elif key in layers and is_quantized(layers[key]):
        raise ValueError(f"{key} is packed: a LoRA re-merge needs dense weights")
    return out


def _write(store: torch.Tensor, layout: str, il: int, w: torch.Tensor):
    """Write layer il's weight w (in, out) into `store`, in place."""
    if layout == "dense":
        store[il].copy_(w)
        return
    if layout in ("rows_T", "rows"):
        ng, G, E = store.shape[1:]
        store[il].copy_((w.T if layout == "rows_T" else w).reshape(ng, G, E))
        return
    if layout == "flat_T":  # (E, F) -> (ng, E, G)
        E, G = store.shape[1:]
        ng = w.shape[1] // G
        store[il * ng:(il + 1) * ng].copy_(w.reshape(E, ng, G).permute(1, 0, 2))
    else:  # "flat": (F, E) -> (ng, G, E)
        G, E = store.shape[1:]
        ng = w.shape[0] // G
        store[il * ng:(il + 1) * ng].copy_(w.reshape(ng, G, E))


class LoraMerger:
    """Adapters merged into `param_sets` (the model's params and the dicts a
    Scheduler or Engine built from them) at scales that `merge` changes, in
    place. The base slices of every (layer, weight) an adapter touches are
    kept (on the weights' device) from the first params set holding the
    dense weight."""

    def __init__(self, param_sets: list[dict], cfg: ModelConfig, paths: list[str]):
        for ps in param_sets:
            one_stack(ps, "a LoRA adapter")
        self.param_sets = param_sets
        self.adapters = []
        for p in paths:
            ad = load_lora(p)
            if not ad["deltas"]:
                raise ValueError(f"{p}: no LoRA tensors found")
            self.adapters.append(ad)
        keys = sorted({lk for ad in self.adapters for lk in ad["deltas"]})
        self.base = {}
        for il, key in keys:
            src = next((ps["layers"][key] for ps in param_sets
                        if isinstance(ps["layers"].get(key), torch.Tensor)),
                       param_sets[0]["layers"].get(key))
            self.base[(il, key)] = _dense_weight({key: src}, key)[il].clone()
        # every store of each weight, once (views of one storage written twice is harmless)
        self.stores = {key: [st for ps in param_sets for st in _stores(ps, key)]
                       for key in {k for _, k in keys}}

    @torch.inference_mode()
    def merge(self, scales: list[float]):
        """Write base + every adapter at its scale (0 skips it) into each
        store, adapters merged in order, as the JAX server re-merges."""
        per = [_scaled_deltas(ad, sc) if sc else {} for ad, sc in zip(self.adapters, scales)]
        for (il, key), base in self.base.items():
            w = base
            for deltas in per:
                if (il, key) in deltas:
                    w = _merge(w, *deltas[(il, key)])
            for _, store, layout in self.stores[key]:
                _write(store, layout, il, w)
