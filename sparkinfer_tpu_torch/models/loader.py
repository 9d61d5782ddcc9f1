"""GGUF -> torch params, the port of sparkinfer_tpu/models/loader.py for the
llama family (llama, mistral, prosparse_llama, bamboo).

The params dict has the JAX loader's keys and orientations, so the two
packages can be compared key for key: `x @ W` with W shaped (in, out),
per-layer tensors stacked on a leading L axis under params["layers"],
norms and biases in f32, and the low-rank predictor as pred_up (E, R),
pred_up_b (R,), pred_down (R, F), pred_down_b (F,), zero-padded to the
largest rank. Each stacked tensor is allocated once on the device and
filled layer by layer, so the host never holds the whole model in f32.

keep_quantized=True keeps Q4_0/Q8_0 linears packed on the device as
`QuantTensor`s (ops/quant_matmul.py), stacked over layers, the head too.

Later slices: attn_w8a8, MLA, layer segments, MoE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..ops.quant_matmul import REPACK, QuantTensor
from .config import ModelConfig
from .transformer import check_supported

Params = dict[str, Any]

# per-layer GGUF tensors the llama-family forward reads: suffix -> key
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm_w", "attn_q.weight": "wq",
    "attn_k.weight": "wk", "attn_v.weight": "wv", "attn_q.bias": "bq",
    "attn_k.bias": "bk", "attn_v.bias": "bv", "attn_output.weight": "wo",
    "attn_output.bias": "bo", "ffn_norm.weight": "ffn_norm_w",
    "ffn_up.weight": "w_up", "ffn_up.bias": "b_up", "ffn_gate.weight": "w_gate",
    "ffn_down.weight": "w_down", "ffn_down.bias": "b_down",
    "ffn_pred_up.weight": "pred_up", "ffn_pred_up.bias": "pred_up_b",
    "ffn_pred_down.weight": "pred_down", "ffn_pred_down.bias": "pred_down_b",
}


@dataclass
class LoadedModel:
    config: ModelConfig
    params: Params


def _host(arr: np.ndarray) -> torch.Tensor:
    # the reader's views are read-only mmaps; torch wants a writable array
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return _host(arr).to(device=device, dtype=dtype)


def _get(r: GGUFReader, name: str) -> np.ndarray | None:
    t = r.tensors.get(name)
    return None if t is None else t.to_f32()


def _linear(r: GGUFReader, name: str, in_dim: int, out_dim: int) -> np.ndarray | None:
    """Fetch a weight canonicalized to numpy (in_dim, out_dim)."""
    w = _get(r, name)
    if w is None:
        return None
    if w.shape == (out_dim, in_dim):
        return np.ascontiguousarray(w.T)
    if w.shape == (in_dim, out_dim):
        return w
    raise ValueError(f"{name}: shape {w.shape} matches neither "
                     f"({out_dim},{in_dim}) nor ({in_dim},{out_dim})")


_QUANT_KINDS = {GGMLType.Q4_0: "q4_0", GGMLType.Q8_0: "q8_0"}


def _linear_maybe_quant(r: GGUFReader, name: str, in_dim: int, out_dim: int,
                        keep_quantized: bool):
    """Like _linear, but when keep_quantized and the stored type is Q4_0 /
    Q8_0 in the standard (out, in) orientation with in % 32 == 0, return
    ("quant", kind, qw, scales): the packed rows repacked to the kernel's
    wire layout (ops/quant_matmul.py)."""
    t = r.tensors.get(name)
    if t is None:
        return None
    if (keep_quantized and t.ggml_type in _QUANT_KINDS
            and t.shape == (out_dim, in_dim) and in_dim % 32 == 0):
        kind = _QUANT_KINDS[t.ggml_type]
        qw, sc = REPACK[kind](t.raw(), out_dim, in_dim)
        return ("quant", kind, qw, sc)
    return _linear(r, name, in_dim, out_dim)


def _is_quant(w) -> bool:
    return isinstance(w, tuple) and w[0] == "quant"


def _check_supported(r: GGUFReader, cfg: ModelConfig):
    check_supported(cfg)
    for name in r.tensors:
        if name.startswith("blk.") and name.split(".", 2)[2] not in _LAYER_TENSORS:
            raise NotImplementedError(f"tensor {name} is not read by the port yet")


def load_model(path: str, dtype=torch.bfloat16, device=None,
               keep_quantized: bool = False) -> LoadedModel:
    """Load a llama-family GGUF into stacked torch tensors on `device`
    (None: the card; pass "cpu" to load on the CPU). keep_quantized=True
    keeps Q4_0/Q8_0 linears packed (QuantTensor) instead of dequantizing."""
    device = resolve_device(device)
    r = GGUFReader(path)
    try:
        cfg = ModelConfig.from_gguf(r)
        _check_supported(r, cfg)
        params = _load_params(r, cfg, dtype, device, keep_quantized)
    finally:
        r.close()
    return LoadedModel(config=cfg, params=params)


def _load_params(r: GGUFReader, cfg: ModelConfig, dtype, device,
                 keep_quantized: bool) -> Params:
    E, H, Hkv, D, F, L = (cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim,
                          cfg.n_ff, cfg.n_layer)
    f32 = torch.float32

    def _lin(name, in_dim, out_dim):
        return _linear_maybe_quant(r, name, in_dim, out_dim, keep_quantized)

    tok = _get(r, "token_embd.weight")
    params: Params = {"tok_embd": _tensor(tok, dtype, device)}
    onw = _get(r, "output_norm.weight")
    params["output_norm_w"] = _tensor(
        onw if onw is not None else np.ones(E, np.float32), f32, device)
    out_w = _lin("output.weight", E, cfg.n_vocab)
    if out_w is None:
        out_w = np.ascontiguousarray(tok.T)  # tied embeddings
    params["output"] = (QuantTensor.from_repack(out_w[2], out_w[3], out_w[1], device)
                        if _is_quant(out_w) else _tensor(out_w, dtype, device))

    max_rank = cfg.max_pred_rank
    layers: dict[str, torch.Tensor] = {}

    def add(i: int, key: str, arr):
        if arr is None:
            if key in layers:
                raise NotImplementedError(f"{key} missing in layer {i}: "
                                          "heterogeneous layers are not ported yet")
            return
        if key not in layers:
            if i > 0:
                raise NotImplementedError(f"{key} missing before layer {i}: "
                                          "heterogeneous layers are not ported yet")
            if _is_quant(arr):
                _, kind, qw, sc = arr
                layers[key] = QuantTensor(
                    torch.empty((L,) + qw.shape[::-1], dtype=_host(qw).dtype, device=device),
                    torch.empty((L,) + sc.shape[::-1], dtype=f32, device=device), kind)
            else:
                want = f32 if ("norm" in key or key.startswith("b")) else dtype
                layers[key] = torch.empty((L,) + arr.shape, dtype=want, device=device)
        dst = layers[key]
        if isinstance(dst, QuantTensor) != _is_quant(arr) or (
                _is_quant(arr) and arr[1] != dst.kind):
            raise ValueError(f"{key}: mixed quant kinds across layers")
        if _is_quant(arr):  # to the device, then transposed there to IN-major
            dst.q[i].copy_(_host(arr[2]).to(device).T)
            dst.s[i].copy_(_host(arr[3]).to(device).T)
        else:
            dst[i].copy_(_host(arr))

    for i in range(L):
        p = f"blk.{i}."
        anw = _get(r, p + "attn_norm.weight")
        add(i, "attn_norm_w", anw if anw is not None else np.ones(E, np.float32))
        add(i, "wq", _lin(p + "attn_q.weight", E, H * D))
        add(i, "wk", _lin(p + "attn_k.weight", E, Hkv * D))
        add(i, "wv", _lin(p + "attn_v.weight", E, Hkv * D))
        for nm, key in (("attn_q.bias", "bq"), ("attn_k.bias", "bk"),
                        ("attn_v.bias", "bv")):
            add(i, key, _get(r, p + nm))
        add(i, "wo", _lin(p + "attn_output.weight", H * D, E))
        add(i, "bo", _get(r, p + "attn_output.bias"))
        fnw = _get(r, p + "ffn_norm.weight")
        add(i, "ffn_norm_w", fnw if fnw is not None else np.ones(E, np.float32))
        add(i, "w_up", _lin(p + "ffn_up.weight", E, F))
        add(i, "b_up", _get(r, p + "ffn_up.bias"))
        add(i, "w_gate", _lin(p + "ffn_gate.weight", E, F))
        # ffn_down: sparse GGUFs store it transposed; _linear canonicalizes
        add(i, "w_down", _lin(p + "ffn_down.weight", F, E))
        add(i, "b_down", _get(r, p + "ffn_down.bias"))
        # predictor (low-rank ReLU MLP), zero-padded to the max rank
        pu = _linear(r, p + "ffn_pred_up.weight", E,
                     cfg.pred_lora[i] if cfg.pred_lora else 0)
        if pu is not None:
            rank = pu.shape[1]
            pub = _get(r, p + "ffn_pred_up.bias")
            pd = _linear(r, p + "ffn_pred_down.weight", rank, F)
            pdb = _get(r, p + "ffn_pred_down.bias")
            if rank < max_rank:
                pu = np.pad(pu, ((0, 0), (0, max_rank - rank)))
                pd = np.pad(pd, ((0, max_rank - rank), (0, 0)))
                if pub is not None:
                    pub = np.pad(pub, (0, max_rank - rank))
            add(i, "pred_up", pu)
            add(i, "pred_up_b", pub if pub is not None else np.zeros(max_rank, np.float32))
            add(i, "pred_down", pd)
            add(i, "pred_down_b", pdb if pdb is not None else np.zeros(F, np.float32))
        elif "pred_up" in layers:
            raise NotImplementedError(f"predictor missing in layer {i}")
    params["layers"] = layers
    return params
