"""Offline model split and its file, the port of sparkinfer_tpu/sparse/split.py.

A model split is the profile the tiered path starts from: the group size,
a per-layer pattern that apportions the hot-store budget (layers whose
neurons fire more get more), and per layer a hot-first neuron permutation.
Its GGUF holds the KV `ffn_group_size`, the array `ffn_normalized_pattern`
and per layer the I32 tensor `blk.{l}.ffn_reorder_perms` (optionally the
F32 firing rates `blk.{l}.ffn_firing`).

  - `profile_firing`: calibration tokens through the masked-dense forward,
    counting each neuron's predicted firings;
  - `build_split`: firing rates -> pattern (each layer's share of the mean
    firing) and hot-first permutations;
  - `apply_reorder`: permute the neuron axis of the FFN weights and of the
    predictor's output (a relabelling: the model computes the same
    function), so co-hot neurons share groups;
  - `apportion`: a budget of hot groups -> per-layer counts;
  - `write_split` / `read_split`: the GGUF round trip, through the port's
    writer and reader.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from ..models.config import ModelConfig
from .config import SparseConfig
from .ffn import make_sparse_ffn
from .predictor import predict_activations


@dataclass
class ModelSplit:
    group_size: int
    pattern: np.ndarray  # (L,) f32 normalized
    perms: np.ndarray  # (L, F) int32: new row i holds old neuron perms[l, i]
    firing: np.ndarray | None = None  # (L, F) f32 mean firing rate (optional)


@torch.inference_mode()
def profile_firing(model, token_batches: list, scfg: SparseConfig,
                   max_seq: int = 512) -> np.ndarray:
    """Mean firing rate per neuron, (L, F): the fraction of calibration
    tokens whose predicted activation probability is >= threshold. Each
    batch of tokens runs as one prompt through the masked-dense forward,
    on the device of the model's params."""
    from ..models.transformer import make_forward
    from ..runtime.kv_cache import init_cache

    cfg: ModelConfig = model.config
    thr = scfg.threshold
    dense = make_sparse_ffn(cfg, scfg, mode="dense")

    def counting_ffn(lp, x, fs, il):
        probs = predict_activations(lp, x.reshape(-1, x.shape[-1]))
        fs["fired"][il] += (probs >= thr).float().sum(0)
        fs["tokens"][il] += float(probs.shape[0])
        return dense(lp, x)

    fwd = make_forward(cfg, ffn_fn=counting_ffn, stateful_ffn=True)
    dev = model.params["tok_embd"].device
    L, F = cfg.n_layer, cfg.n_ff
    fstate = {"fired": torch.zeros((L, F), dtype=torch.float32, device=dev),
              "tokens": torch.zeros((L, 1), dtype=torch.float32, device=dev)}
    for toks in token_batches:
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.long, device=dev)
        T = toks.shape[0]
        cache = init_cache(cfg, 1, min(max_seq, max(T, 8)), torch.float32, dev)
        pos = torch.arange(T, device=dev)[None]
        fwd(model.params, toks[None], pos, cache, fstate)
    fired = fstate["fired"].cpu().numpy()
    tokens = fstate["tokens"].cpu().numpy()
    return fired / np.maximum(tokens, 1.0)


def build_split(firing: np.ndarray, scfg: SparseConfig) -> ModelSplit:
    L, F = firing.shape
    # hot-first permutation per layer
    perms = np.argsort(-firing, axis=1, kind="stable").astype(np.int32)
    # per-layer pattern: share of total firing mass
    layer_mass = firing.mean(axis=1)
    total = layer_mass.sum()
    pattern = (layer_mass / total if total > 0 else np.full(L, 1.0 / L)).astype(np.float32)
    return ModelSplit(group_size=scfg.group_size, pattern=pattern, perms=perms,
                      firing=firing)


def apportion(budget_groups: int, pattern: np.ndarray, ng: int) -> np.ndarray:
    """Per-layer hot group counts: floor(budget * pattern), then the
    remainder round-robin by largest fraction, capped at ng (ref:
    src/llama-sparkinfer.cpp:179-202)."""
    L = len(pattern)
    raw = budget_groups * pattern
    counts = np.minimum(np.floor(raw).astype(np.int64), ng)
    rem = int(budget_groups - counts.sum())
    order = np.argsort(-(raw - counts), kind="stable")
    i = 0
    while rem > 0 and (counts < ng).any():
        l = order[i % L]
        if counts[l] < ng:
            counts[l] += 1
            rem -= 1
        i += 1
    return counts.astype(np.int32)


def apply_reorder(params: dict, cfg: ModelConfig, perms: np.ndarray,
                  inplace: bool = False, keys=None) -> dict:
    """Permute the neuron axis of the stacked layer weights by `perms`
    (hot-first): w_up / w_gate columns, w_down rows, b_up, and the
    predictor's outputs (pred_down columns, pred_down_b). The model computes
    the same function.

    inplace=True takes each tensor OUT of the caller's layers dict before
    its permuted copy is made, so at most one extra tensor is alive at a
    time, not a second model; the caller must own the tensors (the
    Engine's and Scheduler's split paths). The default leaves the caller's
    dict untouched and returns a new one. keys limits the permutation to a
    subset (the Scheduler's tiered prefill permutes the big FFN tensors on
    the host, in its row conversion, and only the small ones here)."""
    layers = params["layers"] if inplace else dict(params["layers"])
    L, F = perms.shape
    for k, axis in (("w_up", -1), ("w_gate", -1), ("w_down", 1), ("b_up", -1),
                    ("pred_down_b", -1), ("pred_down", -1)):
        if k in layers and (keys is None or k in keys):
            w = layers.pop(k) if inplace else layers[k]
            p = torch.as_tensor(perms, dtype=torch.long, device=w.device)
            shape = [L] + [1] * (w.dim() - 1)
            shape[axis] = F
            layers[k] = torch.take_along_dim(w, p.reshape(shape), dim=axis)
            del w
    out = dict(params)
    out["layers"] = layers
    return out


def write_split(path: str, split: ModelSplit, arch: str = "llama"):
    w = GGUFWriter(path, arch)
    w.add_kv("ffn_group_size", np.uint32(split.group_size))
    w.add_array("ffn_normalized_pattern", split.pattern.astype(np.float32))
    for l in range(split.perms.shape[0]):
        w.add_tensor(f"blk.{l}.ffn_reorder_perms", split.perms[l].astype(np.int32),
                     GGMLType.I32)
        if split.firing is not None:
            w.add_tensor(f"blk.{l}.ffn_firing", split.firing[l].astype(np.float32),
                         GGMLType.F32)
    w.write()


def read_split(path: str) -> ModelSplit:
    r = GGUFReader(path)
    gs = int(r.kv["ffn_group_size"])
    pattern = np.asarray(r.kv["ffn_normalized_pattern"], np.float32)
    L = len(pattern)
    perms = np.stack([r.tensors[f"blk.{l}.ffn_reorder_perms"].astype_np().astype(np.int32)
                      for l in range(L)])
    firing = None
    if "blk.0.ffn_firing" in r.tensors:
        firing = np.stack([r.tensors[f"blk.{l}.ffn_firing"].to_f32() for l in range(L)])
    r.close()
    return ModelSplit(group_size=gs, pattern=pattern, perms=perms, firing=firing)
