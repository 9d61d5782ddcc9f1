"""Static KV cache, the port of sparkinfer_tpu/runtime/kv_cache.py.

Each batch slot owns a static (max_seq, n_head_kv, head_dim) region: slot b,
position p lives at cache.k[:, b, p]. The JAX cache is functional (every
write returns a new array); here writes go into the tensors in place, so
the forward needs no copy of the cache, and a context shift (`shift_cache`)
moves rows inside the same tensors, so a CUDA graph captured over the cache
reads the shifted rows. The int8 and iSWA caches come later.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

if TYPE_CHECKING:
    from ..models.config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, Hkv, D)
    v: torch.Tensor  # (L, B, S, Hkv, D)

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: "ModelConfig", batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.n_layer, batch, max_seq, cfg.n_head_kv, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def slot_view(cache: KVCache, s_i: int) -> KVCache:
    """The (L, 1, S, Hkv, D) view of slot s_i: a forward over it reads and
    writes the slot's rows of `cache` in place (the JAX Scheduler gathers a
    copy and scatters it back, runtime/scheduler.py:843-860)."""
    return KVCache(k=cache.k[:, s_i:s_i + 1], v=cache.v[:, s_i:s_i + 1])


def write_layer(kc: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> None:
    """Write new (B, T, Hkv, D) into one layer's (B, S, Hkv, D) storage at
    positions (B, T), in place. Positions are clamped into the cache, as the
    JAX write is; slots past max_seq are rejected upstream."""
    B, T = positions.shape
    b_idx = torch.arange(B, device=kc.device)[:, None].expand(B, T)
    pos = positions.clamp(0, kc.shape[1] - 1)
    kc[b_idx, pos] = new.to(kc.dtype)


def read_layer(kc: torch.Tensor, dtype) -> torch.Tensor:
    return kc.to(dtype)


def shift_cache(cache: KVCache, rp, keep: int, discard: int, n_past: int) -> KVCache:
    """Context shift (ref: llama.cpp context shift / llama_kv_cache_seq_add),
    in place: drop rows [keep, keep+discard) of every slot and slide rows
    [keep+discard, n_past) down by `discard`, re-rotating K by -discard
    positions (RoPE is additive in the angle, so a constant rotation
    relabels the rows). Rows [n_past-discard, n_past) keep stale values that
    the causal mask hides until they are written again. Returns `cache`."""
    from ..ops.rope import apply_rope

    src, dst = slice(keep + discard, n_past), slice(keep, n_past - discard)
    seg = cache.k[:, :, src].float()
    pos = torch.full((seg.shape[2],), -discard, dtype=torch.long, device=seg.device)
    cache.k[:, :, dst] = apply_rope(seg, pos, rp).to(cache.k.dtype)
    cache.v[:, :, dst] = cache.v[:, :, src].clone()
    return cache
