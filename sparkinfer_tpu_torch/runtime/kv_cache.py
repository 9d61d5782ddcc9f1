"""Static KV cache, the port of sparkinfer_tpu/runtime/kv_cache.py.

Each batch slot owns a static (max_seq, n_head_kv, head_dim) region: slot b,
position p lives at cache.k[:, b, p]. The JAX cache is functional (every
write returns a new array); here writes go into the tensors in place, so
the forward needs no copy of the cache, and a context shift (`shift_cache`)
moves rows inside the same tensors, so a CUDA graph captured over the cache
reads the shifted rows.

The int8 cache (-ctk q8 -ctv q8, `quantized=True`) is the JAX package's:
int8 codes in k and v and an f32 scale a (token, head) in k_scale and
v_scale, (L, B, S, Hkv, 1), symmetric with scale = amax / 127
(`quantize_kv`); a read dequantizes into the compute dtype. `v_dtype` gives
a float V cache a dtype of its own (a split -ctv); reads cast both to the
compute dtype. Neither the MLA latent cache nor the iSWA cache takes int8
codes: `check_int8` raises ValueError for both (the JAX Engine's iSWA
cache drops the flag silently).

An MLA model (deepseek2, cfg.kv_lora_rank > 0) gets the JAX package's
latent cache: k (L, B, S, 1, R + Dr), each token's normed latent c_kv and
its one roped key head k_pe, and a zero-width v (L, B, S, 1, 0), since the
values decompress from the same latent. Its context shift rotates only the
k_pe tail (the JAX shift rotates the first rope_dim lanes of the slot, which
are lanes of c_kv, and leaves k_pe as it was), by a pure rotation; it has
no iSWA cache.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

if TYPE_CHECKING:
    from ..models.config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, Hkv, D), or in iSWA mode a tuple of per-run
    # buffers (n_run_layers, B, S_run, Hkv, D): a sliding run's S_run is its ring
    v: torch.Tensor  # as k
    k_scale: torch.Tensor | None = None  # (L, B, S, Hkv, 1) f32 in the int8 cache
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def iswa(self) -> bool:
        return isinstance(self.k, tuple)

    @property
    def max_seq(self) -> int:
        if self.iswa:
            return max(a.shape[2] for a in self.k)
        return self.k.shape[2]

    def buffers(self) -> tuple[torch.Tensor, ...]:
        """Every tensor of the cache, k's then v's, then the int8 cache's
        scales."""
        ks, vs = (self.k, self.v) if self.iswa else ((self.k,), (self.v,))
        scales = (self.k_scale, self.v_scale) if self.quantized else ()
        return tuple(ks) + tuple(vs) + scales


def check_int8(cfg: "ModelConfig", iswa: bool = False) -> None:
    """Raise ValueError where an int8 cache cannot hold the model's keys:
    the MLA latent cache (the JAX package asserts), the iSWA cache (the
    JAX package's drops the int8 codes silently) and a NAS stack whose
    attention layers hold different KV head counts (deci: the JAX forward
    narrows a layer's codes to its heads but not their scales, and fails)."""
    for cond, what in ((cfg.kv_lora_rank > 0,
                        "MLA (multi-head latent attention) latent cache, as in the JAX package"),
                       (len({h for h in cfg.n_head_kv_arr if h}) > 1,
                        "model whose layers hold different KV head counts (a NAS stack such "
                        "as deci): the JAX package's int8 cache fails on a layer narrower "
                        "than the cache"),
                       (iswa, "iSWA (sliding-window ring) cache: the JAX package's iSWA "
                              "cache has no int8 codes")):
        if cond:
            raise ValueError(f"the int8 KV cache (-ctk q8 -ctv q8) takes no {what}")


def init_cache(cfg: "ModelConfig", batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None, quantized: bool = False,
               v_dtype=None) -> KVCache:
    """The full cache: `dtype` storage (`v_dtype` for V where given, a split
    -ctv), or with quantized=True int8 codes and f32 scales."""
    if quantized:
        check_int8(cfg)
    v_dtype = dtype if v_dtype is None else v_dtype
    shape = (cfg.n_layer, batch, max_seq, cfg.n_head_kv, cfg.head_dim)
    if cfg.kv_lora_rank > 0:  # MLA: one latent slot a token, a zero-width v
        shape = (cfg.n_layer, batch, max_seq, 1, cfg.kv_lora_rank + cfg.rope_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape[:-1] + (0,), dtype=v_dtype, device=device))
    if quantized:
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(shape[:-1] + (1,), device=device),
                       v_scale=torch.zeros(shape[:-1] + (1,), device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=v_dtype, device=device))


def swa_runs(cfg: "ModelConfig") -> list[tuple[int, int, bool]]:
    """Contiguous (start, end, is_swa) layer runs of cfg.swa_layers."""
    flags = cfg.swa_layers
    runs = []
    s = 0
    for i in range(1, cfg.n_layer + 1):
        if i == cfg.n_layer or flags[i] != flags[s]:
            runs.append((s, i, flags[s]))
            s = i
    return runs


def init_cache_iswa(cfg: "ModelConfig", batch: int, max_seq: int, chunk: int = 64,
                    dtype=torch.bfloat16, device=None, v_dtype=None) -> KVCache:
    """The iSWA dual cache: each sliding run a ring of
    min(max_seq, sliding_window + chunk) slots, each full run max_seq.
    chunk is the longest forward the caller feeds: the keys a chunk writes
    must not overwrite keys its own earliest query still needs. v_dtype:
    V's storage dtype where it differs (a split -ctv). It has no int8 form
    (`check_int8`)."""
    v_dtype = dtype if v_dtype is None else v_dtype
    if cfg.kv_lora_rank > 0:
        raise ValueError("the iSWA cache takes no MLA (multi-head latent attention) model: "
                         "the latent cache is a full cache, as in the JAX package")
    ring = min(max_seq, cfg.sliding_window + chunk)
    ks, vs = [], []
    for s, e, is_swa in swa_runs(cfg):
        shape = (e - s, batch, ring if is_swa else max_seq, cfg.n_head_kv, cfg.head_dim)
        ks.append(torch.zeros(shape, dtype=dtype, device=device))
        vs.append(torch.zeros(shape, dtype=v_dtype, device=device))
    return KVCache(k=tuple(ks), v=tuple(vs))


def ring_room(cfg: "ModelConfig", cache: KVCache, max_seq: int) -> int | None:
    """The most tokens one forward may write into `cache`'s rings (a ring's
    slots less the window), or None where nothing bounds it (a full cache,
    or rings as wide as the sequence's max_seq, which never wrap)."""
    if not cache.iswa:
        return None
    rings = [kc.shape[2] for (_, _, is_swa), kc in zip(swa_runs(cfg), cache.k) if is_swa]
    if not rings or min(rings) >= max_seq:
        return None
    return min(rings) - cfg.sliding_window


def require_full(cache: KVCache, what: str) -> None:
    """Raise ValueError where `what` needs a full cache and gets an iSWA one."""
    if cache.iswa:
        raise ValueError(f"{what} needs a full KV cache: the iSWA cache (kv_iswa) has no "
                         "such path, as in the JAX package")


def require_per_head(cache: KVCache, what: str) -> None:
    """Raise ValueError where `what` rotates whole key heads and gets the MLA
    latent cache (a zero-width v), whose slots are no such heads."""
    require_full(cache, what)
    if cache.v.shape[-1] == 0:
        raise ValueError(f"{what} rotates whole key heads: the MLA (multi-head latent "
                         "attention) latent cache has no such path")


def cache_key(cache: KVCache) -> tuple:
    """What a CUDA graph over `cache` bakes in: its buffers' addresses,
    shapes and dtypes."""
    bufs = cache.buffers()
    return (tuple(b.data_ptr() for b in bufs), tuple(tuple(b.shape) for b in bufs),
            tuple(b.dtype for b in bufs))


def slot_view(cache: KVCache, s_i: int) -> KVCache:
    """The (L, 1, S, Hkv, D) view of slot s_i (per run in iSWA mode): a
    forward over it reads and writes the slot's rows of `cache` in place
    (the JAX Scheduler gathers a copy and scatters it back,
    runtime/scheduler.py:843-860)."""
    if cache.iswa:
        return KVCache(k=tuple(a[:, s_i:s_i + 1] for a in cache.k),
                       v=tuple(a[:, s_i:s_i + 1] for a in cache.v))
    return KVCache(*(None if a is None else a[:, s_i:s_i + 1] for a in cache))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8, as the JAX package's: x (..., D) ->
    (codes int8 (..., D), scale f32 (..., 1)), scale = amax / 127, codes
    round(x / max(scale, 1e-12)) in f32, half to even (jnp.round's)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    return torch.round(xf / scale.clamp_min(1e-12)).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def write_layer(kc: torch.Tensor, sc: torch.Tensor | None, new: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write new (B, T, Hkv, D) into one layer's (B, S, Hkv, D) storage at
    positions (B, T), in place: as int8 codes, and their scales into sc
    (B, S, Hkv, 1), where sc is given. Positions are clamped into the cache,
    as the JAX write is; slots past max_seq are rejected upstream."""
    B, T = positions.shape
    b_idx = torch.arange(B, device=kc.device)[:, None].expand(B, T)
    pos = positions.clamp(0, kc.shape[1] - 1)
    if sc is not None:
        q, s = quantize_kv(new)
        kc[b_idx, pos] = q
        sc[b_idx, pos] = s
        return
    kc[b_idx, pos] = new.to(kc.dtype)


def read_layer(kc: torch.Tensor, sc: torch.Tensor | None, dtype) -> torch.Tensor:
    """One layer's storage in the compute dtype, dequantized where sc is given."""
    if sc is not None:
        return dequantize_kv(kc, sc, dtype)
    return kc.to(dtype)


def shift_cache(cache: KVCache, rp, keep: int, discard: int, n_past: int) -> KVCache:
    """Context shift (ref: llama.cpp context shift / llama_kv_cache_seq_add),
    in place: drop rows [keep, keep+discard) of every slot and slide rows
    [keep+discard, n_past) down by `discard`, re-rotating K by -discard
    positions (RoPE is additive in the angle, so a constant rotation
    relabels the rows). Rows [n_past-discard, n_past) keep stale values that
    the causal mask hides until they are written again. Over the int8
    cache the moved K rows are dequantized to f32, rotated and quantized
    again, and the V codes and V scales move unchanged, as in the JAX
    package. Over an MLA latent cache (a zero-width v) only the last rp.dim
    lanes, k_pe, rotate, by a pure rotation (no yarn magnitude), and c_kv
    moves unchanged. Returns `cache`."""
    from ..ops.rope import apply_rope, rope_cos_sin, rope_freqs, rotate

    require_full(cache, "the context shift")
    src, dst = slice(keep + discard, n_past), slice(keep, n_past - discard)
    seg = cache.k[:, :, src].float()
    if cache.quantized:  # dequantized to f32
        seg = seg * cache.k_scale[:, :, src]
    pos = torch.full((seg.shape[2],), -discard, dtype=torch.long, device=seg.device)
    if cache.v.shape[-1] == 0:  # the MLA latent cache: [c_kv; k_pe] a slot
        cos, sin = rope_cos_sin(pos, rp)
        mscale = rope_freqs(rp)[1]  # the shift undoes no yarn magnitude
        tail = seg[..., -rp.dim:]
        seg[..., -rp.dim:] = rotate(tail, cos / mscale, sin / mscale, rp)
        cache.k[:, :, dst] = seg.to(cache.k.dtype)
        return cache
    if cache.quantized:
        cache.k[:, :, dst], cache.k_scale[:, :, dst] = quantize_kv(apply_rope(seg, pos, rp))
        cache.v_scale[:, :, dst] = cache.v_scale[:, :, src].clone()
    else:
        cache.k[:, :, dst] = apply_rope(seg, pos, rp).to(cache.k.dtype)
    cache.v[:, :, dst] = cache.v[:, :, src].clone()
    return cache
