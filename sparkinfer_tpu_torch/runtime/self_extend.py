"""Self-Extend group attention, the port of sparkinfer_tpu/runtime/self_extend.py
(the analogue of the reference's grp_attn_n/grp_attn_w context extension,
tools/main/main.cpp:845-1010: llama_memory_seq_add/seq_div triplets).

The label maps are numpy on the host, as in the JAX package; the
re-rotation writes the keys back into the cache's own tensor, so a CUDA
graph captured over the cache reads the rotated keys.

The reference's cell-based KV cache relabels cell POSITIONS (add, div,
add) and lazily re-rotates K by the label delta.  This cache is
slot-indexed (slot == physical position), so the same geometry is
produced without moving any data: every firing computes the per-slot
label delta on the host and applies ONE vectorised RoPE re-rotation over
the live cache region.  Queries and the causal mask keep using physical
positions; because RoPE is additive in the angle, rotating each key by
(new_label - old_label) makes every q·k pair see the grouped relative
distance label(p_q) - label(p_k) while slot order (and thus causality)
is untouched.

Net effect per firing (main.cpp:992-1004): the oldest un-grouped window
of ga_w labels is compressed ga_n-to-1 and everything above slides down
by bd = ga_w - ga_w/ga_n, keeping all rope angles within the model's
trained context.

An iSWA cache (kv_iswa) has no self-extend path, as in the JAX package:
`self_extend_step` over one raises ValueError. Nor has the MLA latent
cache (deepseek2): the JAX re-rotation turns the first rope_dim lanes of
each slot, which are lanes of the latent c_kv, so the port raises
ValueError there too.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .kv_cache import require_per_head


@dataclass
class SelfExtendState:
    ga_n: int  # group size (grp_attn_n)
    ga_w: int  # window (grp_attn_w, multiple of ga_n)
    ga_i: int = 0  # grouped frontier in label space
    gamma: int = 0  # cumulative bd (physical position - label of new tokens)
    labels: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        assert self.ga_n > 1, "grp_attn_n must be > 1"
        assert self.ga_w % self.ga_n == 0, "grp_attn_w must be a multiple of grp_attn_n"


def _extend_labels(st: SelfExtendState, n_phys: int):
    """Labels for freshly written physical slots: label = p - gamma."""
    cur = len(st.labels)
    if n_phys > cur:
        st.labels = np.concatenate(
            [st.labels, np.arange(cur, n_phys, dtype=np.int64) - st.gamma])


def advance(st: SelfExtendState, n_phys: int):
    """Run the reference's while-loop (main.cpp:992-1004) in label space.
    Returns the per-slot rotation delta (int64[n_phys]) to apply to K,
    or None if no firing happened."""
    _extend_labels(st, n_phys)
    lab = st.labels[:n_phys]
    old_rot = lab + st.gamma  # rotation each key currently carries
    n_label = n_phys - st.gamma
    fired = False
    while n_label >= st.ga_i + st.ga_w:
        fired = True
        ib = (st.ga_n * st.ga_i) // st.ga_w
        bd = (st.ga_w // st.ga_n) * (st.ga_n - 1)
        dd = (st.ga_w // st.ga_n) - ib * bd - st.ga_w
        # seq_add [ga_i, n_label) += ib*bd
        m = lab >= st.ga_i
        l1 = np.where(m, lab + ib * bd, lab)
        # seq_div [ga_i+ib*bd, ga_i+ib*bd+ga_w) /= ga_n
        win = m & (l1 >= st.ga_i + ib * bd) & (l1 < st.ga_i + ib * bd + st.ga_w)
        l2 = np.where(win, l1 // st.ga_n, l1)
        # seq_add [ga_i+ib*bd+ga_w, n_label+ib*bd) += dd
        tail = m & (l1 >= st.ga_i + ib * bd + st.ga_w)
        lab = np.where(tail, l2 + dd, l2)
        n_label -= bd
        st.ga_i += st.ga_w // st.ga_n
        st.gamma += bd
    if not fired:
        return None
    st.labels[:n_phys] = lab
    return (lab + st.gamma) - old_rot


def apply_to_cache(cache, rp, delta: np.ndarray):
    """Re-rotate the first len(delta) K slots by the per-slot deltas, in
    place (one batched apply_rope; RoPE additivity does the relabeling)."""
    from ..ops.rope import apply_rope

    n = len(delta)
    if not np.any(delta):
        return cache
    seg = cache.k[:, :, :n].float()  # (L, B, n, Hkv, D)
    pos = torch.as_tensor(delta, dtype=torch.long).to(seg.device)
    cache.k[:, :, :n] = apply_rope(seg, pos, rp).to(cache.k.dtype)
    return cache


def self_extend_step(cache, rp, st: SelfExtendState, n_phys: int):
    """Advance the grouping frontier for n_phys consumed tokens and apply
    any needed re-rotation. Returns the (possibly updated) cache."""
    require_per_head(cache, "self-extend")
    delta = advance(st, n_phys)
    if delta is None:
        return cache
    return apply_to_cache(cache, rp, delta)
