"""Session state save/restore, the port of sparkinfer_tpu/runtime/state_io.py
(parity with llama_state_save_file / llama_state_seq_*, ref
src/llama-context.cpp:1676-2021; exercised by examples/save-load-state and
the server's /slots/:id?action=save).

The JAX package's file format, so that a file saved by one package restores
in the other: a zip of .npy arrays and a meta.json entry. Saved per
sequence: the token history, the KV rows up to n_past (the occupied cells),
the sampler state and a model fingerprint that refuses a cross-model
restore. bf16 rows are stored as numpy writes JAX's bf16 arrays: two-byte
void elements ('|V2') holding the raw bits. The sampler state is the JAX
package's four arrays; `s_key` is the threefry key of the generator's seed
(PRNGKey(seed)), and the port adds `s_torch_gen`, its generator's exact
state, which the JAX package ignores. A restore writes into the cache's and
the sampler state's own tensors, in place: the step graphs captured over
them read the restored rows. An int8 cache's file holds its int8 k and v
rows and their f32 k_scale and v_scale, with "quantized": true, as the JAX
package writes it; a file restores only into a cache of its own kind (the
JAX package would write int8 codes into a float cache). An iSWA cache has
no state file, as in the JAX package, and raises ValueError.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from .kv_cache import KVCache, require_full
from .sampling import ChainState, SamplerState

STATE_MAGIC = "sparkinfer-state-v1"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int8: "int8"}


def model_fingerprint(cfg) -> str:
    return (
        f"{cfg.arch}:L{cfg.n_layer}:E{cfg.n_embd}:H{cfg.n_head}:"
        f"Hkv{cfg.n_head_kv}:F{cfg.n_ff}:V{cfg.n_vocab}"
    )


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # raw bits, as numpy saves an ml_dtypes bfloat16 array
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16 bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _sampler_arrays(st, mirostat_tau: float) -> dict[str, np.ndarray]:
    """The JAX SamplerState's arrays (key, recent, recent_pos, mirostat_mu)
    of an Engine ChainState or a Scheduler slot's SamplerState (whose chain
    has no mirostat: its mu is the initial 2 tau)."""
    gen = st.gen
    seed = gen.initial_seed()
    out = {"s_key": np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
           "s_recent": st.recent.cpu().numpy().astype(np.int32),
           "s_torch_gen": gen.get_state().numpy()}
    if isinstance(st, ChainState):
        out["s_recent_pos"] = np.asarray(int(st.recent_pos), np.int32)
        out["s_mirostat_mu"] = np.asarray(float(st.mirostat_mu), np.float32)
    else:
        out["s_recent_pos"] = np.asarray(st.recent_pos, np.int32)
        out["s_mirostat_mu"] = np.asarray(2.0 * mirostat_tau, np.float32)
    return out


def _restore_sampler(st, arrays: dict):
    recent = torch.from_numpy(arrays["s_recent"].astype(np.int64))
    if recent.shape != st.recent.shape:
        raise ValueError(f"the state's penalty ring holds {recent.shape[0]} tokens, the "
                         f"sampler's {st.recent.shape[0]}")
    st.recent.copy_(recent.to(st.recent.dtype))
    saved = arrays.get("s_torch_gen")
    if saved is not None and saved.size == st.gen.get_state().numel():
        st.gen.set_state(torch.from_numpy(saved.copy()))
    else:  # a JAX key: reseed from the seed it was made from
        k0, k1 = (int(x) for x in arrays["s_key"].reshape(-1)[:2])
        st.gen.manual_seed((k0 << 32) | k1)
    pos = int(arrays["s_recent_pos"])
    if isinstance(st, ChainState):
        st.recent_pos.fill_(pos)
        st.mirostat_mu.fill_(float(arrays["s_mirostat_mu"]))
    else:
        st.recent_pos = pos


def save_state(path: str, cfg, cache: KVCache, n_past: int,
               sstate: ChainState | SamplerState | None = None,
               tokens: list[int] | None = None, slot: int = 0,
               mirostat_tau: float = 5.0) -> int:
    """Save one slot's sequence state. Returns bytes written."""
    require_full(cache, "a state file")
    arrays = {"k": _to_numpy(cache.k[:, slot, :n_past]),
              "v": _to_numpy(cache.v[:, slot, :n_past])}
    if cache.quantized:
        arrays["k_scale"] = _to_numpy(cache.k_scale[:, slot, :n_past])
        arrays["v_scale"] = _to_numpy(cache.v_scale[:, slot, :n_past])
    if sstate is not None:
        arrays.update(_sampler_arrays(sstate, mirostat_tau))
    meta = {
        "magic": STATE_MAGIC,
        "fingerprint": model_fingerprint(cfg),
        "n_past": int(n_past),
        "tokens": [int(t) for t in (tokens or [])],
        "kv_dtype": _DTYPE_NAMES.get(cache.k.dtype, str(cache.k.dtype)),
        "quantized": cache.quantized,
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        for name, arr in arrays.items():
            b = io.BytesIO()
            np.save(b, arr)
            z.writestr(f"{name}.npy", b.getvalue())
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


@torch.inference_mode()
def load_state(path: str, cfg, cache: KVCache, slot: int = 0,
               sstate: ChainState | SamplerState | None = None):
    """Restore into `cache` at `slot` and into `sstate`, in place. Returns
    (cache, n_past, tokens, sstate). Raises on a model mismatch."""
    require_full(cache, "a state file")
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("magic") != STATE_MAGIC:
            raise ValueError("not a sparkinfer state file")
        if meta["fingerprint"] != model_fingerprint(cfg):
            raise ValueError(
                f"state was saved for a different model "
                f"({meta['fingerprint']} != {model_fingerprint(cfg)})"
            )
        arrays = {
            name[:-4]: np.load(io.BytesIO(z.read(name)))
            for name in z.namelist()
            if name.endswith(".npy")
        }
    n_past = int(meta["n_past"])
    if bool(meta.get("quantized")) != cache.quantized:
        kinds = ("a float", "an int8 (quantized)")
        raise ValueError(f"the state holds {kinds[bool(meta.get('quantized'))]} KV cache, "
                         f"the cache it restores into is {kinds[cache.quantized]} one")
    if n_past > cache.max_seq:
        raise ValueError(f"state n_past {n_past} exceeds cache max_seq {cache.max_seq}")
    names = ("k", "v", "k_scale", "v_scale") if cache.quantized else ("k", "v")
    if any(n not in arrays for n in names):
        raise ValueError("quantized cache but state has no scales")
    for big, name in zip(cache.buffers(), names):
        big[:, slot, :n_past].copy_(_from_numpy(arrays[name], big.dtype))
    if sstate is not None and "s_key" in arrays:
        _restore_sampler(sstate, arrays)
    return cache, n_past, meta["tokens"], sstate
