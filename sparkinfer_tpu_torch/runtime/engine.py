"""Generation engine, the port of sparkinfer_tpu/runtime/engine.py for the
dense and the sparse (pipelined and non-pipelined) paths.

Prefill runs the whole prompt eagerly through one forward (chunked when it
is longer than `prefill_chunk`). Decode runs one token per step: the forward
and the sampler over static token and position buffers, on the card one
replay of a CUDA graph (`runtime/graphs.py`), the counterpart of the JAX
Engine's jitted, cache-donating decode step; the host reads one token id per
step. The JAX engine's TPU tunings have no counterpart here: prefill length
buckets (prefill runs eagerly, so no shape needs a compile), the fused
multi-step decode scan and batched token readback (a local card answers a
read in microseconds).

Tiering, split files, self-extend, context shift, iSWA and MoE come later.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator

import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.transformer import make_forward
from .graphs import StepGraphs, resolve_capture
from .kv_cache import KVCache, init_cache
from .sampling import SamplerConfig, neutral_penalties, sample

if TYPE_CHECKING:
    from ..sparse.config import SparseConfig


@dataclass
class PerfCounters:
    """Analogue of llama_perf_context (include/llama.h:1371-1391)."""

    t_prefill_s: float = 0.0
    n_prefill: int = 0
    t_decode_s: float = 0.0
    n_decode: int = 0

    @property
    def prefill_tps(self) -> float:
        return self.n_prefill / self.t_prefill_s if self.t_prefill_s > 0 else 0.0

    @property
    def decode_tps(self) -> float:
        return self.n_decode / self.t_decode_s if self.t_decode_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "prefill_tokens": self.n_prefill,
            "prefill_tps": round(self.prefill_tps, 2),
            "decode_tokens": self.n_decode,
            "decode_tps": round(self.decode_tps, 2),
        }


class Engine:
    """Single-sequence generation engine.

    sparse=None runs the dense model. With a SparseConfig, prefill runs the
    masked-dense FFN and decode the one-layer-ahead pipelined sparse FFN
    (`prepare_pipelined_params`): the kernel modes over the flat stores of
    layout "v6", the gather modes over the row stores of layout "v1", as the
    JAX Engine builds them; or with
    sparse_pipelined=False the per-layer sparse FFN over row stores
    (`prepare_sparse_params`), the serving Scheduler's decode.
    sparse_decode_mode "kernel" goes through the hand-written CUDA kernel
    on the card (v6 or v6q pipelined, v1 not; the plain version on the
    CPU), "gather" through plain torch on any device. sparse_drop_dense
    keeps only the sparse stores (prefill then reads them);
    sparse_preprepared=True takes params that `prepare_pipelined_params`
    (or `prepare_sparse_params`) already built, which is how Q8_0 stores
    (quant="q8_0") and Q8_0 predictor stacks (params["sparse_flat"]
    pred_up_qt ...) reach the engine. The model's params must lie on `device`
    (None: the card). After each prefill or decode step, `last_logits` holds
    the (1, V) f32 logits the token was sampled from; after a decode step it
    is the step's output buffer, which the next step overwrites (clone it to
    keep it).

    cuda_graph: None captures each decode step as one CUDA graph on a CUDA
    device and runs it eagerly on the CPU; False runs it eagerly on the card
    too; True on the CPU raises ValueError. The eager step is the same
    function over the same static buffers. A graph is kept for each KV cache
    a step runs on: `generate`'s one engine-owned cache, and at most a few
    caches of the caller's own (`decode_step`). The engine keeps one
    sampler generator, which `new_sampler_state` reseeds and returns."""

    GRAPHS = 4  # the decode-step graphs kept: the engine's cache and callers'

    def __init__(
        self,
        model: LoadedModel,
        max_seq: int = 2048,
        sampler: SamplerConfig | None = None,
        kv_dtype=torch.bfloat16,
        sparse: "SparseConfig | None" = None,
        sparse_decode_mode: str = "kernel",
        sparse_drop_dense: bool = False,
        sparse_preprepared: bool = False,
        sparse_pipelined: bool = True,
        device=None,
        split=None,
        self_extend: tuple[int, int] | None = None,
        kv_iswa: bool = False,
        cuda_graph: bool | None = None,
    ):
        self.device = resolve_device(device)
        capture = resolve_capture(cuda_graph, self.device)
        if split is not None or self_extend is not None or kv_iswa:
            raise NotImplementedError(
                "split files, self-extend and the iSWA cache are not ported yet")
        self.model = model
        self.cfg = model.config
        where = model.params["tok_embd"].device
        if where.type != self.device.type or (
                self.device.index is not None and where.index != self.device.index):
            raise ValueError(f"model params lie on {where}, the engine runs on "
                             f"{self.device}: load_model(..., device=...) to match")
        self.max_seq = max_seq
        self.sampler_cfg = sc = sampler or SamplerConfig()
        if (sc.typical_p < 1.0 or sc.xtc_probability > 0.0 or sc.mirostat
                or not neutral_penalties(sc.penalty_repeat, sc.penalty_freq,
                                         sc.penalty_present)):
            raise NotImplementedError(
                "the Engine's sampler has no penalties, typical, xtc or mirostat "
                "yet (the Scheduler's per-slot sampler has all but mirostat)")
        self.kv_dtype = kv_dtype
        self.params = model.params
        if sparse is not None:
            from ..sparse.ffn import (
                make_pipelined_sparse_ffn,
                make_sparse_ffn,
                prepare_pipelined_params,
                prepare_sparse_params,
            )

            if not self.cfg.has_predictors:
                raise ValueError("sparse mode requires predictor tensors in the model")
            if sparse.hot_groups > 0:
                raise NotImplementedError("hot/cold tiering is not ported yet")
            if not sparse_preprepared:
                kw = dict(drop_dense=sparse_drop_dense)
                # as the JAX Engine: the gather modes over the v1 row stores,
                # the kernel modes over v6's flat stores (v7u needs them)
                layout = "v1" if sparse_decode_mode.startswith("gather") else "v6"
                self.params = (
                    prepare_pipelined_params(model.params, self.cfg, sparse, layout=layout, **kw)
                    if sparse_pipelined else
                    prepare_sparse_params(model.params, self.cfg, sparse, **kw))
            prefill_ffn = make_sparse_ffn(self.cfg, sparse, mode="dense")
            self.fwd = make_forward(self.cfg, ffn_fn=prefill_ffn)
            self.fwd_prefill = make_forward(self.cfg, ffn_fn=prefill_ffn,
                                            fresh_prefill=True)
            if sparse_pipelined:
                decode_ffn, carry_init = make_pipelined_sparse_ffn(
                    self.cfg, sparse, mode=sparse_decode_mode)
                self.fwd_decode = make_forward(self.cfg, ffn_fn=decode_ffn,
                                               ffn_carry_init=carry_init)
            else:
                self.fwd_decode = make_forward(self.cfg, ffn_fn=make_sparse_ffn(
                    self.cfg, sparse, mode=sparse_decode_mode))
        else:
            self.fwd = make_forward(self.cfg)
            self.fwd_prefill = make_forward(self.cfg, fresh_prefill=True)
            self.fwd_decode = self.fwd
        self.prefill_chunk = 1024  # ubatch size for long prompts (ref n_ubatch)
        self.perf = PerfCounters()
        self.generator = torch.Generator(device=self.device)
        self.graphs = StepGraphs(self.device, capture, self.GRAPHS,
                                 None if sc.greedy else self.generator)
        self.cache: KVCache | None = None  # generate's, made at its first call

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, toks: list[int], start: int) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.tensor([toks], dtype=torch.long, device=self.device)
        pos = torch.arange(start, start + len(toks), device=self.device)[None]
        return t, pos

    def new_cache(self) -> KVCache:
        return init_cache(self.cfg, 1, self.max_seq, self.kv_dtype, self.device)

    def new_sampler_state(self, seed: int | None = None) -> torch.Generator:
        """The engine's generator, reseeded: a decode step draws from it
        (its graphs have it registered), so it is the only sampler state
        `decode_step` takes."""
        self.generator.manual_seed(self.sampler_cfg.seed if seed is None else seed)
        return self.generator

    @torch.inference_mode()
    def prefill(self, prompt_tokens: list[int], cache: KVCache,
                sstate: torch.Generator) -> tuple[int, KVCache, torch.Generator, int]:
        """Returns (first sampled token, cache, sampler state, n_past)."""
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.max_seq:
            raise ValueError(f"prompt of {n} tokens exceeds max_seq {self.max_seq}")
        self._sync()
        t0 = time.perf_counter()
        CH = self.prefill_chunk
        off = 0
        while n - off > CH:  # ubatch-style chunks for long prompts
            toks, pos = self._tokens(prompt_tokens[off:off + CH], off)
            (self.fwd_prefill if off == 0 else self.fwd)(self.params, toks, pos, cache)
            off += CH
        toks, pos = self._tokens(prompt_tokens[off:], off)
        fwd = self.fwd_prefill if off == 0 else self.fwd
        logits = fwd(self.params, toks, pos, cache)
        self.last_logits = logits[:, -1]
        tok = int(sample(self.last_logits, self.sampler_cfg, sstate)[0])
        self._sync()
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += n
        return tok, cache, sstate, n

    def _decode_fn(self, cache: KVCache):
        """The decode step over static (1, 1) token and position buffers:
        the (1, V) f32 logits and the sampled token (1,). It holds what it
        reads, not the engine, so that no reference cycle keeps an engine's
        memory past its last use."""
        fwd, params, cfg, gen = self.fwd_decode, self.params, self.sampler_cfg, self.generator

        def step(tokens, positions):
            logits = fwd(params, tokens, positions, cache)[:, -1]
            return logits, sample(logits, cfg, gen)

        return step

    @torch.inference_mode()
    def decode_step(self, token: int, n_past: int, cache: KVCache,
                    sstate: torch.Generator) -> tuple[int, KVCache, torch.Generator]:
        """One token through the step of `cache` (its graph, captured at the
        first step on that cache); the token read is the step's only
        synchronization."""
        if not self.sampler_cfg.greedy and sstate is not self.generator:
            raise ValueError("a sampled decode step draws from the engine's generator: "
                             "pass new_sampler_state()'s")
        t0 = time.perf_counter()
        step = self.graphs.get(cache, 1, "decode", lambda: self._decode_fn(cache))
        step.tokens.fill_(token)
        step.positions.fill_(n_past)
        self.last_logits, tok = step.run()
        tok = int(tok[0])
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += 1
        return tok, cache, sstate

    def generate(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                 stop_ids: set[int] | None = None, seed: int | None = None,
                 stream: bool = False) -> list[int] | Iterator[int]:
        """Greedy/sampled generation; returns the generated token ids."""
        it = self._generate_iter(prompt_tokens, max_new_tokens,
                                 stop_ids or set(), seed)
        return it if stream else list(it)

    def _generate_iter(self, prompt_tokens, max_new_tokens, stop_ids, seed):
        if max_new_tokens <= 0:
            return
        if self.cache is None:  # one cache for every call, as the JAX Engine donates its own
            self.cache = self.new_cache()
        cache = self.cache
        sstate = self.new_sampler_state(seed)
        tok, cache, sstate, n_past = self.prefill(prompt_tokens, cache, sstate)
        emitted = 0
        while tok not in stop_ids:
            yield tok
            emitted += 1
            if emitted >= max_new_tokens:
                return
            if n_past >= self.max_seq - 1:
                raise NotImplementedError(
                    "context shift is not ported yet: raise max_seq")
            tok, cache, sstate = self.decode_step(tok, n_past, cache, sstate)
            n_past += 1
