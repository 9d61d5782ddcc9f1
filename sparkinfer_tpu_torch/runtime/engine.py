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

Hot/cold tiering (SparseConfig.hot_groups > 0, `sparse/tiering.py`): prefill
stays masked-dense over the full row stores, decode runs the tiered FFN over
the hot store, and the balancer swaps groups between decode steps
(`rebalance_every`), in place. Drop and fetch modes capture the step as a
CUDA graph; host mode, whose every layer calls the host library, runs it
eagerly (the JAX Engine turns its fused decode off for tiering). A split file
(`split`) reorders the neurons hot-first before the stores are built.

A model with experts (llama-MoE, qwen3moe, gpt-oss, deepseek2) decodes
through its MoE FFN (`sparse/moe.py`) in `moe_mode` "dense" (plain torch
over the gathered expert stacks, the default, as the JAX Engine's) or
"pallas" (the v1 row kernel over views of the same stacks, `moe_params`:
the rows of every stack with experts, each of deepseek2's MoE segments as
the JAX Engine lays them out); routing, its top-k and the expansion of
expert ids to row groups run on the device, inside the step's graph.
deepseek2's leading dense layers run the dense FFN in either mode, and
its cache is the latent cache (`kv_cache.init_cache`).

Sampling runs the static chain of the JAX Engine (`sampling.chain_sample`:
penalties, top-k, typical, top-p, min-p, xtc, temperature, or mirostat v2)
inside the step, over state on the device (the generator, the ring of
recent tokens, mirostat's mu) that the step updates in place.

Past max_seq, `generate` shifts the context (`kv_cache.shift_cache`: keep
`n_keep` prompt tokens, drop half of the rest, re-rope the tail), and with
`self_extend=(n, w)` it groups old positions instead (`self_extend.py`);
both rewrite the cache's own tensors between steps, so the step's graph
reads them. Over an arch with no rope (ALiBi, learned positions) the shift
moves K unrotated, as the JAX package's does, and self-extend raises
ValueError: the JAX package has no path for it. `sparse_prefill="sparse"`
runs the prompt through the pipelined decode FFN (v6 at N = the prompt's
length). `verify` runs K+1 tokens through the decode forward in one step (a
graph of its own, keyed on T), the speculative, lookup and lookahead
drafters' check.

kv_iswa=True gives the engine the iSWA dual cache (`kv_cache.init_cache_iswa`
with chunk = prefill_chunk, made at the first generate): each run of
sliding layers keeps a ring of sliding_window + prefill_chunk slots, the
full layers max_seq; a forward writes at most prefill_chunk tokens into a
ring, and the decode step's graph rebuilds the ring's positions from its
static position buffer on the device. As in the JAX package, the context
shift, self-extend, the state files and the drafters take no iSWA cache
(ValueError), nor does the pipelined sparse FFN's cross-layer carry.

The static `batch` > 1 comes later.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator

import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.transformer import check_decoder, clamp_max_seq, make_forward
from .graphs import StepGraphs, resolve_capture
from .kv_cache import KVCache, check_int8, init_cache, init_cache_iswa, ring_room
from .sampling import (
    ChainState,
    SamplerConfig,
    chain_params,
    chain_sample,
    init_chain_state,
)

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

    Tiering (sparse.hot_groups > 0): the row stores (`prepare_sparse_params`,
    the prefill's) give a hot store of hot_groups groups a layer on the card
    (`tiered_params`), a cold store in host RAM (`cold`), DFR state
    (`fstate`) and a `balancer`, which `rebalance()` runs after every
    `rebalance_every` decode steps. sparse_cold_mode "host" adds the host
    library's complement at every layer (eager steps; cuda_graph=True
    raises), "drop" and "fetch" do not. split (a ModelSplit or a split
    GGUF's path) reorders the model's neurons hot-first, in place, first.

    cuda_graph: None captures each decode step as one CUDA graph on a CUDA
    device and runs it eagerly on the CPU; False runs it eagerly on the card
    too; True on the CPU raises ValueError. The eager step is the same
    function over the same static buffers. A graph is kept for each KV cache
    a step runs on: `generate`'s one engine-owned cache, and at most a few
    caches of the caller's own (`decode_step`), and one `verify` graph for
    each block length T. The engine keeps one sampler state (`ChainState`:
    its generator `generator`, the ring of recent tokens, mirostat's mu, on
    the device), which `new_sampler_state` resets and returns.

    sparse_prefill "sparse" prefills through the pipelined decode FFN (the
    kernel at N = the prompt's length) instead of the masked-dense one.
    self_extend=(grp_attn_n, grp_attn_w) groups old positions between steps
    (`self_extend.py`); `generate(n_keep=...)` shifts the context at
    max_seq otherwise.

    moe_mode ("dense" or "pallas") picks the MoE FFN of a model with
    experts. "pallas" reads `moe_layout`'s row-store views of the expert
    stacks, in the engine's own params: the model's params stay as they
    are (the JAX Engine replaces the stacks in them), so engines of both
    modes can share one model.

    kv_iswa=True: the iSWA dual cache (rings for the sliding layers), where
    the model has a sliding window; on a model without one it is a full
    cache of one run, and the stream is the same.

    kv_quantized=True: the int8 cache (-ctk q8 -ctv q8), whose codes and
    scales the step's graph writes and reads in place; kv_dtype_v: V's
    float dtype where it differs from kv_dtype (a split -ctv). The int8
    cache takes no MLA model, no iSWA cache and no self-extend
    (ValueError)."""

    GRAPHS = 4  # the decode-step graphs kept: the engine's cache and callers'

    def __init__(
        self,
        model: LoadedModel,
        max_seq: int = 2048,
        sampler: SamplerConfig | None = None,
        kv_dtype=torch.bfloat16,
        kv_dtype_v=None,
        kv_quantized: bool = False,
        sparse: "SparseConfig | None" = None,
        sparse_decode_mode: str = "kernel",
        sparse_drop_dense: bool = False,
        sparse_preprepared: bool = False,
        sparse_pipelined: bool = True,
        sparse_prefill: str = "dense",
        device=None,
        split=None,
        self_extend: tuple[int, int] | None = None,
        kv_iswa: bool = False,
        cuda_graph: bool | None = None,
        sparse_cold_mode: str = "host",
        rebalance_every: int = 1,
        moe_mode: str = "dense",
    ):
        self.device = resolve_device(device)
        if moe_mode not in ("dense", "pallas"):
            raise ValueError(f"moe_mode {moe_mode!r} (dense or pallas)")
        self.tiered = sparse is not None and sparse.hot_groups > 0
        if self.tiered and sparse_cold_mode == "host":
            if cuda_graph:
                raise ValueError("host mode calls the host library at every layer, which "
                                 "a CUDA graph cannot hold: cuda_graph=False")
            cuda_graph = False
        capture = resolve_capture(cuda_graph, self.device)
        if kv_iswa and self_extend is not None and self_extend[0] > 1:
            raise ValueError("self-extend needs a plain full-attention KV cache, not kv_iswa")
        if kv_quantized and self_extend is not None and self_extend[0] > 1:
            raise ValueError("self-extend rotates the float keys in place: the int8 KV cache "
                             "(-ctk q8) has no such path, as in the JAX package")
        if kv_iswa and sparse is not None and sparse.hot_groups == 0 and sparse_pipelined:
            raise ValueError("the pipelined sparse FFN's cross-layer carry takes no iSWA "
                             "cache (kv_iswa), as in the JAX package")
        self.kv_iswa = kv_iswa
        if sparse_prefill not in ("dense", "sparse"):
            raise ValueError(f"sparse_prefill {sparse_prefill!r} (dense or sparse)")
        self.model = model
        self.cfg = model.config
        check_decoder(self.cfg, "the Engine's generation")
        where = model.params["tok_embd"].device
        if where.type != self.device.type or (
                self.device.index is not None and where.index != self.device.index):
            raise ValueError(f"model params lie on {where}, the engine runs on "
                             f"{self.device}: load_model(..., device=...) to match")
        if self.cfg.kv_lora_rank > 0 and self_extend is not None and self_extend[0] > 1:
            raise ValueError("self-extend rotates whole key heads: the MLA (multi-head latent "
                             "attention) latent cache has no such path")
        if (self.cfg.traits.rope_mode == "none" and self_extend is not None
                and self_extend[0] > 1):
            raise ValueError(f"self-extend regroups rope angles: arch {self.cfg.arch!r} has no "
                             "rope (ALiBi or learned positions), and the JAX package has no "
                             "self-extend path for it")
        self.max_seq = clamp_max_seq(self.cfg, model.params, max_seq)
        self.sampler_cfg = sc = sampler or SamplerConfig()
        if sc.mirostat not in (0, 2):
            raise ValueError(f"mirostat {sc.mirostat}: 0 (off) or 2 (v2)")
        if kv_quantized:
            check_int8(self.cfg, kv_iswa)
        self.kv_dtype, self.kv_dtype_v, self.kv_quantized = kv_dtype, kv_dtype_v, kv_quantized
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
            if split is not None:
                from ..sparse.split import ModelSplit, apply_reorder, read_split

                if not isinstance(split, ModelSplit):
                    split = read_split(split)
                # inplace: the engine owns and rebinds the params
                model.params = self.params = apply_reorder(
                    model.params, self.cfg, split.perms, inplace=True)
            prefill_ffn = make_sparse_ffn(self.cfg, sparse, mode="dense")
            self.fwd = make_forward(self.cfg, ffn_fn=prefill_ffn)
            self.fwd_prefill = make_forward(self.cfg, ffn_fn=prefill_ffn,
                                            fresh_prefill=True)
            if self.tiered:  # the row stores, the tiered state, the decode forward
                self._init_tiered(sparse, sparse_cold_mode, sparse_drop_dense,
                                  sparse_preprepared)
            else:
                if not sparse_preprepared:
                    kw = dict(drop_dense=sparse_drop_dense)
                    # as the JAX Engine: the gather modes over the v1 row stores,
                    # the kernel modes over v6's flat stores (v7u needs them)
                    layout = "v1" if sparse_decode_mode.startswith("gather") else "v6"
                    self.params = (
                        prepare_pipelined_params(model.params, self.cfg, sparse,
                                                 layout=layout, **kw)
                        if sparse_pipelined else
                        prepare_sparse_params(model.params, self.cfg, sparse, **kw))
                if sparse_pipelined:
                    decode_ffn, carry_init = make_pipelined_sparse_ffn(
                        self.cfg, sparse, mode=sparse_decode_mode)
                    self.fwd_decode = make_forward(self.cfg, ffn_fn=decode_ffn,
                                                   ffn_carry_init=carry_init)
                    if sparse_prefill == "sparse":  # the prompt through the decode FFN
                        self.fwd = self.fwd_decode
                        self.fwd_prefill = make_forward(
                            self.cfg, ffn_fn=decode_ffn, ffn_carry_init=carry_init,
                            fresh_prefill=True)
                else:
                    self.fwd_decode = make_forward(self.cfg, ffn_fn=make_sparse_ffn(
                        self.cfg, sparse, mode=sparse_decode_mode))
        else:
            if moe_mode == "pallas" and self.cfg.n_expert > 0:
                from ..sparse.moe import moe_params

                # the row stores are views: the experts stay resident once
                self.params = moe_params(model.params, self.cfg)
            self.fwd = make_forward(self.cfg, moe_mode=moe_mode)
            self.fwd_prefill = make_forward(self.cfg, fresh_prefill=True, moe_mode=moe_mode)
            self.fwd_decode = self.fwd
        self.prefill_chunk = 1024  # ubatch size for long prompts (ref n_ubatch)
        self.rebalance_every = max(rebalance_every, 1)
        self.perf = PerfCounters()
        self.sstate = init_chain_state(sc, device=self.device)
        self.generator = self.sstate.gen
        self._dp = chain_params(sc, self.device)  # the chain's knobs on the device
        self.graphs = StepGraphs(self.device, capture, self.GRAPHS,
                                 None if sc.greedy else self.generator)
        self.cache: KVCache | None = None  # generate's, made at its first call
        self.self_extend_cfg = None
        if self_extend is not None and self_extend[0] > 1:
            from .self_extend import SelfExtendState

            SelfExtendState(*self_extend)  # checks grp_attn_w % grp_attn_n
            self.self_extend_cfg = tuple(self_extend)
        self.self_extend = None  # the SelfExtendState of the last generate

    @property
    def batch(self) -> int:
        """Sequences a step decodes: 1 (the static batch > 1 is not ported)."""
        return 1

    def _init_tiered(self, sparse, mode, drop_dense, preprepared):
        """The tiered decode: the row stores (the prefill's too), the hot store
        and DFR state on the card, the cold store in host RAM, the balancer."""
        from ..sparse.balancer import Balancer
        from ..sparse.ffn import prepare_sparse_params
        from ..sparse.tiering import (
            ColdStore,
            init_tiered,
            make_tiered_ffn,
            tiered_layer_params,
        )

        if not preprepared:
            self.params = prepare_sparse_params(self.params, self.cfg, sparse,
                                                drop_dense=drop_dense)
        layers = self.params["layers"]
        self.tiered_params, self.fstate = init_tiered(
            self.cfg, sparse, layers, sparse.hot_groups,
            track_miss_groups=(mode == "fetch"))
        self.cold = ColdStore(self.cfg, sparse, {k: v for k, v in layers.items()
                                                 if k.endswith("_rows") or k == "b_up"})
        self.balancer = Balancer(cold=self.cold, scfg=sparse)
        self.fwd_decode = make_forward(self.cfg, ffn_fn=make_tiered_ffn(
            self.cfg, sparse, self.cold, mode=mode), stateful_ffn=True)
        # decode params: the hot store instead of the full row stores
        lay, flat = tiered_layer_params(layers, self.tiered_params)
        self.decode_params = {**self.params, "layers": lay, "sparse_flat": flat}

    def rebalance(self):
        """One online rebalance of the tiered hot set from the DFR state (the
        fetch mode's miss counts consumed), in place, on the step's stream."""
        fs = self.fstate
        self.balancer.rebalance(self.tiered_params, fs.dfr, miss_g=fs.miss_g)
        if fs.miss_g is not None:
            fs.miss_g.zero_()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, toks: list[int], start: int) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.tensor([toks], dtype=torch.long, device=self.device)
        pos = torch.arange(start, start + len(toks), device=self.device)[None]
        return t, pos

    def new_cache(self) -> KVCache:
        if self.kv_iswa:  # a ring absorbs the longest forward, one prefill chunk
            return init_cache_iswa(self.cfg, 1, self.max_seq, chunk=self.prefill_chunk,
                                   dtype=self.kv_dtype, device=self.device,
                                   v_dtype=self.kv_dtype_v)
        return init_cache(self.cfg, 1, self.max_seq, self.kv_dtype, self.device,
                          self.kv_quantized, self.kv_dtype_v)

    def own_cache(self) -> KVCache:
        """The engine's own cache (`generate`'s and the drafters'), made once:
        one cache keeps one set of step graphs."""
        if self.cache is None:
            self.cache = self.new_cache()
        return self.cache

    def new_sampler_state(self, seed: int | None = None) -> ChainState:
        """The engine's sampler state, reset (the generator reseeded, the
        ring emptied, mu at 2 tau): a step updates it in place (its graphs
        hold its tensors), so it is the only sampler state `prefill` and
        `decode_step` take."""
        return self.sstate.reset(self.sampler_cfg, seed)

    def _check_state(self, sstate):
        if sstate is not self.sstate:
            raise ValueError("a step samples with the engine's state (its generator, ring "
                             "and mu): pass new_sampler_state()'s")

    @torch.inference_mode()
    def _self_extend_step(self, cache: KVCache, n_phys: int):
        from ..models.transformer import rope_params
        from .self_extend import self_extend_step

        self_extend_step(cache, rope_params(self.cfg), self.self_extend, n_phys)

    @torch.inference_mode()
    def prefill(self, prompt_tokens: list[int], cache: KVCache,
                sstate: ChainState) -> tuple[int, KVCache, ChainState, int]:
        """Returns (first sampled token, cache, sampler state, n_past)."""
        self._check_state(sstate)
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.max_seq:
            raise ValueError(f"prompt of {n} tokens exceeds max_seq {self.max_seq}")
        self._sync()
        t0 = time.perf_counter()
        CH = self.prefill_chunk
        room = ring_room(self.cfg, cache, self.max_seq)  # an iSWA ring takes at most its chunk
        if room is not None:
            CH = min(CH, room)
        off = 0
        while n - off > CH:  # ubatch-style chunks for long prompts
            toks, pos = self._tokens(prompt_tokens[off:off + CH], off)
            (self.fwd_prefill if off == 0 else self.fwd)(self.params, toks, pos, cache)
            off += CH
            if self.self_extend is not None:  # grouped as ingestion proceeds (main.cpp:990)
                self._self_extend_step(cache, off)
        toks, pos = self._tokens(prompt_tokens[off:], off)
        fwd = self.fwd_prefill if off == 0 else self.fwd
        logits = fwd(self.params, toks, pos, cache)
        self.last_logits = logits[:, -1]
        tok = int(chain_sample(self.last_logits, self.sampler_cfg, sstate, self._dp)[0])
        self._sync()
        self.perf.t_prefill_s += time.perf_counter() - t0
        self.perf.n_prefill += n
        return tok, cache, sstate, n

    def _decode_fn(self, cache: KVCache):
        """The decode step over static (1, 1) token and position buffers:
        the (1, V) f32 logits and the sampled token (1,). It holds what it
        reads, not the engine, so that no reference cycle keeps an engine's
        memory past its last use."""
        fwd, params, state = self._decode_forward()
        cfg, st, dp = self.sampler_cfg, self.sstate, self._dp

        def step(tokens, positions):
            logits = fwd(params, tokens, positions, cache, *state)[:, -1]
            return logits, chain_sample(logits, cfg, st, dp)

        return step

    def _decode_forward(self):
        """(the decode forward, its params, its extra state arguments)."""
        if self.tiered:  # the tiered forward updates its DFR state in place
            return self.fwd_decode, self.decode_params, (self.fstate,)
        return self.fwd_decode, self.params, ()

    def _tiered_state(self) -> tuple:
        """The DFR state a tiered forward updates in place."""
        return tuple(t for t in self.fstate if t is not None) if self.tiered else ()

    def _verify_fn(self, cache: KVCache):
        fwd, params, state = self._decode_forward()

        def verify(tokens, positions):
            logits = fwd(params, tokens, positions, cache, *state)[0]
            return logits, torch.argmax(logits, dim=-1)

        return verify

    @torch.inference_mode()
    def verify(self, tokens: list[int], n_past: int, cache: KVCache
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (T of them) at positions n_past.. through the decode forward
        in one step, the graph of (cache, T): ((T, V) f32 logits, (T,) argmax),
        on the device. The logits are the graph's buffer, which the next
        verify of that T overwrites. No sampling: the drafters accept."""
        T = len(tokens)
        step = self.graphs.get(cache, 1, "verify", lambda: self._verify_fn(cache),
                               self._tiered_state(), T=T)
        step.io.copy_(torch.tensor([[tokens], [list(range(n_past, n_past + T))]]))
        return step.run()

    @torch.inference_mode()
    def decode_step(self, token: int, n_past: int, cache: KVCache,
                    sstate: ChainState) -> tuple[int, KVCache, ChainState]:
        """One token through the step of `cache` (its graph, captured at the
        first step on that cache); the token read is the step's only
        synchronization."""
        self._check_state(sstate)
        t0 = time.perf_counter()
        # the step updates the sampler's state and the tiered DFR state in place
        step = self.graphs.get(cache, 1, "decode", lambda: self._decode_fn(cache),
                               self.sstate.tensors + self._tiered_state())
        step.tokens.fill_(token)
        step.positions.fill_(n_past)
        self.last_logits, tok = step.run()
        tok = int(tok[0])
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += 1
        if self.tiered and self.perf.n_decode % self.rebalance_every == 0:
            self.rebalance()  # between steps, as the JAX Engine's
        return tok, cache, sstate

    def generate(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                 stop_ids: set[int] | None = None, seed: int | None = None,
                 stream: bool = False, n_keep: int = -1) -> list[int] | Iterator[int]:
        """Greedy/sampled generation; returns the generated token ids.
        n_keep: prompt tokens preserved across a context shift (-1 = the
        whole prompt; ref main.cpp --keep)."""
        it = self._generate_iter(prompt_tokens, max_new_tokens,
                                 stop_ids or set(), seed, n_keep)
        return it if stream else list(it)

    def generate_text(self, prompt: str, max_new_tokens: int = 128, seed: int | None = None) -> str:
        vocab = self.model.vocab
        if vocab is None:
            raise ValueError("model has no tokenizer vocab")
        from ..tokenizer import build_tokenizer

        tk = build_tokenizer(vocab)
        ids = tk.encode(prompt, add_special=True)
        stop = {vocab.eos_id} if vocab.eos_id is not None else set()
        out = self.generate(ids, max_new_tokens, stop_ids=stop, seed=seed)
        return tk.decode(out)

    def _generate_iter(self, prompt_tokens, max_new_tokens, stop_ids, seed, n_keep):
        if max_new_tokens <= 0:
            return
        # one cache for every call, as the JAX Engine donates its own
        cache = self.own_cache()
        sstate = self.new_sampler_state(seed)
        if self.self_extend_cfg is not None:  # a fresh grouping for each sequence
            from .self_extend import SelfExtendState

            self.self_extend = SelfExtendState(*self.self_extend_cfg)
        tok, cache, sstate, n_past = self.prefill(prompt_tokens, cache, sstate)
        if n_keep < 0 or n_keep > len(prompt_tokens):
            n_keep = len(prompt_tokens)
        se = self.self_extend
        if se is not None:
            self._self_extend_step(cache, n_past)
        emitted = 0
        while tok not in stop_ids:
            yield tok
            emitted += 1
            if emitted >= max_new_tokens:
                return
            if se is not None:
                if n_past >= self.max_seq - 1:
                    # the physical rows are spent: self-extend compresses rope
                    # labels, not storage, as the reference's cells
                    return
                self._self_extend_step(cache, n_past)
            elif n_past >= self.max_seq - 1:
                n_past -= self._shift(cache, n_keep, n_past)
            tok, cache, sstate = self.decode_step(tok, n_past, cache, sstate)
            n_past += 1

    @torch.inference_mode()
    def _shift(self, cache: KVCache, n_keep: int, n_past: int) -> int:
        """Context shift (ref: llama-cli): keep the prompt's first n_keep
        tokens, drop half of the rest, slide and re-rope the tail, in the
        cache's own tensors. Returns the rows dropped."""
        from ..models.transformer import rope_params
        from .kv_cache import shift_cache

        discard = max((self.max_seq - n_keep) // 2, 1)
        shift_cache(cache, rope_params(self.cfg), n_keep, discard, n_past)
        return discard

    def save_session(self, path: str, cache: KVCache, n_past: int,
                     sstate: ChainState | None = None,
                     tokens: list[int] | None = None) -> int:
        """Save the sequence's state (ref: llama_state_save_file + llama-cli
        --prompt-cache), in the JAX package's file format."""
        from .state_io import save_state

        return save_state(path, self.cfg, cache, n_past, sstate, tokens,
                          mirostat_tau=self.sampler_cfg.mirostat_tau)

    def load_session(self, path: str):
        """Returns (cache, n_past, tokens, sstate): the file restored into the
        engine's own cache and sampler state, in place (their step graphs
        read them), as `load_state` does (ref: llama_state_load_file)."""
        from .state_io import load_state

        return load_state(path, self.cfg, self.own_cache(), 0, self.sstate)
