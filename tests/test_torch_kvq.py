"""The int8 and split-dtype KV caches of the port (-ctk q8 -ctv q8, a split
-ctv) against the JAX package, on the CPU.

Tiny GGUFs of tests/model_fixtures.py and tests/arch_fixture.py (llama with
4 heads over 2 KV heads, orion's LayerNorm blocks with neox rope, the
ProSparse fixture for the sparse Engine), f32 weights. Tolerances:
  - quantize_kv / dequantize_kv: bit-equal, all-zero rows and exact
    rounding midpoints (half to even) included;
  - the cache after a prefill and 8 decode steps: codes at most one apart
    (where the f32 values differ in their last bits; the count is printed),
    scales within 1e-6 relative, logits within 1e-4 of their scale;
  - greedy streams of the Engine (dense and sparse), the 2-slot Scheduler
    (prefix reuse included) and the drafters: equal;
  - the context shift: K codes at most one apart, V codes and V scales
    bit-equal;
  - slot files written by one package and restored by the other: bit for
    bit.
The CLI's and the server's -ctk q8 -ctv q8 and -ctv f32 are held to the JAX
CLI and server in tests/test_torch_cli.py and tests/test_torch_server.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from arch_fixture import make_arch  # noqa: E402
from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.models.transformer import rope_params as jax_rope_params  # noqa: E402
from sparkinfer_tpu.runtime import kv_cache as jkv  # noqa: E402
from sparkinfer_tpu.runtime import state_io as jstate  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward, rope_params  # noqa: E402
from sparkinfer_tpu_torch.runtime import kv_cache as tkv  # noqa: E402
from sparkinfer_tpu_torch.runtime import state_io as tstate  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

PROMPT = [5, 9, 42, 7, 11, 3]
GREEDY = dict(temp=0.0)
# the caches: (JAX Engine keywords, the port's)
CACHES = {"int8": (dict(kv_dtype=jnp.bfloat16, kv_quantized=True),
                   dict(kv_dtype=torch.bfloat16, kv_quantized=True)),
          "split": (dict(kv_dtype=jnp.bfloat16, kv_dtype_v=jnp.float32),
                    dict(kv_dtype=torch.bfloat16, kv_dtype_v=torch.float32))}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("kvq")
    make_tiny_llama(d / "llama.gguf", seed=2)
    make_arch(d / "orion.gguf", "orion", seed=4)
    make_tiny_llama(d / "sparse.gguf", arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return {k: str(d / f"{k}.gguf") for k in ("llama", "orion", "sparse")}


def _both(path):
    return (jax_load(path, dtype=jnp.float32),
            load_model(path, dtype=torch.float32, device="cpu"))


def _close(got, ref, rel):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), scale)


def _codes_within_one(got: torch.Tensor, ref, what: str) -> int:
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    n = int((diff != 0).sum())
    print(f"{what}: {n} of {diff.size} codes one apart")
    assert diff.max() <= 1, what
    return n


# ---------------------------------------------------------------------------
# the codec


def _codec_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0  # an all-zero row: scale 0, codes 0
    # amax 127 gives scale 1.0 exactly: every other lane an exact midpoint
    x[1, 2, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 62.5, -63.5, 0.0,
                           126.5, -126.5, 4.5, -4.5, 5.5], np.float32)
    return x


def test_quantize_kv_bit_equal_to_jax():
    """Codes, scales and dequantized values (f32 and bf16) bit-equal, the
    all-zero row and the exact midpoints (half to even) included."""
    x = _codec_inputs()
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 5, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[0, 1, 2].any() and ts[0, 1, 2].item() == 0.0
    assert tq[1, 2, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 62, -64, 0, 126, -126, 4, -4, 6]
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jkv.dequantize_kv(jq, js, jd).astype(jnp.float32))
        np.testing.assert_array_equal(tkv.dequantize_kv(tq, ts, td).float().numpy(), ref)
    xb = torch.from_numpy(x).bfloat16()  # a bf16 model's k and v
    jq, js = jkv.quantize_kv(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    tq, ts = tkv.quantize_kv(xb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_cache_bytes_and_buffers():
    """(D + 4) / (2 D) of the bf16 cache's bytes (132/256 at D = 128): 270,336
    against 524,288 B a token at 7B widths; the scales are buffers of the
    cache, so a graph's key and a slot's view see them."""
    cfg = ModelConfig(arch="llama", n_layer=32, n_embd=4096, n_head=32, n_head_kv=32,
                      n_ff=11008, n_vocab=32000, head_dim=128)
    q = tkv.init_cache(cfg, 1, 64, torch.bfloat16, "meta", quantized=True)
    b = tkv.init_cache(cfg, 1, 64, torch.bfloat16, "meta")

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in c.buffers())

    assert nbytes(q) * 256 == nbytes(b) * 132
    assert (nbytes(q) // 64, nbytes(b) // 64) == (270336, 524288)
    assert q.quantized and not b.quantized and len(q.buffers()) == 4
    assert q.k_scale.shape == (32, 1, 64, 32, 1) and q.k_scale.dtype == torch.float32
    tiny = ModelConfig(arch="llama", n_layer=2, n_embd=64, n_head=4, n_head_kv=2, n_ff=96,
                       n_vocab=199, head_dim=16)
    small = tkv.init_cache(tiny, 3, 8, torch.bfloat16, "cpu", quantized=True)
    view = tkv.slot_view(small, 1)
    assert view.quantized and view.v_scale.shape == (2, 1, 8, 2, 1)
    view.k_scale[0, 0, 2] = 7.0
    assert small.k_scale[0, 1, 2].eq(7.0).all() and not small.k_scale[0, 0].any()
    split = tkv.init_cache(tiny, 1, 8, torch.bfloat16, "cpu", v_dtype=torch.float32)
    assert (split.k.dtype, split.v.dtype) == (torch.bfloat16, torch.float32)
    keys = {tkv.cache_key(c)[2] for c in (split, tkv.init_cache(tiny, 1, 8))}
    assert len(keys) == 2  # a graph over one is never replayed over the other


# ---------------------------------------------------------------------------
# the forward over the int8 cache


@pytest.mark.parametrize("name", ["llama", "orion"])
def test_cache_after_prefill_and_decode_matches_jax(ggufs, name):
    """A prefill (the chunk path: attention over the chunk's own k and v)
    and 8 decode steps over the int8 cache, f32 model: logits within 1e-4
    of their scale, codes at most one apart, scales within 1e-6."""
    jm, pm = _both(ggufs[name])
    jcfg, cfg = jm.config, pm.config
    jc = jkv.init_cache(jcfg, 1, 32, jnp.bfloat16, quantized=True)
    pre, dec = jax.jit(jax_forward(jcfg, fresh_prefill=True)), jax.jit(jax_forward(jcfg))
    lg, jc = pre(jm.params, jnp.asarray([PROMPT], jnp.int32),
                 jnp.arange(len(PROMPT), dtype=jnp.int32)[None], jc)
    ref, toks = [np.asarray(lg)[0]], []
    for i in range(8):
        toks.append(int(np.argmax(ref[-1][-1])))
        lg, jc = dec(jm.params, jnp.asarray([[toks[-1]]], jnp.int32),
                     jnp.asarray([[len(PROMPT) + i]], jnp.int32), jc)
        ref.append(np.asarray(lg)[0])
    tc = tkv.init_cache(cfg, 1, 32, torch.bfloat16, "cpu", quantized=True)
    with torch.inference_mode():
        got = [make_forward(cfg, fresh_prefill=True)(
            pm.params, torch.tensor([PROMPT]), torch.arange(len(PROMPT))[None], tc)[0]]
        fwd = make_forward(cfg)
        for i, tok in enumerate(toks):
            got.append(fwd(pm.params, torch.tensor([[tok]]),
                           torch.tensor([[len(PROMPT) + i]]), tc)[0])
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-4)
    n = len(PROMPT) + 8
    for codes, want in ((tc.k, jc.k), (tc.v, jc.v)):
        _codes_within_one(codes[:, :, :n], np.asarray(want)[:, :, :n], f"{name} cache")
    for sc, want in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        np.testing.assert_allclose(sc[:, :, :n].numpy(), np.asarray(want)[:, :, :n],
                                   rtol=1e-6, atol=0)
    assert not tc.k[:, :, n:].any() and not tc.k_scale[:, :, n:].any()


# ---------------------------------------------------------------------------
# the runtime


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("name", ["llama", "orion"])
def test_engine_stream_matches_jax(ggufs, name, cache):
    """Engine(kv_quantized=True) and a split cache (bf16 K, f32 V) against
    the JAX Engine on the same options: equal greedy streams, past a
    context shift (max_seq 24)."""
    jm, pm = _both(ggufs[name])
    jkw, tkw = CACHES[cache]
    je = JaxEngine(jm, max_seq=24, sampler=JaxSampler(**GREEDY), **jkw)
    pe = Engine(pm, max_seq=24, sampler=SamplerConfig(**GREEDY), device="cpu", **tkw)
    got = pe.generate(PROMPT, 32)
    assert got == je.generate(PROMPT, 32) and len(got) == 32
    c = pe.cache
    assert (c.k.dtype, c.v.dtype) == ((torch.int8, torch.int8) if cache == "int8"
                                      else (torch.bfloat16, torch.float32))
    assert c.quantized == (cache == "int8")


def test_sparse_engine_stream_matches_jax(ggufs):
    """The pipelined sparse Engine (v6's plain version here) over the int8
    cache against the JAX Engine's (its Pallas kernel in interpret mode)."""
    jm, pm = _both(ggufs["sparse"])
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.bfloat16,
                   kv_quantized=True, sparse=JaxSparseConfig(16, 4), sparse_decode_mode="pallas")
    pe = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_quantized=True,
                sparse=SparseConfig(16, 4), device="cpu")
    got = pe.generate(PROMPT, 12)
    assert got == je.generate(PROMPT, 12) and len(got) == 12 and pe.cache.quantized


def test_scheduler_streams_match_jax_with_prefix_reuse(ggufs):
    """A 2-slot Scheduler over the int8 cache against the JAX Scheduler: two
    requests at once, then one that shares the first's prompt and stream
    (its prefix reused from the slot's int8 rows and scales)."""
    path = ggufs["llama"]
    first = [[3, 14, 15, 92], [9, 26, 53]]
    kw = dict(n_slots=2, max_seq=64)
    js = JaxScheduler(jax_load(path, dtype=jnp.float32), sampler=JaxSampler(**GREEDY),
                      kv_dtype=jnp.bfloat16, kv_quantized=True, **kw)
    ps = Scheduler(load_model(path, dtype=torch.float32, device="cpu"),
                   sampler=SamplerConfig(**GREEDY), kv_quantized=True, device="cpu", **kw)
    assert ps.cache.quantized and ps.cache.k_scale.shape == (2, 2, 64, 2, 1)
    outs = []
    for sched, req_cls in ((js, JaxRequest), (ps, Request)):
        reqs = [sched.submit(req_cls(prompt_tokens=p, max_new_tokens=8)) for p in first]
        sched.run_until_idle()
        streams = [r.tokens() for r in reqs]  # tokens() drains the request's queue
        again = first[0] + streams[0][:5] + [77, 31]
        req = sched.submit(req_cls(prompt_tokens=again, max_new_tokens=8))
        sched.run_until_idle()
        outs.append((streams + [req.tokens()], sched.metrics.get("n_prompt_cached", 0)))
    (want, jcached), (got, cached) = outs
    assert got == want and all(len(g) == 8 for g in got)
    assert cached == jcached >= len(first[0]) + 5


def test_drafters_run_over_the_int8_cache(ggufs):
    """Lookup, lookahead and speculative decoding verify blocks over the
    int8 cache and, greedy, give the Engine's own stream."""
    from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.runtime.speculative import SpeculativeEngine

    model = load_model(ggufs["llama"], dtype=torch.float32, device="cpu")

    def engine():
        return Engine(model, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_quantized=True,
                      device="cpu")

    prompt = [5, 9, 5, 9, 5, 9, 42]
    want = engine().generate(prompt, 16)
    assert LookupEngine(engine(), n_draft=3).generate(prompt, 16) == want
    assert LookaheadEngine(engine()).generate(prompt, 16) == want
    assert SpeculativeEngine(engine(), engine(), n_draft=3).generate(prompt, 16) == want


def test_shift_cache_matches_jax(ggufs):
    """shift_cache on the same int8 cache (a real prefill's): K codes at most
    one apart, K scales within 1e-6, V codes and V scales bit-equal."""
    jm, pm = _both(ggufs["llama"])
    tc = tkv.init_cache(pm.config, 1, 24, torch.bfloat16, "cpu", quantized=True)
    toks = [int(t) for t in np.random.default_rng(1).integers(0, 199, 20)]
    with torch.inference_mode():
        make_forward(pm.config)(pm.params, torch.tensor([toks]), torch.arange(20)[None], tc)
    jc = jkv.KVCache(*(jnp.asarray(t.numpy()) for t in tc))
    jc = jkv.shift_cache(jc, jax_rope_params(jm.config), 2, 9, 20)
    v0 = tc.v[:, :, 11:20].clone()
    tkv.shift_cache(tc, rope_params(pm.config), 2, 9, 20)
    _codes_within_one(tc.k, jc.k, "shifted K")
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))
    assert torch.equal(tc.v[:, :, 2:11], v0)


def test_state_files_restore_both_ways(ggufs, tmp_path):
    """An int8 slot file written by the JAX package restores into the
    port's cache bit for bit, and the port's into the JAX package's; a file
    restores only into a cache of its own kind."""
    jm, pm = _both(ggufs["llama"])
    tc = tkv.init_cache(pm.config, 2, 32, torch.bfloat16, "cpu", quantized=True)
    with torch.inference_mode():
        make_forward(pm.config)(pm.params, torch.tensor([PROMPT] * 2),
                                torch.arange(len(PROMPT))[None].expand(2, -1), tc)
    n = len(PROMPT)
    path = str(tmp_path / "port.bin")
    assert tstate.save_state(path, pm.config, tc, n, tokens=PROMPT, slot=1) > 0
    jc = jkv.init_cache(jm.config, 1, 32, jnp.bfloat16, quantized=True)
    jc, jn, jtoks, _ = jstate.load_state(path, jm.config, jc)
    assert (jn, jtoks) == (n, PROMPT)
    for got, want in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(got)[:, 0, :n], want[:, 1, :n].numpy())
    jpath = str(tmp_path / "jax.bin")
    jstate.save_state(jpath, jm.config, jc, n, tokens=PROMPT)
    other = tkv.init_cache(pm.config, 1, 32, torch.bfloat16, "cpu", quantized=True)
    _, n2, toks, _ = tstate.load_state(jpath, pm.config, other)
    assert (n2, toks) == (n, PROMPT)
    for got, want in zip(other, tc):
        assert torch.equal(got[:, 0, :n], want[:, 1, :n]) and not got[:, 0, n:].any()
    with pytest.raises(ValueError, match="int8"):
        tstate.load_state(jpath, pm.config, tkv.init_cache(pm.config, 1, 32))
    fpath = str(tmp_path / "float.bin")
    tstate.save_state(fpath, pm.config, tkv.init_cache(pm.config, 1, 32), 2)
    with pytest.raises(ValueError, match="float"):
        tstate.load_state(fpath, pm.config, other)


def test_refusals_name_the_feature(ggufs, tmp_path):
    """An int8 cache over an MLA latent cache, over an iSWA cache, or under
    self-extend raises ValueError naming the feature."""
    from deepseek2_fixture import make_deepseek2

    pm = load_model(ggufs["llama"], dtype=torch.float32, device="cpu")
    kw = dict(max_seq=32, sampler=SamplerConfig(**GREEDY), kv_quantized=True, device="cpu")
    with pytest.raises(ValueError, match="self-extend .* int8"):
        Engine(pm, self_extend=(2, 8), **kw)
    with pytest.raises(ValueError, match="int8 .* iSWA"):
        Engine(pm, kv_iswa=True, **kw)
    with pytest.raises(ValueError, match="int8 .* iSWA"):
        tkv.check_int8(pm.config, iswa=True)
    make_deepseek2(tmp_path / "ds2.gguf")
    mla = load_model(str(tmp_path / "ds2.gguf"), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="int8 .* MLA"):
        Engine(mla, **kw)
    with pytest.raises(ValueError, match="int8 .* MLA"):
        tkv.init_cache(mla.config, 1, 32, quantized=True)
