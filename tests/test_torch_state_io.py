"""Session and slot state files in the port (`runtime/state_io.py`): a
continuation from a restored state equals never having stopped, a wrong
model is refused, and the file format is the JAX package's, so a file saved
by either package restores in the other (the JAX Engine's continuation from
a port file and the port's from a JAX file equal the uninterrupted stream);
the Scheduler's save_slot / restore_slot and the server's /slots routes.
CPU, f32 caches (the int8 cache's files: tests/test_torch_kvq.py)."""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

PROMPT = [3, 14, 15, 92]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("models") / "tiny.gguf"
    make_tiny_llama(p, arch="prosparse_llama", pred_rank=8, n_ff=96, n_vocab=300,
                    with_vocab=True, seed=5)
    return str(p)


def _eng(path, **kw):
    return Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=64,
                  sampler=kw.pop("sampler", SamplerConfig(temp=0.0)),
                  kv_dtype=torch.float32, device="cpu", **kw)


def _jax_eng(path):
    return JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=64,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32, donate_cache=False)


def _chain(eng, prompt, k, cache=None, st=None):
    """prefill + k decode steps: (tokens, cache, state, n_past)."""
    cache = cache if cache is not None else eng.new_cache()
    st = st if st is not None else eng.new_sampler_state()
    tok, cache, st, n_past = eng.prefill(prompt, cache, st)
    toks = [tok]
    for _ in range(k):
        tok, cache, st = eng.decode_step(tok, n_past, cache, st)
        n_past += 1
        toks.append(tok)
    return toks, cache, st, n_past


def _continue(eng, tok, n_past, cache, st, k):
    out = []
    for _ in range(k):
        tok, cache, st = eng.decode_step(tok, n_past, cache, st)
        n_past += 1
        out.append(tok)
    return out


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_save_restore_continuation(path, tmp_path, sparse):
    kw = dict(sparse=SparseConfig(16, 4)) if sparse else {}
    eng = _eng(path, **kw)
    full, *_ = _chain(eng, PROMPT, 8)
    part, cache, st, n_past = _chain(eng, PROMPT, 4)
    p = tmp_path / "sess.state"
    assert eng.save_session(str(p), cache, n_past, st, tokens=PROMPT + part) > 0
    eng2 = _eng(path, **kw)
    own = eng2.own_cache()
    cache2, n_past2, toks2, st2 = eng2.load_session(str(p))
    assert cache2 is own and st2 is eng2.sstate  # restored in place
    assert n_past2 == n_past and toks2 == PROMPT + part
    assert part + _continue(eng2, part[-1], n_past2, cache2, st2, 4) == full


def test_sampler_state_round_trips(path, tmp_path):
    sc = SamplerConfig(temp=0.9, penalty_repeat=1.2, mirostat=2)
    eng = _eng(path, sampler=sc)
    full, *_ = _chain(eng, PROMPT, 8)
    part, cache, st, n_past = _chain(eng, PROMPT, 4)
    p = tmp_path / "s.state"
    eng.save_session(str(p), cache, n_past, st)
    mu, ring = float(st.mirostat_mu), st.recent.clone()
    eng2 = _eng(path, sampler=sc)
    cache2, n2, _, st2 = eng2.load_session(str(p))
    assert float(st2.mirostat_mu) == mu and torch.equal(st2.recent, ring)
    assert part + _continue(eng2, part[-1], n2, cache2, st2, 4) == full


def test_restore_rejects_wrong_model(path, tmp_path):
    eng = _eng(path)
    _, cache, st, n_past = _chain(eng, [1, 2, 3], 2)
    p = tmp_path / "sess.state"
    eng.save_session(str(p), cache, n_past, st)
    other = tmp_path / "other.gguf"
    make_tiny_llama(other, n_layer=3)
    with pytest.raises(ValueError, match="different model"):
        _eng(str(other)).load_session(str(p))


def test_files_cross_between_the_packages(path, tmp_path):
    """A JAX save restores in the port, a port save in the JAX Engine; both
    continuations equal the uninterrupted greedy stream."""
    jeng, peng = _jax_eng(path), _eng(path)
    full, *_ = _chain(peng, PROMPT, 8)

    jpart, jcache, jst, jn = _chain(jeng, PROMPT, 4)
    assert jpart == full[:5]
    jfile = tmp_path / "jax.state"
    jeng.save_session(str(jfile), jcache, jn, jst, tokens=PROMPT + jpart)
    eng2 = _eng(path)
    cache, n, toks, st = eng2.load_session(str(jfile))
    assert toks == PROMPT + jpart
    assert jpart + _continue(eng2, jpart[-1], n, cache, st, 4) == full

    ppart, pcache, pst, pn = _chain(peng, PROMPT, 4)
    pfile = tmp_path / "port.state"
    peng.save_session(str(pfile), pcache, pn, pst, tokens=PROMPT + ppart)
    jeng2 = _jax_eng(path)
    jc, jn2, jtoks, jst2 = jeng2.load_session(str(pfile))
    assert jn2 == pn and jtoks == PROMPT + ppart
    assert ppart + _continue(jeng2, ppart[-1], jn2, jc, jst2, 4) == full


def test_bf16_rows_are_stored_as_numpy_stores_jax_bf16(path, tmp_path):
    import zipfile

    eng = Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=64,
                 sampler=SamplerConfig(temp=0.0), kv_dtype=torch.bfloat16, device="cpu")
    part, cache, st, n_past = _chain(eng, PROMPT, 3)
    p = tmp_path / "bf16.state"
    eng.save_session(str(p), cache, n_past, st)
    with zipfile.ZipFile(p) as z:
        meta = json.loads(z.read("meta.json"))
        k = np.load(__import__("io").BytesIO(z.read("k.npy")))
    assert meta["kv_dtype"] == "bfloat16" and k.dtype.str == "|V2"
    want = cache.k[:, 0, :n_past].clone()
    cache.k.zero_()
    eng.load_session(str(p))
    assert torch.equal(eng.cache.k[:, 0, :n_past], want)


def _sched(path, **kw):
    return Scheduler(load_model(path, dtype=torch.float32, device="cpu"), n_slots=3,
                     max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                     device="cpu", slot_similarity=0.5, **kw)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse_v1"])
def test_scheduler_slot_restore_serves_the_prefix(path, tmp_path, sparse):
    """Save a slot after a request, clear it, restore the file into another
    slot: a request sharing the prefix reuses the restored rows and streams
    what it streams over the original slot's rows."""
    kw = dict(sparse=SparseConfig(16, 4), sparse_batch_max=3) if sparse else {}
    ref, sched = _sched(path, **kw), _sched(path, **kw)
    for s in (ref, sched):
        a = s.submit(Request(prompt_tokens=PROMPT, max_new_tokens=6))
        s.run_until_idle()
        first = a.tokens()
    cont = PROMPT + first + [7, 8]
    r = ref.submit(Request(prompt_tokens=cont, max_new_tokens=6))
    ref.run_until_idle()
    want = r.tokens()

    f = tmp_path / "slot0.state"
    assert sched.save_slot(0, str(f)) > 0
    n_past = sched.slots[0].n_past
    sched.slots[0].cached_tokens = []
    sched.cache.k[:, 0].zero_()
    info = sched.restore_slot(2, str(f))
    assert info == {"n_past": n_past, "n_tokens": n_past}
    b = sched.submit(Request(prompt_tokens=cont, max_new_tokens=6))
    sched.run_until_idle()
    assert b.tokens() == want
    assert sched.metrics["n_prompt_cached"] == ref.metrics["n_prompt_cached"]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_slot_routes(path, tmp_path):
    from sparkinfer_tpu_torch.server.app import ServerConfig, SparkServer

    srv = SparkServer(load_model(path, dtype=torch.float32, device="cpu"),
                      ServerConfig(port=0, n_slots=2, max_seq=64, kv_dtype="f32", device="cpu",
                                   slot_save_path=str(tmp_path)),
                      sampler=SamplerConfig(temp=0.0))
    srv.serve(block=False)
    try:
        body = {"prompt": [1, 5, 9, 42], "max_tokens": 4, "temperature": 0}
        assert _post(srv.port, "/v1/completions", body)[0] == 200
        code, out = _post(srv.port, "/slots/0?action=save", {"filename": "a.state"})
        assert code == 200 and out["saved"] and (tmp_path / "a.state").exists()
        code, out = _post(srv.port, "/slots/1?action=restore", {"filename": "a.state"})
        assert code == 200 and out["restored"] and out["n_past"] == srv.sched.slots[0].n_past
        assert srv.sched.slots[1].cached_tokens == srv.sched.slots[0].cached_tokens
        assert _post(srv.port, "/slots/0?action=save", {"filename": "../x"})[0] == 400
        assert _post(srv.port, "/slots/0?action=drop", {"filename": "a.state"})[0] == 400
        assert _post(srv.port, "/slots/1?action=restore", {"filename": "none.state"})[0] == 400
    finally:
        srv.shutdown()


def test_port_restores_a_jax_bf16_file(path, tmp_path):
    """The JAX package writes bf16 rows as numpy's two-byte void elements and
    cannot read them back (its `jnp.asarray(..., bfloat16)` has no cast from
    them); the port reads them as bf16 bits: the rows equal the JAX cache's."""
    jeng = JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=64,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.bfloat16, donate_cache=False)
    _, jcache, jst, jn = _chain(jeng, PROMPT, 3)
    f = tmp_path / "jax-bf16.state"
    jeng.save_session(str(f), jcache, jn, jst)
    with pytest.raises(ValueError):
        jeng.load_session(str(f))
    eng = Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=64,
                 sampler=SamplerConfig(temp=0.0), kv_dtype=torch.bfloat16, device="cpu")
    cache, n, _, _ = eng.load_session(str(f))
    want = torch.from_numpy(np.asarray(jcache.k[:, 0, :jn].astype(jnp.float32)))
    assert n == jn and torch.equal(cache.k[:, 0, :n].float(), want)
