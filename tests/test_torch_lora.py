"""LoRA adapters and control vectors in the port (`models/lora.py`,
`tools/export_lora.py`, the server's /lora-adapters) against the JAX
package, on the CPU, f32: merged weights within 1e-5 relative of the JAX
merge, forward logits with a control vector within 1e-5 of the JAX
forward's, export-lora's file equal to the JAX tool's, and the in-place
re-merge (`LoraMerger`) reaching the dense weights and every sparse store
the engines and the Scheduler read."""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu_torch.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu_torch.gguf.writer import GGUFWriter  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.lora import (  # noqa: E402
    LoraMerger,
    apply_control_vector,
    apply_lora,
    load_control_vector,
)
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
TARGETS = {"attn_q": "EE", "attn_output": "EE", "ffn_up": "FE", "ffn_gate": "FE", "ffn_down": "EF"}


def write_lora(path, L, E, F, rank=4, alpha=8.0, seed=0, targets=("attn_q", "ffn_up")):
    """An adapter GGUF written by the port's writer: per target A (r, in), B (out, r)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, "llama")
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", np.float32(alpha))
    dims = {"E": E, "F": F}
    for il in range(L):
        for name in targets:
            out_d, in_d = (dims[c] for c in TARGETS[name])
            w.add_tensor(f"blk.{il}.{name}.lora_a",
                         (rng.standard_normal((rank, in_d)) * 0.05).astype(np.float32),
                         GGMLType.F32)
            w.add_tensor(f"blk.{il}.{name}.lora_b",
                         (rng.standard_normal((out_d, rank)) * 0.05).astype(np.float32),
                         GGMLType.F32)
    w.write()


def write_cvec(path, L, E, seed=1):
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, "llama")
    for il in range(0, L, 2):  # odd layers absent: zero
        w.add_tensor(f"direction.{il}", (rng.standard_normal(E) * 0.3).astype(np.float32),
                     GGMLType.F32)
    w.write()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    make_tiny_llama(d / "base.gguf", arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    write_lora(str(d / "a.gguf"), 2, 64, 96)
    write_lora(str(d / "b.gguf"), 2, 64, 96, rank=2, alpha=4.0, seed=3,
               targets=("attn_output", "ffn_gate", "ffn_down"))
    write_cvec(str(d / "cv.gguf"), 2, 64)
    return {k: str(d / f"{k}.gguf") for k in ("base", "a", "b", "cv")}


def _port(path):
    return load_model(path, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("adapter,scale", [("a", 1.0), ("b", 0.5), ("a", -2.0)])
def test_apply_lora_matches_jax(files, adapter, scale):
    from sparkinfer_tpu.models.lora import apply_lora as jax_apply

    jm, pm = jax_load(files["base"], dtype=jnp.float32), _port(files["base"])
    want = jax_apply(jm.params, jm.config, files[adapter], scale)["layers"]
    got = apply_lora(pm.params, pm.config, files[adapter], scale)["layers"]
    for k in ("wq", "wo", "w_up", "w_gate", "w_down", "wk"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert got["wk"] is pm.params["layers"]["wk"]  # untouched weights shared


def test_lora_missing_tensors_rejected(files, tmp_path):
    p = tmp_path / "empty.gguf"
    w = GGUFWriter(str(p), "llama")
    w.add_kv("adapter.type", "lora")
    w.write()
    pm = _port(files["base"])
    with pytest.raises(ValueError, match="no LoRA tensors"):
        apply_lora(pm.params, pm.config, str(p))


def test_control_vector_matches_jax(files):
    from sparkinfer_tpu.models import lora as jlora
    from sparkinfer_tpu.models.transformer import make_forward as jax_fwd
    from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache
    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    jm, pm = jax_load(files["base"], dtype=jnp.float32), _port(files["base"])
    jcv = jlora.load_control_vector(files["cv"], 2, 64)
    cv = load_control_vector(files["cv"], 2, 64)
    np.testing.assert_array_equal(cv, jcv)
    assert not cv[1].any()
    jparams = jlora.apply_control_vector(jm.params, jm.config, jcv, 0.8)
    params = apply_control_vector(pm.params, pm.config, cv, 0.8)
    toks = [3, 5, 7]
    jl, _ = jax_fwd(jm.config)(jparams, jnp.asarray([toks], jnp.int32),
                               jnp.arange(3, dtype=jnp.int32)[None],
                               jax_cache(jm.config, 1, 16, jnp.float32))
    pl = make_forward(pm.config)(params, torch.tensor([toks]), torch.arange(3)[None],
                                 init_cache(pm.config, 1, 16, torch.float32))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    base = make_forward(pm.config)(pm.params, torch.tensor([toks]), torch.arange(3)[None],
                                   init_cache(pm.config, 1, 16, torch.float32))
    assert (pl - base).abs().max() > 1e-3


def test_export_lora_matches_the_jax_tool(files, tmp_path, capsys):
    from sparkinfer_tpu.tools.export_lora import main as jax_main
    from sparkinfer_tpu_torch.gguf.reader import GGUFReader
    from sparkinfer_tpu_torch.tools.export_lora import main

    out, jout = tmp_path / "m.gguf", tmp_path / "jm.gguf"
    assert main(["-m", files["base"], "--lora", files["a"], "-o", str(out)]) == 0
    assert "merged 4 tensors" in capsys.readouterr().out
    assert jax_main(["-m", files["base"], "--lora", files["a"], "-o", str(jout)]) == 0
    a, b = GGUFReader(str(out)), GGUFReader(str(jout))
    assert set(a.tensors) == set(b.tensors)
    for name in a.tensors:
        np.testing.assert_array_equal(a.tensors[name].raw(), b.tensors[name].raw())
    a.close()
    b.close()
    pm = _port(files["base"])
    merged = apply_lora(pm.params, pm.config, files["a"])
    np.testing.assert_allclose(_port(str(out)).params["layers"]["w_up"].numpy(),
                               merged["layers"]["w_up"].numpy(), **TOL)


def _engine_kinds():
    return {"dense": {}, "v6": dict(sparse=SparseConfig(16, 4)),
            "v1_rows": dict(sparse=SparseConfig(16, 4), sparse_decode_mode="gather"),
            "v1_scheduler_rows": dict(sparse=SparseConfig(16, 4), sparse_pipelined=False)}


@pytest.mark.parametrize("kind", list(_engine_kinds()))
def test_merger_rewrites_every_store_in_place(files, kind):
    """An engine built before the merge, re-merged in place, decodes as an
    engine built on apply_lora's params; at scale 0 as the base engine."""
    kw = _engine_kinds()[kind]

    def eng(model):
        return Engine(model, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, device="cpu", **kw)

    pm = _port(files["base"])
    live = eng(pm)
    base_out = live.generate([5, 9, 42], 12)
    merger = LoraMerger([pm.params, live.params], pm.config, [files["a"], files["b"]])
    merger.merge([1.0, 0.5])
    ref = _port(files["base"])
    ref.params = apply_lora(ref.params, ref.config, files["a"], 1.0)
    ref.params = apply_lora(ref.params, ref.config, files["b"], 0.5)
    want = eng(ref).generate([5, 9, 42], 12)
    assert live.generate([5, 9, 42], 12) == want and want != base_out
    merger.merge([0.0, 0.0])
    assert live.generate([5, 9, 42], 12) == base_out
    assert len(live.graphs) == 1  # one step graph throughout


def _post(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_lora_adapters_route(tmp_path):
    from sparkinfer_tpu_torch.server.app import ServerConfig, SparkServer

    path = tmp_path / "v.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, n_vocab=300,
                    with_vocab=True, seed=5)
    write_lora(str(tmp_path / "a.gguf"), 2, 64, 96, alpha=64.0)
    body = {"prompt": [1, 5, 9, 42], "max_tokens": 8, "temperature": 0}

    def serve(lora):
        srv = SparkServer(_port(str(path)), ServerConfig(
            port=0, n_slots=1, max_seq=64, kv_dtype="f32", device="cpu",
            sparse=SparseConfig(16, 4), lora=lora, slot_prompt_similarity=0.0),
            sampler=SamplerConfig(temp=0.0))
        srv.serve(block=False)
        return srv

    base_srv = serve(None)
    try:
        base = _post(base_srv.port, "/v1/completions", body)["choices"][0]["text"]
    finally:
        base_srv.shutdown()
    srv = serve([(str(tmp_path / "a.gguf"), 1.0)])
    try:
        assert _post(srv.port, "/lora-adapters") == [
            {"id": 0, "path": str(tmp_path / "a.gguf"), "scale": 1.0}]

        def text():
            srv.sched.slots[0].cached_tokens = []  # no prefix reuse across weights
            return _post(srv.port, "/v1/completions", body)["choices"][0]["text"]

        merged = text()
        assert merged != base
        assert _post(srv.port, "/lora-adapters", [{"id": 0, "scale": 0.0}])[0]["scale"] == 0.0
        assert text() == base
        _post(srv.port, "/lora-adapters", {"id": 0, "scale": 1.0})
        assert text() == merged
    finally:
        srv.shutdown()
