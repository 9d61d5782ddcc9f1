"""The port's expert tiering (sparse/moe.py: moe_rows_layout, MoEColdStore,
make_tiered_moe_ffn over sparse/tiering.py and sparse/balancer.py) against
the JAX package's, on the CPU: the counterparts of tests/test_moe_tiering.py
on its model (a mixtral config, 4 experts of 2 groups, 2 used, a router
skewed towards experts 1 and 3), f32, the same params through from_jax.

Logits within 1e-4 of the dense MoE's scale where the tiered forward
computes every routed expert (all hot, or host mode with a partial hot
set); the DFR statistics within 1e-6 of JAX's; miss counts equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sparkinfer_tpu.models.config import ModelConfig as JaxConfig  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache  # noqa: E402
from sparkinfer_tpu.sparse import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu.sparse import moe as jmoe  # noqa: E402
from sparkinfer_tpu.sparse.balancer import Balancer as JaxBalancer  # noqa: E402
from sparkinfer_tpu.sparse.tiering import init_tiered as jax_init_tiered  # noqa: E402
from sparkinfer_tpu.sparse.tiering import tiered_layer_params as jax_layer_params  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.sparse import moe as tmoe  # noqa: E402
from sparkinfer_tpu_torch.sparse.balancer import Balancer  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse.tiering import init_tiered, tiered_layer_params  # noqa: E402

X, K, G = 4, 2, 16
E, FE, L, V = 32, 32, 2, 120
NG_E = FE // G


@pytest.fixture(scope="module")
def moe_model():
    """(JAX cfg, port cfg, numpy params) of tests/test_moe_tiering.py's model."""
    rng = np.random.default_rng(0)

    def w(*s, scale=0.2):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    kw = dict(arch="mixtral", n_layer=L, n_embd=E, n_head=4, n_head_kv=2, n_ff=FE,
              n_vocab=V, head_dim=8, n_expert=X, n_expert_used=K)
    layers = {
        "attn_norm_w": np.ones((L, E), np.float32), "ffn_norm_w": np.ones((L, E), np.float32),
        "wq": w(L, E, 32), "wk": w(L, E, 16), "wv": w(L, E, 16), "wo": w(L, 32, E),
        "w_router": (np.tile(np.array([[-2.0, 1.5, -2.0, 1.0]]), (L, E, 1))
                     + rng.standard_normal((L, E, X)) * 0.3).astype(np.float32),
        "w_up_exps": w(L, X, E, FE), "w_gate_exps": w(L, X, E, FE),
        "w_down_exps": w(L, X, FE, E),
    }
    params = {"tok_embd": w(V, E), "output_norm_w": np.ones((E,), np.float32),
              "output": w(E, V), "layers": layers}
    return JaxConfig(**kw), ModelConfig(**kw), params


class _Tiered:
    """One package's tiered forward over its own copy of the params."""

    def __init__(self, port: bool, moe_model, hot_groups, mode, init_hot=None):
        jcfg, pcfg, params = moe_model
        self.port = port
        if port:
            scfg = SparseConfig(group_size=G)
            p = params_from_numpy(params, "cpu")
            self.layers = tmoe.moe_rows_layout(p["layers"], pcfg, G)
            self.tp, self.st = init_tiered(pcfg, scfg, self.layers, hot_groups,
                                           init_hot=init_hot)
            self.cold = tmoe.MoEColdStore(pcfg, scfg, {k: v for k, v in self.layers.items()
                                                       if k.endswith("_rows")},
                                          dtype=torch.float32)
            self.fwd = make_forward(pcfg, ffn_fn=tmoe.make_tiered_moe_ffn(
                pcfg, scfg, self.cold, mode), stateful_ffn=True)
            self.p2 = dict(p)
            self.p2["layers"], self.p2["sparse_flat"] = tiered_layer_params(self.layers, self.tp)
            self.cache = init_cache(pcfg, 1, 32, torch.float32, "cpu")
        else:
            scfg = JaxSparseConfig(group_size=G)
            p = jax.tree.map(jnp.asarray, params)
            self.layers = jmoe.moe_rows_layout(p["layers"], jcfg, G)
            self.tp, self.st = jax_init_tiered(jcfg, scfg, self.layers, hot_groups,
                                               init_hot=init_hot)
            self.cold = jmoe.MoEColdStore(jcfg, scfg, {k: np.asarray(v) for k, v in
                                                       self.layers.items() if k.endswith("_rows")},
                                          dtype=np.float32)
            self.fwd = jax.jit(jax_forward(jcfg, ffn_fn=jmoe.make_tiered_moe_ffn(
                jcfg, scfg, self.cold, mode), stateful_ffn=True))
            self.p2 = dict(p)
            self.p2["layers"], self.p2["sparse_flat"] = jax_layer_params(self.layers, self.tp)
            self.cache = jax_cache(jcfg, 1, 32, jnp.float32)
        self.scfg = scfg

    def step(self, toks, start):
        """Logits (numpy) of toks at positions start.. ; the state advances."""
        if self.port:
            return self.fwd(self.p2, torch.tensor([toks]),
                            torch.arange(start, start + len(toks))[None], self.cache,
                            self.st).numpy()
        lg, self.cache, self.st = self.fwd(
            self.p2, jnp.asarray([toks], jnp.int32),
            jnp.arange(start, start + len(toks), dtype=jnp.int32)[None], self.cache, self.st)
        return np.asarray(lg)

    def rebalance(self, bal):
        if self.port:
            bal.rebalance(self.tp, self.st.dfr)
        else:
            self.tp = bal.rebalance(self.tp, np.asarray(self.st.dfr))
            self.p2["layers"], self.p2["sparse_flat"] = jax_layer_params(self.layers, self.tp)

    def stats(self):
        return (np.asarray(self.st.dfr), float(np.asarray(self.st.miss).sum()))


def _dense_logits(pcfg, params, toks):
    p = params_from_numpy(params, "cpu")
    fwd = make_forward(pcfg, ffn_fn=tmoe.make_moe_ffn(pcfg, mode="dense"))
    return fwd(p, torch.tensor([toks]), torch.arange(len(toks))[None],
               init_cache(pcfg, 1, 16, torch.float32, "cpu")).numpy()


def _both(moe_model, *args, **kw):
    return [_Tiered(port, moe_model, *args, **kw) for port in (False, True)]


def _close(got, want, tol):
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_all_hot_equals_dense(moe_model):
    """A hot set of every expert: the tiered forward equals the dense MoE
    (1e-4) and the JAX tiered forward; no misses; the DFR as JAX's."""
    toks = (np.arange(5) * 7 % V).tolist()
    jt, pt = _both(moe_model, X * NG_E, "drop")
    want, jl, pl = _dense_logits(moe_model[1], moe_model[2], toks), jt.step(toks, 0), \
        pt.step(toks, 0)
    _close(pl, want, 1e-4)
    _close(pl, jl, 1e-4)
    (jdfr, jmiss), (pdfr, pmiss) = jt.stats(), pt.stats()
    np.testing.assert_allclose(pdfr, jdfr, rtol=0, atol=1e-6)
    assert pmiss == jmiss == 0.0


def test_host_mode_with_a_partial_hot_set_equals_dense(moe_model):
    """Only expert 0 hot (the router rarely picks it): host mode computes the
    cold routed experts from the cold store and equals dense (1e-4), with
    misses, as many as JAX's."""
    toks = (np.arange(5) * 11 % V).tolist()
    init_hot = np.tile(np.arange(NG_E, dtype=np.int32), (L, 1))
    jt, pt = _both(moe_model, NG_E, "host", init_hot=init_hot)
    want, jl, pl = _dense_logits(moe_model[1], moe_model[2], toks), jt.step(toks, 0), \
        pt.step(toks, 0)
    _close(pl, want, 1e-4)
    _close(pl, jl, 1e-4)
    (jdfr, jmiss), (pdfr, pmiss) = jt.stats(), pt.stats()
    np.testing.assert_allclose(pdfr, jdfr, rtol=0, atol=1e-6)
    assert pmiss == jmiss > 0
    assert pt.cold.n_calls == L


def test_balancer_drives_drop_misses_to_zero(moe_model):
    """Drop-mode decode from a hot set of experts 0 and 1 (the router prefers
    1 and 3), a rebalance after every step: the misses of the last step are
    0, swaps were made, and the per-step misses and DFR follow JAX's."""
    init_hot = np.tile(np.arange(2 * NG_E, dtype=np.int32), (L, 1))
    jt, pt = _both(moe_model, 2 * NG_E, "drop", init_hot=init_hot)
    jbal = JaxBalancer(cold=jt.cold, scfg=jt.scfg, window=8)
    pbal = Balancer(cold=pt.cold, scfg=pt.scfg, window=8)
    misses = {"jax": [], "port": []}
    for t in range(8):
        tok = [int(t * 13 % V)]
        for name, tt, bal in (("jax", jt, jbal), ("port", pt, pbal)):
            before = tt.stats()[1]
            tt.step(tok, t)
            misses[name].append(tt.stats()[1] - before)
            tt.rebalance(bal)
        np.testing.assert_allclose(pt.stats()[0], jt.stats()[0], rtol=0, atol=1e-6)
    assert misses["port"] == misses["jax"] and misses["port"][-1] == 0.0
    assert pbal.total_swaps == jbal.total_swaps > 0
    np.testing.assert_array_equal(pt.tp.hot_ids.numpy(), np.asarray(jt.tp.hot_ids))
