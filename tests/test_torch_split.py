"""Model splits (sparkinfer_tpu_torch/sparse/split.py) against the JAX
package's sparse/split.py, on the CPU, in f32, on one tiny ProSparse GGUF of
tests/model_fixtures.py (2 layers, n_ff 96, groups of 16).

Tolerances: firing rates, permutations, patterns, apportioned counts and
reordered weights bit-equal (the same counts, sorts and gathers); a split
GGUF written by either package reads back equal in the other; the reorder
leaves the forward's logits within 1e-4 (f32, the FFN's sums in another
order); the tiered Engine and Scheduler over a split give the JAX package's
greedy streams (the Scheduler with synchronous ticks, 32-token prompts: see
tests/test_torch_tiering.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.sparse import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu.sparse import split as jsplit  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.sparse import split as tsplit  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse.ffn import make_sparse_ffn  # noqa: E402

from test_torch_tiering import (  # noqa: E402
    PROMPT,
    _jax_engine,
    _jax_scheduler,
    _port_engine,
    _port_scheduler,
)

G, CAP = 16, 4
BATCHES = [np.random.default_rng(5).integers(0, 199, 8) for _ in range(3)]
FFN_KEYS = ("w_up", "w_gate", "w_down", "b_up", "pred_down", "pred_down_b")


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


@pytest.fixture(scope="module")
def firing(gguf):
    want = jsplit.profile_firing(jax_load(gguf, dtype=jnp.float32), BATCHES,
                                 JaxSparseConfig(G, CAP))
    got = tsplit.profile_firing(load_model(gguf, dtype=torch.float32, device="cpu"),
                                BATCHES, SparseConfig(G, CAP))
    return want, got


@pytest.fixture(scope="module")
def split_file(gguf, firing, tmp_path_factory):
    path = tmp_path_factory.mktemp("split") / "split.gguf"
    jsplit.write_split(str(path), jsplit.build_split(firing[0], JaxSparseConfig(G, CAP)),
                       arch="prosparse_llama")
    return str(path)


def test_profile_firing_matches_jax(firing):
    want, got = firing
    assert got.shape == (2, 96)
    np.testing.assert_array_equal(got, want)
    # the fixture's last third of neurons never fires
    assert np.allclose(got[:, 64:], 0.0) and got.max() > 0


def test_build_split_matches_jax(firing):
    want = jsplit.build_split(firing[0], JaxSparseConfig(G, CAP))
    got = tsplit.build_split(firing[1], SparseConfig(G, CAP))
    assert got.group_size == want.group_size == G
    np.testing.assert_array_equal(got.perms, want.perms)
    np.testing.assert_array_equal(got.pattern, want.pattern)
    assert np.isclose(got.pattern.sum(), 1.0, atol=1e-5)
    for l in range(2):  # hottest first
        assert (np.diff(got.firing[l][got.perms[l]]) <= 1e-9).all()


@pytest.mark.parametrize("budget,pattern,ng", [
    (10, [0.5, 0.3, 0.2], 6), (100, [0.5, 0.3, 0.2], 6), (7, [0.25, 0.25, 0.25, 0.25], 5),
    (13, [0.7, 0.1, 0.1, 0.1], 4), (0, [0.6, 0.4], 3),
])
def test_apportion_matches_jax(budget, pattern, ng):
    pattern = np.asarray(pattern, np.float32)
    got = tsplit.apportion(budget, pattern, ng)
    np.testing.assert_array_equal(got, jsplit.apportion(budget, pattern, ng))
    assert got.sum() == min(budget, ng * len(pattern)) and (got <= ng).all()


def _perms(L, F):
    return np.stack([np.random.default_rng(l).permutation(F).astype(np.int32) for l in range(L)])


@pytest.mark.parametrize("inplace,keys", [(False, None), (True, None),
                                          (True, ("b_up", "pred_down", "pred_down_b"))])
def test_apply_reorder_matches_jax(gguf, inplace, keys):
    jm = jax_load(gguf, dtype=jnp.float32)
    pm = load_model(gguf, dtype=torch.float32, device="cpu")
    perms = _perms(2, 96)
    before = dict(pm.params["layers"])
    want = jsplit.apply_reorder(jm.params, jm.config, perms, keys=keys)["layers"]
    got = tsplit.apply_reorder(pm.params, pm.config, perms, inplace=inplace, keys=keys)["layers"]
    for k in FFN_KEYS:
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            moved = keys is None or k in keys
            assert (got[k] is before[k]) == (not moved)
    # inplace rebinds the caller's layers; the copy leaves them as they were
    assert (pm.params["layers"] is got) == inplace
    if not inplace:
        assert all(pm.params["layers"][k] is v for k, v in before.items())


def test_reorder_preserves_function(gguf):
    pm = load_model(gguf, dtype=torch.float32, device="cpu")
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.n_vocab, 6))[None]
    pos = torch.arange(6)[None]
    params2 = tsplit.apply_reorder(pm.params, cfg, _perms(cfg.n_layer, cfg.n_ff))
    for ffn in (None, make_sparse_ffn(cfg, scfg, mode="dense")):
        fwd = make_forward(cfg, ffn_fn=ffn)
        with torch.inference_mode():
            a = fwd(pm.params, toks, pos, init_cache(cfg, 1, 16, torch.float32, "cpu"))
            b = fwd(params2, toks, pos, init_cache(cfg, 1, 16, torch.float32, "cpu"))
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_split_file_round_trip(firing, tmp_path, writer):
    """A split GGUF written by one package reads back equal in the other."""
    split = tsplit.build_split(firing[1], SparseConfig(G, CAP))
    path = str(tmp_path / "split.gguf")
    if writer == "port":
        tsplit.write_split(path, split, arch="prosparse_llama")
        back = jsplit.read_split(path)
    else:
        jsplit.write_split(path, jsplit.build_split(firing[0], JaxSparseConfig(G, CAP)),
                           arch="prosparse_llama")
        back = tsplit.read_split(path)
    assert back.group_size == G
    np.testing.assert_array_equal(back.perms, split.perms)
    np.testing.assert_array_equal(back.pattern, split.pattern)
    np.testing.assert_array_equal(back.firing, split.firing)
    no_firing = tsplit.ModelSplit(G, split.pattern, split.perms)
    tsplit.write_split(path, no_firing)
    assert tsplit.read_split(path).firing is None


@pytest.mark.parametrize("mode", ["host", "drop", "fetch"])
def test_engine_over_a_split_matches_jax(gguf, split_file, mode):
    want = _jax_engine(gguf, mode, split=split_file).generate(PROMPT, max_new_tokens=10)
    pe = _port_engine(gguf, mode, split=tsplit.read_split(split_file))
    assert pe.generate(PROMPT, max_new_tokens=10) == want
    if mode == "host":  # exact: the split changes no token of the untiered engine
        assert _port_engine(gguf, mode).generate(PROMPT, max_new_tokens=10) == want


@pytest.mark.parametrize("prefill_mode", ["rows", "tiered"])
def test_scheduler_over_a_split_matches_jax(gguf, split_file, monkeypatch, prefill_mode):
    monkeypatch.setenv("SPARK_SCHED_PIPELINE", "0")
    want = _jax_scheduler(gguf, "fetch", prefill_mode, split=split_file)
    _, _, got = _port_scheduler(gguf, "fetch", prefill_mode, split=split_file)
    assert got == want
