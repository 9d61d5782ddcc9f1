"""The row-store kernels v2, v3, v4 and v5 of the port against the JAX
package's, on the CPU.

Inputs come from numpy seeds at a small size (N=3, C=4, E=64, G=16, R=10).
The JAX kernels run in interpret mode. Tolerances:
  - plain v2-v5 against the JAX kernels: rtol=atol=1e-5 (f32 sums in
    another order); with bf16 stores the same, since both sides round the
    same f32 hidden to bf16 and no seed here puts one on a rounding
    boundary;
  - interleave_rows: bit-equal.
Row ids stay in [0, R) for the JAX comparisons: the port clamps ids outside
it (for v2 into the projection's own rows), where the JAX kernels read
other rows.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sparkinfer_tpu.ops import sparse_ffn_pallas as jk  # noqa: E402
from sparkinfer_tpu_torch.ops import sparse_ffn as tk  # noqa: E402

G = 16
TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, gated, bias):
    rng = np.random.default_rng(seed)
    N, C, E, R = 3, 4, 64, 10
    f = lambda *s, k=0.2: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    idx = np.stack([rng.choice(R, C, replace=False) for _ in range(N)]).astype(np.int32)
    return dict(x=f(N, E, k=1.0), idx=idx, gp=rng.uniform(0, 1, (N, C, G)).astype(np.float32),
                wu=f(R, G, E), wg=f(R, G, E) if gated else None, wd=f(R, G, E),
                bu=f(N, C, G, k=0.1) if bias else None, R=R)


def _j(a, dt=None):
    return None if a is None else jnp.asarray(a, dt)


def _t(a, dt=None):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dt or torch.float32)


def _calls(kernel, a, jdt, tdt, gated, kw):
    """(JAX call, port plain call, port wrapper call) of one kernel on the
    inputs a, each store built from the same (R, G, E) rows."""
    stores = [a["wu"]] + ([a["wg"]] if gated else []) + [a["wd"]]
    jx, jidx, jgp, jbu = _j(a["x"], jdt), _j(a["idx"]), _j(a["gp"]), _j(a["bu"])
    tx, tidx, tgp, tbu = _t(a["x"], tdt), _t(a["idx"], torch.int32), _t(a["gp"]), _t(a["bu"])
    if kernel in ("v3", "v5"):
        jw = [_j(a[k], jdt) for k in ("wu", "wg", "wd")]
        tw = [_t(a[k], tdt) for k in ("wu", "wg", "wd")]
        jf = {"v3": jk.sparse_ffn_block_v3, "v5": jk.sparse_ffn_block_v5}[kernel]
        plain = {"v3": tk.sparse_ffn_block_v3_plain, "v5": tk.sparse_ffn_block_v5_plain}[kernel]
        wrap = {"v3": tk.sparse_ffn_block_v3, "v5": tk.sparse_ffn_block_v5}[kernel]
        return (lambda: jf(jx, jidx, jgp, *jw, bu_sel=jbu, **kw),
                lambda f: f(tx, tidx, tgp, *tw, bu_sel=tbu, **kw), plain, wrap)
    if kernel == "v4":
        jw = jk.interleave_rows(*[_j(a[k], jdt) for k in ("wu", "wg", "wd")])
        tw = tk.interleave_rows(*[_t(a[k], tdt) for k in ("wu", "wg", "wd")])
        kw = dict(kw, gated=gated)
        return (lambda: jk.sparse_ffn_block_v4(jx, jidx, jgp, jw, bu_sel=jbu, **kw),
                lambda f: f(tx, tidx, tgp, tw, bu_sel=tbu, **kw),
                tk.sparse_ffn_block_v4_plain, tk.sparse_ffn_block_v4)
    jw = jnp.concatenate([_j(w, jdt) for w in stores])
    tw = torch.cat([_t(w, tdt) for w in stores])
    kw = dict(kw, gated=gated, R=a["R"])
    return (lambda: jk.sparse_ffn_block_v2(jx, jidx, jgp, jw, bu_sel=jbu, **kw),
            lambda f: f(tx, tidx, tgp, tw, bu_sel=tbu, **kw),
            tk.sparse_ffn_block_v2_plain, tk.sparse_ffn_block_v2)


# v3 and v5: "gated" is whether a gate store is passed; relu ignores it.
# v2 and v4: "gated" is their argument; only relu runs ungated.
_CASES = ([(k, act, True) for k in ("v3", "v5")
           for act in ("fatrelu", "drelu", "relu", "silu", "gelu")]
          + [(k, "relu", False) for k in ("v3", "v5")]
          + [(k, act, True) for k in ("v4", "v2")
             for act in ("fatrelu", "drelu", "relu", "silu", "gelu", "swiglu_oai")]
          + [(k, "relu", False) for k in ("v4", "v2")])


@pytest.mark.parametrize("kernel,act,gated,mask_mode,bias,store", [
    c + rest for c in _CASES
    for rest in itertools.product(["threshold", "scale"], [True, False], ["f32", "bf16"])])
def test_plain_row_kernels_match_jax(kernel, act, gated, mask_mode, bias, store):
    a = _inputs(7, gated, bias)
    jdt, tdt = DTYPES[store]
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5, mask_mode=mask_mode)
    jax_call, port_call, plain, wrap = _calls(kernel, a, jdt, tdt, gated, kw)
    got = port_call(plain)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_call()), **TOL)
    before = wrap.launches
    assert torch.equal(port_call(wrap), got)
    assert wrap.launches == before  # CPU: the plain version, uncounted


def test_row_kernels_are_v1_without_gate_bias():
    """v2-v5 compute v1's function (bg_sel None): one f32 result for all."""
    a = _inputs(8, True, True)
    kw = dict(act="fatrelu", fatrelu_threshold=0.05, prob_threshold=0.5,
              mask_mode="threshold")
    x, idx, gp, bu = _t(a["x"]), _t(a["idx"], torch.int32), _t(a["gp"]), _t(a["bu"])
    wu, wg, wd = (_t(a[k], torch.bfloat16) for k in ("wu", "wg", "wd"))
    ref = tk.sparse_ffn_block_plain(x, idx, gp, wu, wg, wd, bu_sel=bu, **kw)
    outs = [tk.sparse_ffn_block_v3_plain(x, idx, gp, wu, wg, wd, bu_sel=bu, **kw),
            tk.sparse_ffn_block_v5_plain(x, idx, gp, wu, wg, wd, bu_sel=bu, **kw),
            tk.sparse_ffn_block_v4_plain(x, idx, gp, tk.interleave_rows(wu, wg, wd),
                                         gated=True, bu_sel=bu, **kw),
            tk.sparse_ffn_block_v2_plain(x, idx, gp, torch.cat([wu, wg, wd]), gated=True,
                                         R=a["R"], bu_sel=bu, **kw)]
    for out in outs:
        assert torch.equal(out, ref)


def test_row_kernels_reject_what_jax_cannot_compute():
    """Each case fails in the JAX package too (a None gate reaches the
    activation, or an assert on the store's shape); the port raises
    ValueError before any work."""
    a = _inputs(9, True, False)
    x, idx, gp = _t(a["x"]), _t(a["idx"], torch.int32), _t(a["gp"])
    wu, wg, wd = (_t(a[k]) for k in ("wu", "wg", "wd"))
    R = a["R"]
    for f in (tk.sparse_ffn_block_v3, tk.sparse_ffn_block_v5):
        with pytest.raises(ValueError):  # swiglu_oai is gated for neither
            f(x, idx, gp, wu, wg, wd, act="swiglu_oai")
        with pytest.raises(ValueError):  # a gated activation without its gate
            f(x, idx, gp, wu, None, wd, act="silu")
    with pytest.raises(ValueError):  # gated=False with a gated activation
        tk.sparse_ffn_block_v4(x, idx, gp, tk.interleave_rows(wu, None, wd), act="fatrelu",
                               gated=False)
    with pytest.raises(ValueError):  # a 3-projection store called ungated
        tk.sparse_ffn_block_v4(x, idx, gp, tk.interleave_rows(wu, wg, wd), act="relu",
                               gated=False)
    with pytest.raises(ValueError):
        tk.sparse_ffn_block_v2(x, idx, gp, torch.cat([wu, wd]), act="silu", gated=False, R=R)
    with pytest.raises(ValueError):  # 3R rows called ungated
        tk.sparse_ffn_block_v2(x, idx, gp, torch.cat([wu, wg, wd]), act="relu", gated=False,
                               R=R)
    with pytest.raises(ValueError):
        tk.sparse_ffn_block_v2(x, idx, gp, torch.cat([wu, wg, wd]), act="geglu", gated=True,
                               R=R)
    jx, jidx, jgp = _j(a["x"]), _j(a["idx"]), _j(a["gp"])
    with pytest.raises(TypeError):
        jk.sparse_ffn_block_v3(jx, jidx, jgp, _j(a["wu"]), _j(a["wg"]), _j(a["wd"]),
                               act="swiglu_oai")
    with pytest.raises(TypeError):
        jk.sparse_ffn_block_v4(jx, jidx, jgp, jk.interleave_rows(_j(a["wu"]), None, _j(a["wd"])),
                               act="fatrelu", gated=False)


def test_row_ids_are_clamped_into_each_projection():
    """Ids outside [0, R) read row 0 or R-1 of the same projection, for v2
    too, whose concatenated store holds the other projections' rows there."""
    a = _inputs(10, True, True)
    kw = dict(act="drelu", bu_sel=_t(a["bu"]))
    x, gp, R = _t(a["x"]), _t(a["gp"]), a["R"]
    wu, wg, wd = (_t(a[k]) for k in ("wu", "wg", "wd"))
    idx = _t(a["idx"], torch.int32)
    bad = idx.clone()
    bad[0, 0], bad[1, 1] = R + 3, -2
    fixed = bad.clamp(0, R - 1)
    w_all = torch.cat([wu, wg, wd])
    for f in (lambda i: tk.sparse_ffn_block_v2(x, i, gp, w_all, gated=True, R=R, **kw),
              lambda i: tk.sparse_ffn_block_v3(x, i, gp, wu, wg, wd, **kw),
              lambda i: tk.sparse_ffn_block_v4(x, i, gp, tk.interleave_rows(wu, wg, wd),
                                               gated=True, **kw)):
        assert torch.equal(f(bad), f(fixed))
        assert not torch.equal(f(bad), f(idx))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_interleave_rows_bit_equal(gated, store):
    rng = np.random.default_rng(11)
    jdt, tdt = DTYPES[store]
    ws = [rng.standard_normal((2, 5, G, 8)).astype(np.float32) for _ in range(3)]
    if not gated:
        ws[1] = None
    ref = np.asarray(jk.interleave_rows(*[_j(w, jdt) for w in ws]))
    got = tk.interleave_rows(*[_t(w, tdt) for w in ws])
    assert got.dtype == tdt and got.shape == ref.shape == (2, 5, 3 if gated else 2, G, 8)
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))
