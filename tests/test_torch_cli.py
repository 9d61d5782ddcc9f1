"""The port's CLI (`python -m sparkinfer_tpu_torch.tools.cli`) against the
JAX package's (`python -m sparkinfer_tpu.tools.cli`), both in this process
on the CPU over the same tiny GGUFs, with both loaders made to load f32
weights (each CLI loads bf16, whose roundings differ between the packages
by a few ulps and flip near-ties) and an f32 KV cache (-ctk f32): the
printed streams must be equal for plain decode,
--sparse, --draft-mode lookup and lookahead, -gan/-gaw, --keep past
max_seq, the penalties and a LoRA adapter; bench mode; the sparse flags'
plumbing (-vb, --spif-ms, group-size fallback, --cold-mode fetch); W8A8
attention (--attn-w8a8, dense and sparse, and its refusal beside a LoRA
adapter of the attention); --kv-iswa on a tiny gemma2 printing the stream
of the full cache; -ctk q8 -ctv q8 and a split -ctv printing the JAX CLI's
stream; and the flags whose modules are not ported fail at startup naming
the module."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.tools.cli import main as jax_main  # noqa: E402
from sparkinfer_tpu_torch.tools.cli import (  # noqa: E402
    build_parser,
    main,
    make_engine,
)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    make_tiny_llama(d / "ids.gguf", arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    make_tiny_llama(d / "vocab.gguf", n_vocab=300, with_vocab=True)
    make_tiny_llama(d / "dense.gguf", seed=2)
    make_tiny_llama(d / "gemma2.gguf", arch="gemma2", n_layer=4, seed=6,  # window 8
                    extra_kv={"gemma2.attention.sliding_window": np.uint32(8)})
    from test_torch_lora import write_lora

    write_lora(str(d / "lora.gguf"), 2, 64, 96, alpha=32.0)
    return {k: str(d / f"{k}.gguf") for k in ("ids", "vocab", "dense", "lora", "gemma2")}


@pytest.fixture(autouse=True)
def f32_loads(monkeypatch):
    import jax.numpy as jnp

    from sparkinfer_tpu.models import loader as jax_loader
    from sparkinfer_tpu_torch.models import loader

    jax_load, load = jax_loader.load_model, loader.load_model
    monkeypatch.setattr(jax_loader, "load_model",
                        lambda path, **kw: jax_load(path, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(loader, "load_model",
                        lambda path, **kw: load(path, **{**kw, "dtype": torch.float32}))


def _both(capsys, argv):
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    return capsys.readouterr().out, want


BASE = ["-n", "40", "--temp", "0", "-ctk", "f32"]


@pytest.mark.parametrize("model,flags", [
    ("dense", []),
    ("ids", ["--group-size", "16", "--capacity-groups", "4"]),
    ("ids", ["--dense"]),
    ("dense", ["--draft-mode", "lookup", "--draft", "4"]),
    ("dense", ["--draft-mode", "lookahead", "--draft", "3"]),
    ("ids", ["--sparse", "--group-size", "16", "--capacity-groups", "4",
             "--draft-mode", "lookup"]),
    ("dense", ["-gan", "2", "-gaw", "8", "-c", "96"]),
    ("vocab", ["-c", "24", "--keep", "2"]),
    ("dense", ["-c", "20"]),
    ("dense", ["--repeat-penalty", "1.3", "--repeat-last-n", "16",
               "--presence-penalty", "0.2"]),
    ("vocab", []),
    ("vocab", ["-c", "32", "--keep", "3", "--ignore-eos"]),
    ("dense", ["--attn-w8a8"]),
    ("ids", ["--attn-w8a8", "--group-size", "16", "--capacity-groups", "4"]),
], ids=["dense", "sparse", "dense_flag", "lookup", "lookahead", "sparse_lookup", "self_extend",
        "keep", "shift", "penalties", "vocab", "vocab_shift", "attn_w8a8", "sparse_attn_w8a8"])
def test_streams_match_the_jax_cli(files, capsys, model, flags):
    prompt = "hello world the" if model == "vocab" else "5 9 42 7 5 9 42 7"
    got, want = _both(capsys, ["-m", files[model], "-p", prompt] + BASE + flags)
    assert got == want and len(got.split()) >= (3 if model == "vocab" else 40)


def test_keep_applies_to_token_id_prompts(files, capsys):
    """The JAX CLI drops --keep for a GGUF without a vocabulary (it always
    keeps the whole prompt there); the port keeps n_keep tokens, as its
    Engine does for any prompt."""
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    assert main(["-m", files["dense"], "-p", "5 9 42 7 5 9 42 7", "-c", "24", "--keep", "2",
                 "--device", "cpu"] + BASE) == 0
    got = [int(t) for t in capsys.readouterr().out.split()]
    eng = Engine(_load(files["dense"]), max_seq=24, sampler=SamplerConfig(temp=0.0),
                 kv_dtype=torch.float32, device="cpu")
    assert got == eng.generate([5, 9, 42, 7, 5, 9, 42, 7], 40, n_keep=2)
    assert got != eng.generate([5, 9, 42, 7, 5, 9, 42, 7], 40)


def test_lora_flag_matches_the_jax_cli(files, capsys):
    argv = ["-m", files["ids"], "-p", "5 9 42", "--dense"] + BASE
    got, want = _both(capsys, argv + ["--lora-scaled", files["lora"], "0.7"])
    base, _ = _both(capsys, argv)
    assert got == want and got != base


def test_attn_w8a8_with_an_attention_lora_fails_naming_both_flags(files, tmp_path, capsys):
    """The JAX CLI fails here too (its merge indexes the W8A8 weight); an
    adapter of the FFN merges beside W8A8 attention as in the JAX CLI."""
    from test_torch_lora import write_lora

    write_lora(str(tmp_path / "q.gguf"), 2, 64, 96, targets=("attn_q",))
    with pytest.raises(ValueError, match="--lora and --attn-w8a8"):
        main(["-m", files["dense"], "-p", "5 9 42", "--device", "cpu", "--attn-w8a8",
              "--lora", str(tmp_path / "q.gguf")] + BASE)
    write_lora(str(tmp_path / "up.gguf"), 2, 64, 96, alpha=32.0, targets=("ffn_up",))
    argv = ["-m", files["ids"], "-p", "5 9 42", "--dense", "--attn-w8a8"] + BASE
    got, want = _both(capsys, argv + ["--lora", str(tmp_path / "up.gguf")])
    assert got == want and got != _both(capsys, argv)[0]


def test_bench_mode(files, tmp_path, capsys):
    pf = tmp_path / "prompts.txt"
    pf.write_text("hello world\nthe hello\n")
    assert main(["-m", files["vocab"], "-f", str(pf), "-nps", "2", "-n", "4", "--temp", "0",
                 "-c", "64", "--json", "-ctk", "f32", "--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["prompt"] for r in rows] == [0, 1]
    assert all(r["decode_tokens"] == 3 and r["prefill_tokens"] >= 2 for r in rows)


def test_grammar_mode_matches_the_jax_cli(files, capsys):
    argv = ["-m", files["vocab"], "-p", "hello", "-n", "6", "--temp", "0", "-ctk", "f32",
            "--grammar", 'root ::= ("hello" | "world" | " ")+']
    got, want = _both(capsys, argv)
    assert got == want and got.startswith("hello") and len(got) > len("hello\n")


@pytest.mark.parametrize("penalty", [["--repeat-penalty", "1.1"], ["--presence-penalty", "0.2"],
                                     ["--frequency-penalty", "0.3"]],
                         ids=["repeat", "presence", "frequency"])
@pytest.mark.parametrize("mode", ["lookup", "lookahead"])
def test_draft_mode_refuses_penalties(files, capsys, mode, penalty):
    """--draft-mode with a penalty exits 1 naming the conflict (the JAX CLI
    runs it, and its drafted stream is neither penalized nor plain greedy)."""
    assert main(["-m", files["dense"], "-p", "5 9 42", "--device", "cpu", "--draft-mode", mode]
                + BASE + penalty) == 1
    err = capsys.readouterr().err
    assert "--draft-mode cannot run with" in err and penalty[0] in err


def test_missing_prompt_and_model(files, capsys):
    assert main(["-m", files["dense"], "--device", "cpu"]) == 1
    assert main(["-p", "1 2", "--device", "cpu"]) == 1


@pytest.mark.parametrize("flags,module", [
    (["-hf", "acme/tiny"], "tools/hf.py"),
    (["--kv-iswa"], "iSWA"), (["-ctk", "q8", "-ctv", "q8"], "quantized KV"),
    (["-ctv", "f32"], "split-dtype"),
])
def test_unported_flags_fail_naming_the_module(files, capsys, flags, module):
    """Each flag whose module is not ported exits 2 naming it. --kv-iswa is
    ported now, and its case checks it runs instead: on a tiny gemma2 GGUF
    (window 8) with -b 4 (rings of 12 slots, wrapped by the 43 positions of
    the run) it prints the tokens of the run without it. The int8 cache
    (-ctk q8 -ctv q8) and a split cache (-ctv f32 beside the default bf16
    K) are ported too: each prints the JAX CLI's stream on the same flags,
    the int8 case through context shifts (-c 20)."""
    if module in ("quantized KV", "split-dtype"):
        extra = ["-c", "20"] if module == "quantized KV" else []
        got, want = _both(capsys, ["-m", files["dense"], "-p", "5 9 42", "-n", "40",
                                   "--temp", "0"] + extra + flags)
        assert got == want and len(got.split()) == 40
        return
    if flags == ["--kv-iswa"]:
        argv = ["-m", files["gemma2"], "-p", "5 9 42", "-c", "64", "-b", "4",
                "--device", "cpu"] + BASE
        assert main(argv) == 0
        want = capsys.readouterr().out
        assert main(argv + flags) == 0
        got = capsys.readouterr().out
        assert got == want and len(got.split()) == 40
        return
    with pytest.raises(SystemExit) as e:
        main(["-m", files["dense"], "-p", "1 2", "--device", "cpu"] + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert module in err and "not ported yet" in err


def test_encoder_decoder_model_fails_naming_the_module(tmp_path, capsys):
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    p = tmp_path / "t5.gguf"
    w = GGUFWriter(str(p), "t5")
    for k, v in {"block_count": 1, "embedding_length": 8, "feed_forward_length": 16,
                 "attention.head_count": 2, "context_length": 64}.items():
        w.add_kv(f"t5.{k}", np.uint32(v))
    w.add_tensor("token_embd.weight", np.zeros((10, 8), np.float32))
    w.write()
    with pytest.raises(SystemExit) as e:
        main(["-m", str(p), "-p", "1 2", "--device", "cpu"])
    assert e.value.code == 2 and "runtime/seq2seq.py" in capsys.readouterr().err


def test_the_cli_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        main(["-m", files["dense"], "-p", "1 2", "-n", "2"])


def test_hbm_budget_conversion():
    from sparkinfer_tpu_torch.sparse.config import hbm_budget_to_hot_groups

    class Cfg:
        n_embd = 4096
        n_layer = 32

    per_group = 3 * 128 * 4096 * 2
    assert hbm_budget_to_hot_groups(8.0, Cfg, 128) == int(8 * (1 << 30) / per_group) // 32


def _load(path):
    from sparkinfer_tpu_torch.models.loader import load_model

    return load_model(path, dtype=torch.float32, device="cpu")


def test_group_size_fallback_non_divisible(files):
    args = build_parser().parse_args(["-m", files["ids"], "--temp", "0", "-c", "32",
                                      "-ctk", "f32", "--device", "cpu"])
    model = _load(files["ids"])
    eng = make_engine(args, model)  # 128 does not divide n_ff = 96: 32
    assert eng.params.get("sparse_flat") is not None
    assert model.config.n_ff % 32 == 0 and len(eng.generate([3, 5, 7], 3)) == 3


def test_sparse_engine_with_split_and_fetch(files, tmp_path):
    """The -spif-ms flow (profile -> split file -> CLI-built tiered engine)
    and --cold-mode fetch."""
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.split import build_split, profile_firing, write_split

    scfg = SparseConfig(group_size=16, capacity_groups=4)
    firing = profile_firing(_load(files["ids"]), [np.arange(8) % 199], scfg)
    split_path = tmp_path / "split.gguf"
    write_split(str(split_path), build_split(firing, scfg), arch="prosparse_llama")
    for mode in ("host", "fetch"):
        args = build_parser().parse_args([
            "-m", files["ids"], "--spif-ms", str(split_path), "--hot-groups", "2",
            "--group-size", "16", "--capacity-groups", "4", "--temp", "0", "-c", "32",
            "-ctk", "f32", "--cold-mode", mode, "--device", "cpu"])
        eng = make_engine(args, _load(files["ids"]))
        assert eng.tiered and len(eng.generate([3, 5, 7], 4)) == 4
        assert (eng.fstate.miss_g is not None) == (mode == "fetch")
