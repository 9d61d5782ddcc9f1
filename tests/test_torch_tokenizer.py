"""The port's tokenizers (sparkinfer_tpu_torch/tokenizer/, copies of the
JAX package's) against the JAX package's, id for id, on the fixture
vocabularies the JAX tests build: the SPM vocabulary of a tiny GGUF
(model_fixtures.make_tiny_llama(with_vocab=True), read through each
package's GGUF reader and Vocab.from_gguf), and in-memory BPE (byte-level,
with merges), WordPiece, UGM and RWKV vocabularies; encode with and without
specials, and decode of the ids, over the strings of tests/test_tokenizer.py.
Exact: ids and text equal."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.gguf.reader import GGUFReader as JaxReader  # noqa: E402
from sparkinfer_tpu.tokenizer import Vocab as JaxVocab  # noqa: E402
from sparkinfer_tpu.tokenizer import build_tokenizer as jax_build  # noqa: E402
from sparkinfer_tpu.tokenizer.bpe import BYTE_ENCODER  # noqa: E402
from sparkinfer_tpu_torch.gguf.reader import GGUFReader  # noqa: E402
from sparkinfer_tpu_torch.tokenizer import Vocab, build_tokenizer  # noqa: E402

TEXTS = [
    "Hello world", " Hello World!", "don't do  that", "  leading", "trail  ",
    "numbers 12345 and 3.14", "mixed 中文 text", "emoji 🙂 test",
    "CamelCaseWords and_snake_case", "\n\nnewlines\n", "tab\tsep",
    "'''", "~!@#$%^&*()_+", "very long " * 20, "    four spaces", "",
    "hello the world</s>hello", "ab xy",
]

NORMAL, UNKNOWN, CONTROL = 1, 2, 3


def _bpe(cls):
    """A byte-level BPE vocabulary: the 256 byte characters, the merges of
    a few words (each merge left to right), an <|endoftext|> control."""
    tokens = [BYTE_ENCODER[b] for b in range(256)]
    merges = []
    for word in ("hello", "world", "the", "that", "ing", "Ġhello", "Ġworld", "Ġthe",
                 "Ġthat", "Ġdo", "Ġtest", "12", "345"):
        cur = word[0] if not word.startswith("Ġ") else "Ġ"
        rest = word[1:]
        for ch in rest:
            merges.append(f"{cur} {ch}")
            cur += ch
            if cur not in tokens:
                tokens.append(cur)
    tokens.append("<|endoftext|>")
    types = np.full(len(tokens), NORMAL, np.int32)
    types[-1] = CONTROL
    eos = len(tokens) - 1
    return cls(model="gpt2", pre="default", tokens=tokens, token_types=types, scores=None,
               merges=merges, bos_id=eos, eos_id=eos, unk_id=-1, add_bos=False,
               add_space_prefix=False)


def _wpm(cls):
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "the",
              "##s", "##ing", "do", "##n", "'", "t", "that", "!", ".", "1", "##2", "3",
              "中", "文", "test", "mixed", "text", "camel", "##case", "##words"]
    types = np.full(len(tokens), NORMAL, np.int32)
    types[[0, 2, 3, 4]] = CONTROL
    types[1] = UNKNOWN
    return cls(model="bert", pre="default", tokens=tokens, token_types=types, scores=None,
               merges=None, bos_id=2, eos_id=3, unk_id=1, sep_id=3, add_bos=True,
               add_eos=True, add_space_prefix=False)


def _ugm(cls):
    tokens = ["<unk>", "▁", "a", "b", "ab", "▁ab", "▁a", "▁hello", "▁world", "h", "e", "l",
              "o", "w", "r", "d", "▁the", "t", "s", "n", "▁t", "▁x"]
    scores = -np.linspace(1.0, 4.0, len(tokens)).astype(np.float32)
    scores[0] = 0.0
    return cls(model="t5", pre="default", tokens=tokens,
               token_types=np.full(len(tokens), NORMAL, np.int32), scores=scores,
               merges=None, bos_id=-1, eos_id=-1, unk_id=0, add_bos=False, add_eos=False,
               add_space_prefix=True)


def _rwkv(cls):
    tokens = ["h", "e", "l", "o", "he", "hel", "hello", " ", " wor", "ld", "w", "r", "d",
              "t", "th", "the", " the", "a", "b", "x", "y", "\n", "1", "2", "3"]
    return cls(model="rwkv", pre="default", tokens=tokens,
               token_types=np.full(len(tokens), NORMAL, np.int32), scores=None,
               merges=None, bos_id=-1, eos_id=-1, unk_id=-1, add_bos=False, add_eos=False,
               add_space_prefix=False)


@pytest.fixture(scope="module")
def spm_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-spm.gguf"
    make_tiny_llama(path, n_vocab=300, with_vocab=True)
    return str(path)


@pytest.fixture(scope="module")
def pairs(spm_gguf):
    """family -> (JAX tokenizer, port tokenizer)"""
    out = {"spm": (jax_build(JaxVocab.from_gguf(JaxReader(spm_gguf))),
                   build_tokenizer(Vocab.from_gguf(GGUFReader(spm_gguf))))}
    for name, make in (("bpe", _bpe), ("wpm", _wpm), ("ugm", _ugm), ("rwkv", _rwkv)):
        out[name] = (jax_build(make(JaxVocab)), build_tokenizer(make(Vocab)))
    return out


def test_spm_vocab_reads_as_the_jax_one(spm_gguf):
    a = JaxVocab.from_gguf(JaxReader(spm_gguf))
    b = Vocab.from_gguf(GGUFReader(spm_gguf))
    assert a.tokens == b.tokens and np.array_equal(a.token_types, b.token_types)
    assert np.array_equal(a.scores, b.scores)
    for key in ("model", "pre", "bos_id", "eos_id", "unk_id", "add_bos", "add_eos",
                "add_space_prefix", "chat_template", "fim_pre_id", "fim_mid_id"):
        assert getattr(a, key) == getattr(b, key), key


@pytest.mark.parametrize("family", ["spm", "bpe", "wpm", "ugm", "rwkv"])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_encode_decode_match_jax(pairs, family, text):
    ref, got = pairs[family]
    for special in (False, True):
        want = ref.encode(text, add_special=special)
        assert got.encode(text, add_special=special) == want
        assert got.decode(want) == ref.decode(want)
    if hasattr(ref, "decode_bytes"):
        assert got.decode_bytes(want) == ref.decode_bytes(want)


def test_bpe_without_regex_names_the_package(monkeypatch):
    """SPM and the package import without `regex`; a BPE vocabulary asks
    for it by name, with no fallback to `re`."""
    import sys

    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError, match="regex"):
        build_tokenizer(_bpe(Vocab))
    assert build_tokenizer(_ugm(Vocab)).encode("ab", add_special=False)
