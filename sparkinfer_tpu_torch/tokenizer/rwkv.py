"""RWKV world tokenizer — greedy longest-match over a byte trie.

Parity target: llm_tokenizer_rwkv (src/llama-vocab.cpp): token strings are
raw byte sequences (stored escaped in the GGUF); encoding is greedy
longest-prefix match over UTF-8 bytes.
"""

from __future__ import annotations

from .vocab import Vocab


class RWKVTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.trie: dict = {}
        for tid, tok in enumerate(vocab.tokens):
            node = self.trie
            for b in tok.encode("utf-8", errors="surrogateescape"):
                node = node.setdefault(b, {})
            node[None] = tid

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        data = text.encode("utf-8", errors="surrogateescape")
        out: list[int] = []
        i = 0
        n = len(data)
        while i < n:
            node = self.trie
            last = None
            last_j = i
            j = i
            while j < n and data[j] in node:
                node = node[data[j]]
                j += 1
                if None in node:
                    last = node[None]
                    last_j = j
            if last is None:
                i += 1  # unencodable byte: skip (reference aborts; be lenient)
            else:
                out.append(last)
                i = last_j
        return out

    def decode_bytes(self, ids: list[int], skip_special: bool = False) -> bytes:
        return b"".join(
            self.vocab.tokens[t].encode("utf-8", errors="surrogateescape")
            for t in ids
        )

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        return self.decode_bytes(ids, skip_special).decode("utf-8", errors="replace")
