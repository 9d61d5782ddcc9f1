"""SentencePiece-style (SPM) tokenizer: score-driven bigram merging.

Behavioral parity with llm_tokenizer_spm (ref: src/llama-vocab.cpp):
UTF-8 symbols are repeatedly merged by taking the adjacent pair whose
concatenation is the highest-scoring vocab entry; leftover symbols fall
back to byte tokens `<0xXX>` or UNK.
"""

from __future__ import annotations

import heapq

from .vocab import Vocab, split_on_specials

SPIECE_UNDERLINE = "▁"


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._byte_ids = {}
        for b in range(256):
            tid = vocab.token_to_id.get(f"<0x{b:02X}>")
            if tid is not None:
                self._byte_ids[b] = tid

    # --- core bigram-merge over one fragment ---

    def _tokenize_fragment(self, text: str) -> list[int]:
        if not text:
            return []
        v = self.vocab
        # symbols: initially one per unicode codepoint
        syms: list[str] = list(text)
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n

        def pair_score(i: int) -> tuple[float, int] | None:
            j = nxt[i]
            if j >= n:
                return None
            merged = syms[i] + syms[j]
            tid = v.token_to_id.get(merged)
            if tid is None or v.scores is None:
                return None
            return (float(v.scores[tid]), tid)

        # heap of (-score, left_index, snapshot_len_left, snapshot_len_right)
        heap: list[tuple[float, int, int, int]] = []

        def push(i: int):
            ps = pair_score(i)
            if ps is not None:
                heapq.heappush(heap, (-ps[0], i, len(syms[i]), len(syms[nxt[i]])))

        for i in range(n - 1):
            push(i)

        while heap:
            negs, i, llen, rlen = heapq.heappop(heap)
            j = nxt[i] if i < n else n
            if not alive[i] or j >= n or not alive[j]:
                continue
            if len(syms[i]) != llen or len(syms[j]) != rlen:
                continue  # stale entry
            syms[i] = syms[i] + syms[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prev[nxt[i]] = i
            push(i)
            if prev[i] >= 0:
                push(prev[i])

        out: list[int] = []
        i = 0
        while i < n:
            if alive[i]:
                s = syms[i]
                tid = v.token_to_id.get(s)
                if tid is not None:
                    out.append(tid)
                else:
                    # byte fallback per UTF-8 byte
                    for b in s.encode("utf-8"):
                        out.append(self._byte_ids.get(b, v.unk_id))
            i += 1
        return out

    # --- public API ---

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        first_raw = True
        for frag, sid in split_on_specials(text, v):
            if sid is not None:
                out.append(sid)
                first_raw = True  # space prefix re-applies after specials? no — llama.cpp applies per raw fragment
                continue
            raw = frag
            if raw and v.add_space_prefix and first_raw:
                raw = " " + raw
            first_raw = False
            raw = raw.replace(" ", SPIECE_UNDERLINE)
            out.extend(self._tokenize_fragment(raw))
        return out

    def decode_bytes(self, ids: list[int], skip_special: bool = False) -> bytes:
        """Raw token bytes (streaming-safe; <0xXX> byte tokens may split
        UTF-8 sequences across tokens)."""
        v = self.vocab
        parts: list[bytes] = []
        for t in ids:
            if t < 0 or t >= v.n_tokens:
                continue
            if skip_special and t in (v.bos_id, v.eos_id):
                continue
            s = v.tokens[t]
            if s.startswith("<0x") and s.endswith(">") and len(s) == 6:
                try:
                    parts.append(bytes([int(s[3:5], 16)]))
                    continue
                except ValueError:
                    pass
            parts.append(s.replace(SPIECE_UNDERLINE, " ").encode("utf-8"))
        return b"".join(parts)

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        v = self.vocab
        text = self.decode_bytes(ids, skip_special).decode("utf-8", errors="replace")
        return text.removeprefix(" ") if v.add_space_prefix else text
