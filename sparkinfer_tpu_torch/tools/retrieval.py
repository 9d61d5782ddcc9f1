"""Retrieval example, the port of sparkinfer_tpu/tools/retrieval.py (an
analogue of examples/retrieval, retrieval.cpp): chunk context files on a
separator into >= chunk-size pieces, embed every chunk through the pooling
Embedder (one forward a chunk, on the card unless --device says otherwise),
then answer interactive or one-shot queries with cosine top-k.

    python -m sparkinfer_tpu_torch.tools.retrieval -m model.gguf \
        --context-file notes.txt -q "question" [--top-k 3] [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def chunk_text(text: str, chunk_size: int, separator: str) -> list[str]:
    """Greedy accumulation: split on `separator` (kept), emit once the
    accumulated piece exceeds chunk_size (ref chunk_file semantics)."""
    chunks: list[str] = []
    current = ""
    parts = text.split(separator)
    for i, part in enumerate(parts):
        piece = part + (separator if i < len(parts) - 1 else "")
        current += piece
        if len(current) > chunk_size:
            chunks.append(current.strip())
            current = ""
    if current.strip():
        chunks.append(current.strip())
    return [c for c in chunks if c]


class Retriever:
    def __init__(self, model, pooling: str = "mean", max_seq: int = 512, device=None):
        from ..runtime.embeddings import Embedder
        from ..tokenizer import build_tokenizer

        self.tk = build_tokenizer(model.vocab)
        self.emb = Embedder(model, max_seq=max_seq, pooling=pooling, device=device)
        self.chunks: list[str] = []
        self.vecs: np.ndarray | None = None

    def add(self, texts: list[str]):
        ids = [self.tk.encode(t, add_special=True) for t in texts]
        vecs = self.emb.embed_tokens(ids, normalize=True)
        self.chunks.extend(texts)
        self.vecs = vecs if self.vecs is None else np.vstack([self.vecs, vecs])

    def query(self, text: str, top_k: int = 3) -> list[tuple[float, str]]:
        q = self.emb.embed_tokens(
            [self.tk.encode(text, add_special=True)], normalize=True)[0]
        sims = self.vecs @ q  # cosine (both normalized)
        order = np.argsort(-sims)[:top_k]
        return [(float(sims[i]), self.chunks[i]) for i in order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparkinfer_tpu_torch.tools.retrieval")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--context-file", action="append", required=True)
    ap.add_argument("--chunk-size", type=int, default=100)
    ap.add_argument("--chunk-separator", default=".")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--pooling", choices=["mean", "last", "cls"], default="mean")
    ap.add_argument("-q", "--query", default=None,
                    help="one-shot query (default: interactive stdin loop)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu to run on the CPU)")
    args = ap.parse_args(argv)

    from ..models.loader import load_model

    model = load_model(args.model, device=args.device)
    r = Retriever(model, pooling=args.pooling, device=args.device)
    for f in args.context_file:
        r.add(chunk_text(open(f).read(), args.chunk_size, args.chunk_separator))
    print(f"indexed {len(r.chunks)} chunks from {len(args.context_file)} file(s)",
          file=sys.stderr)

    def answer(q: str):
        hits = r.query(q, args.top_k)
        if args.json:
            print(json.dumps([{"score": s, "text": t} for s, t in hits]))
        else:
            for s, t in hits:
                print(f"[{s:.4f}] {t}")

    if args.query is not None:
        answer(args.query)
        return 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        answer(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
