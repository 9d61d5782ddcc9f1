"""OpenAI-compatible HTTP serving, the port of sparkinfer_tpu/server/app.py
(the analogue of llama-server: tools/server/server.cpp routes :154-187,
server-http over cpp-httplib) onto the port's Scheduler.

Stdlib ThreadingHTTPServer front-end over the continuous-batching
Scheduler (runtime/scheduler.py): HTTP threads build Requests and block on
(or stream from) their token queues while the single inference thread
drains slots — the same two-plane design as the reference's queue_tasks /
inference-thread split (server-queue.h:30,60).

Endpoints (reference parity set):
  GET  / /health /props /metrics /v1/models /slots
  POST /tokenize /detokenize /completion(s) /v1/completions
       /v1/chat/completions /infill /v1/messages /apply-template
       /embeddings /v1/embeddings /rerank /reranking /v1/rerank /v1/reranking
Streaming via SSE (`stream: true`). The server runs on the card unless
`ServerConfig.device` says otherwise. /embeddings and /rerank run the
model's forward (runtime/embeddings.py) on the handler's thread between
the Scheduler's ticks. A non-causal encoder (bert, neo-bert,
gemma-embedding) is served by those two routes alone: its Scheduler is
built but idle, and a completion, chat or infill request is answered 400
with the error that names the arch (`Scheduler.submit`).
LoRA adapters (`ServerConfig.lora`) are merged at startup and re-merged at
new scales by POST /lora-adapters, in place (`models/lora.LoraMerger`: the
dense weights and the Scheduler's row stores, which its tick graphs read),
between ticks (the Scheduler's lock); /slots/:id?action=save|restore writes
and reads the slot's state file under `slot_save_path`. Quantized or
split-dtype KV caches raise at startup; tiered
sparse serving (`sparse.hot_groups > 0`, `sparse_cold_mode`,
`prefill_mode`, `split`, `rebalance_every`) goes to the Scheduler. The router's lazy model load holds the graphs'
CAPTURE_LOCK: it runs on a handler thread while a Scheduler may capture.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..device import resolve_device
from ..runtime.graphs import CAPTURE_LOCK
from ..runtime.sampling import SamplerConfig
from ..runtime.scheduler import Request, Scheduler
from ..tokenizer import build_tokenizer
from .chat import ChatTemplate, apply_template


def _template_for(vocab, family_override: str | None = None) -> ChatTemplate:
    """ChatTemplate from a model's Vocab: executes the GGUF Jinja template,
    with bos/eos token text resolved from the vocab table."""
    def tok_text(tid):
        return vocab.tokens[tid] if 0 <= tid < len(vocab.tokens) else ""

    return ChatTemplate(
        vocab.chat_template, family=family_override,
        bos_token=tok_text(vocab.bos_id), eos_token=tok_text(vocab.eos_id),
    )


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    n_slots: int = 4
    max_seq: int = 2048
    model_name: str = "sparkinfer-tpu"
    kv_dtype: str = "bf16"  # "bf16" | "f32" | "int8"
    kv_dtype_v: str | None = None  # -ctv: separate V dtype (None = kv_dtype)
    chat_template: str | None = None  # override; default = detect from GGUF
    timeout: float = 600.0  # -to: per-connection read/write timeout (s)
    n_predict_default: int = 128  # -n: max_tokens when the request omits it
    # -sps: idle-slot routing by prompt-prefix similarity (0 = first-free)
    slot_prompt_similarity: float = 0.1
    slot_save_path: str | None = None  # dir for /slots/:id?action=save files
    # LoRA adapters applied at startup; runtime-rescalable via
    # GET/POST /lora-adapters (ref tools/server/server.cpp:180-181)
    lora: list | None = None  # [path | (path, scale), ...]
    # multi-model router (ref server-models.cpp): name -> GGUF path,
    # selected per request by the OpenAI "model" field, loaded lazily
    extra_models: dict | None = None
    # bearer-token auth on API routes, /health stays open (ref:
    # tools/server middleware_validate_api_key)
    api_key: str | None = None
    # SparkInfer sparse serving (predictor-gated; tiered when hot_groups>0)
    sparse: object | None = None  # SparseConfig
    sparse_cold_mode: str = "host"  # --cold-mode: host | drop | fetch
    prefill_mode: str = "rows"  # --prefill-mode: rows | tiered
    split: object | None = None  # ModelSplit | path (offline profile)
    rebalance_every: int = 1
    device: str | None = None  # torch device; None: the CUDA card


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class SparkServer:
    def __init__(self, model, cfg: ServerConfig | None = None,
                 sampler: SamplerConfig | None = None):
        self.cfg = cfg or ServerConfig()
        self.model = model
        if model.vocab is None:
            raise ValueError("server needs a model with tokenizer vocab")
        self.device = resolve_device(self.cfg.device)
        self.tokenizer = build_tokenizer(model.vocab)
        kv_dtype = _DTYPES.get(self.cfg.kv_dtype, torch.bfloat16)
        kv_dtype_v = (_DTYPES.get(self.cfg.kv_dtype_v, torch.bfloat16)
                      if self.cfg.kv_dtype_v else None)
        self.sched = Scheduler(
            model,
            n_slots=self.cfg.n_slots,
            max_seq=self.cfg.max_seq,
            sampler=sampler or SamplerConfig(),
            kv_dtype=kv_dtype,
            kv_dtype_v=kv_dtype_v,
            kv_quantized=self.cfg.kv_dtype == "int8",
            slot_similarity=self.cfg.slot_prompt_similarity,
            tokenizer=self.tokenizer,
            sparse=self.cfg.sparse,
            sparse_cold_mode=self.cfg.sparse_cold_mode,
            prefill_mode=self.cfg.prefill_mode,
            split=self.cfg.split,
            rebalance_every=self.cfg.rebalance_every,
            device=self.device,
        )
        self.template = _template_for(model.vocab, self.cfg.chat_template)
        self._httpd: ThreadingHTTPServer | None = None
        self._t0 = time.time()
        self._lora: list[dict] = []
        self._merger = None
        if self.cfg.lora:
            from ..models.lora import LoraMerger

            if self.sched.tiered:
                raise ValueError("LoRA needs dense weights or row stores: the tiered "
                                 "Scheduler's hot store cannot be re-merged")
            for i, item in enumerate(self.cfg.lora):
                path, scale = (item if isinstance(item, (tuple, list)) else (item, 1.0))
                self._lora.append({"id": i, "path": str(path), "scale": float(scale)})
            self._merger = LoraMerger([model.params, self.sched.params], model.config,
                                      [a["path"] for a in self._lora])
            self._remerge_lora()
        self._backends: dict[str, object] = {}
        self._backends_lock = threading.Lock()
        self._embedders: dict[str, object] = {}  # runtime.embeddings.Embedder, by pooling

    # --- lora ---------------------------------------------------------------
    def lora_list(self) -> list[dict]:
        return [dict(a) for a in self._lora]

    def lora_set(self, items: list[dict]) -> list[dict]:
        for it in items:
            i = int(it["id"])
            if not 0 <= i < len(self._lora):
                raise ValueError(f"no LoRA adapter {i}")
            self._lora[i]["scale"] = float(it["scale"])
        self._remerge_lora()
        return self.lora_list()

    def _remerge_lora(self):
        """The adapters at their scales, written in place between ticks: the
        next tick's graph reads them."""
        if self._merger is None:
            return
        with self.sched.lock:
            self._merger.merge([a["scale"] for a in self._lora])

    # --- multi-model router -------------------------------------------------
    def _backend_for(self, body: dict):
        """Returns (sched, tokenizer, template, name) for the request's
        "model" field; lazily loads extra models (server-models.cpp)."""
        name = body.get("model")
        extras = self.cfg.extra_models or {}
        if not name or name == self.cfg.model_name or name not in extras:
            return (self.sched, self.tokenizer, self.template,
                    self.cfg.model_name)
        with self._backends_lock:
            be = self._backends.get(name)
            if be is None:
                from ..models.loader import load_model

                # this handler thread touches the card while a Scheduler's
                # thread may capture a tick's graph
                with CAPTURE_LOCK:
                    m = load_model(extras[name], dtype=torch.bfloat16,
                                   device=self.device)
                    tok = build_tokenizer(m.vocab)
                    sched = Scheduler(
                        m, n_slots=self.cfg.n_slots, max_seq=self.cfg.max_seq,
                        sampler=SamplerConfig(), tokenizer=tok,
                        device=self.device,
                    )
                sched.start()
                tmpl = _template_for(m.vocab)
                be = (sched, tok, tmpl, name)
                self._backends[name] = be
        return be

    # --- request handling ---------------------------------------------------
    def _sampler_from(self, body: dict) -> SamplerConfig:
        base = self.sched.sampler_cfg
        return SamplerConfig(
            temp=float(body.get("temperature", base.temp)),
            top_k=int(body.get("top_k", base.top_k)),
            top_p=float(body.get("top_p", base.top_p)),
            min_p=float(body.get("min_p", base.min_p)),
            penalty_repeat=float(body.get("repeat_penalty", base.penalty_repeat)),
            penalty_freq=float(body.get("frequency_penalty", base.penalty_freq)),
            penalty_present=float(body.get("presence_penalty", base.penalty_present)),
            seed=int(body.get("seed", base.seed)),
        )

    def _stop_ids(self) -> set[int]:
        v = self.model.vocab
        ids = {v.eos_id} if v.eos_id is not None and v.eos_id >= 0 else set()
        for i in range(v.n_tokens):
            if v.is_eog(i):
                ids.add(i)
        return ids

    def _make_request(self, prompt: str | list[int], body: dict,
                      tokenizer=None, sched=None) -> Request:
        tokenizer = tokenizer or self.tokenizer
        sched = sched or self.sched
        if isinstance(prompt, str):
            ids = tokenizer.encode(prompt, add_special=True)
        else:
            ids = [int(t) for t in prompt]
        max_new = int(body.get("max_tokens", body.get(
            "n_predict", self.cfg.n_predict_default)))
        grammar = body.get("grammar")
        rf = body.get("response_format") or {}
        if grammar is None and rf.get("type") == "json_schema":
            from ..grammar import json_schema_to_gbnf

            schema = rf.get("json_schema", {})
            grammar = json_schema_to_gbnf(schema.get("schema", schema))
        elif grammar is None and rf.get("type") == "json_object":
            from ..grammar import json_schema_to_gbnf

            grammar = json_schema_to_gbnf({})
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return Request(
            prompt_tokens=ids,
            max_new_tokens=max_new,
            sampler=self._sampler_from(body),
            seed=body.get("seed"),
            stop_ids=self._stop_ids(),
            stop_strings=[s for s in stop if s],
            grammar=grammar,
        )

    def completion(self, body: dict):
        """Returns (request, detok) — caller decides stream vs collect."""
        sched, tok, _, name = self._backend_for(body)
        prompt = body.get("prompt", "")
        req = self._make_request(prompt, body, tokenizer=tok, sched=sched)
        req._detok = tok.decode
        req._model_name = name
        sched.submit(req)
        return req

    def infill_prompt(self, body: dict) -> list[int]:
        """Build the FIM token prompt for /infill (ref format_prompt_infill,
        tools/server/server-common.cpp:1544: repo-level FIM pattern
        [FIM_REP]repo [FIM_SEP]file chunks ... [FIM_PRE]prefix[FIM_SUF]
        suffix[FIM_MID], with prefix:suffix take ratio 3:1)."""
        v = self.model.vocab
        if v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
            raise ValueError("model vocab has no FIM tokens (infill unsupported)")
        enc = lambda s: self.tokenizer.encode(s, add_special=False)
        prefix = enc(body.get("input_prefix", "") or "")
        suffix = enc(body.get("input_suffix", "") or "")
        prompt = body.get("prompt", "") or ""
        tokens_prompt = enc(prompt) if isinstance(prompt, str) else [int(t) for t in prompt]
        n_predict = int(body.get("n_predict", body.get("max_tokens", 128)))

        extra: list[int] = []
        if v.fim_rep_id >= 0:
            extra += [v.fim_rep_id] + enc("myproject\n")
        for chunk in body.get("input_extra") or []:
            text = str(chunk.get("text", ""))
            filename = str(chunk.get("filename", "tmp"))
            if v.fim_sep_id >= 0:
                extra += [v.fim_sep_id] + enc(filename + "\n")
            else:
                extra += enc("\n\n--- snippet ---\n\n")
            extra += enc(text)
        if v.fim_sep_id >= 0:
            extra += [v.fim_sep_id] + enc("filename\n")

        n_batch = self.cfg.max_seq // 2
        n_ctx = self.cfg.max_seq
        n_prefix_take = min(len(prefix), 3 * (n_batch // 4))
        n_suffix_take = min(len(suffix),
                            max(0, (n_batch // 4) - (2 + len(tokens_prompt))))
        n_extra_take = min(max(0, n_ctx - n_batch - 2 * n_predict), len(extra))

        pre = [v.fim_pre_id] + (prefix[len(prefix) - n_prefix_take:]) + tokens_prompt
        suf = [v.fim_suf_id] + suffix[:n_suffix_take]
        spm = bool(body.get("spm_infill", False))
        first, second = (suf, pre) if spm else (pre, suf)
        ids = list(first)
        if v.add_bos and v.bos_id >= 0:
            ids.insert(0, v.bos_id)
        ids = extra[len(extra) - n_extra_take:] + ids + second + [v.fim_mid_id]
        return ids

    def infill(self, body: dict):
        ids = self.infill_prompt(body)
        req = self._make_request(ids, body)
        self.sched.submit(req)
        return req

    def _pooled(self, pooling: str, token_lists: list[list[int]], **kw):
        """Embedder(pooling).embed_tokens over the server's model. A handler
        thread runs these forwards, so they hold the Scheduler's lock (no
        tick runs meanwhile) and then CAPTURE_LOCK (no graph is captured
        meanwhile), in the order the Scheduler's own thread takes them."""
        from ..runtime.embeddings import Embedder

        with self.sched.lock, CAPTURE_LOCK:
            emb = self._embedders.get(pooling)
            if emb is None:
                emb = self._embedders[pooling] = Embedder(
                    self.model, max_seq=self.cfg.max_seq, pooling=pooling, device=self.device)
            return emb.embed_tokens(token_lists, **kw)

    def embeddings(self, body: dict) -> dict:
        """OpenAI-compatible /v1/embeddings: mean-pooled, normalized vectors
        of each input, tokenized with the model's special tokens."""
        inputs = body.get("input", body.get("content", ""))
        if isinstance(inputs, str):
            inputs = [inputs]
        toks = [self.tokenizer.encode(t, add_special=True) for t in inputs]
        vecs = self._pooled("mean", toks)
        return {
            "object": "list",
            "model": self.cfg.model_name,
            "data": [{"object": "embedding", "index": i, "embedding": v.tolist()}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": sum(len(t) for t in toks),
                      "total_tokens": sum(len(t) for t in toks)},
        }

    def rerank(self, body: dict) -> dict:
        """Jina/TEI-compatible rerank (ref tools/server post_rerank +
        format_prompt_rerank): score = rank-pooled classification head on
        [bos]query[eos][sep]doc[eos]."""
        query = body.get("query")
        is_tei = "texts" in body and "documents" not in body
        docs = body.get("documents", body.get("texts")) or []
        if query is None or not isinstance(docs, list):
            raise ValueError("rerank needs 'query' and 'documents'/'texts'")
        v = self.model.vocab
        eos = v.eos_id if v.eos_id >= 0 else v.sep_id
        q_toks = self.tokenizer.encode(str(query), add_special=False)
        pairs = []
        for d in docs:
            ids: list[int] = []
            if v.add_bos and v.bos_id >= 0:
                ids.append(v.bos_id)
            ids += q_toks
            if v.add_eos and eos >= 0:
                ids.append(eos)
            if v.add_sep and v.sep_id >= 0:
                ids.append(v.sep_id)
            ids += self.tokenizer.encode(str(d), add_special=False)
            if v.add_eos and eos >= 0:
                ids.append(eos)
            pairs.append(ids)
        scores = [float(s[0]) for s in self._pooled("rank", pairs, normalize=False)]
        label = "score" if is_tei else "relevance_score"
        results = [{"index": i, label: s} for i, s in enumerate(scores)]
        results.sort(key=lambda r: -r[label])
        top_n = body.get("top_n")
        if top_n is not None:
            results = results[: int(top_n)]
        return {
            "model": self.cfg.model_name,
            "results": results,
            "usage": {"prompt_tokens": sum(len(p) for p in pairs),
                      "total_tokens": sum(len(p) for p in pairs)},
        }

    def chat_completion(self, body: dict):
        sched, tok, template, name = self._backend_for(body)
        msgs = body.get("messages", [])
        tools = body.get("tools")
        if tools:
            from .chat_parser import detect_format
            from .tools_api import inject_tools, tool_call_grammar

            jinja_handles_tools = (
                isinstance(template, ChatTemplate) and template.is_jinja
                and "tools" in (template.source or ""))
            if jinja_handles_tools:
                fmt = detect_format(template.source, template.name)
            else:
                # family fast-paths AND jinja templates that never read
                # `tools` get the generic system-prompt injection (the
                # reference falls back the same way when the template
                # lacks tool support, common/chat.cpp generic handler) —
                # the injected instructions teach the hermes envelope, so
                # parse/force THAT format regardless of template family
                msgs = inject_tools(msgs, tools)
                fmt = "hermes"
            if body.get("tool_choice") == "required" and not body.get("grammar"):
                body = dict(body)
                # the grammar must force the SAME format the parser reads
                body["grammar"] = tool_call_grammar(tools, fmt)
        if isinstance(template, ChatTemplate):
            prompt = template.render(msgs, tools=tools)
        else:
            prompt = apply_template(msgs, template)
        req = self._make_request(prompt, body, tokenizer=tok, sched=sched)
        req._has_tools = bool(tools)
        # thinking_forced_open: the template already opened the reasoning
        # block (ref common_chat_templates_apply_jinja detection)
        req._thinking_open = prompt.rstrip().endswith("<think>")
        if tools:
            req._chat_format = fmt
        req._detok = tok.decode
        req._model_name = name
        sched.submit(req)
        return req

    def detok(self, toks: list[int]) -> str:
        return self.tokenizer.decode(toks)

    def utf8_stream(self) -> "_Utf8Stream":
        return _Utf8Stream(self.tokenizer)

    # --- metrics ------------------------------------------------------------
    def prometheus(self) -> str:
        m = self.sched.metrics_snapshot()
        lines = []
        for k, v in m.items():
            lines.append(f"# TYPE sparkinfer_{k} gauge")
            lines.append(f"sparkinfer_{k} {v}")
        lines.append("# TYPE sparkinfer_uptime_seconds gauge")
        lines.append(f"sparkinfer_uptime_seconds {time.time() - self._t0:.1f}")
        return "\n".join(lines) + "\n"

    def props(self) -> dict:
        cfg = self.model.config
        return {
            "model_name": self.cfg.model_name,
            "arch": cfg.arch,
            "n_ctx": self.cfg.max_seq,
            "n_slots": self.cfg.n_slots,
            "n_vocab": cfg.n_vocab,
            "n_layer": cfg.n_layer,
            "n_embd": cfg.n_embd,
            "chat_template": self.template.name,
            "chat_template_source": self.template.source or "",
            "has_predictors": cfg.has_predictors,
        }

    # --- http ---------------------------------------------------------------
    def bind(self):
        """Open the listening socket (port 0: a free one, then `port`)."""
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer((self.cfg.host, self.cfg.port),
                                              _make_handler(self))

    def serve(self, block: bool = True):
        self.sched.start()
        self.bind()
        if block:
            try:
                self._httpd.serve_forever()
            finally:
                self.shutdown()
        else:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self.cfg.port

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.sched.stop()
        with self._backends_lock:
            for sched, *_ in self._backends.values():
                sched.stop()
            self._backends.clear()


class _Utf8Stream:
    """Incremental token→text decoder that never splits a UTF-8 sequence
    across SSE chunks: trailing incomplete bytes are held back until the
    next token completes them (ref: llama-server buffers incomplete UTF-8;
    round-1 behavior streamed U+FFFD for CJK/emoji split across tokens)."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.buf = b""

    @staticmethod
    def _incomplete_tail(b: bytes) -> int:
        """Bytes at the end of `b` that start (but do not finish) a UTF-8
        multi-byte sequence; 0 when the buffer ends on a boundary."""
        for k in range(1, min(4, len(b)) + 1):
            c = b[-k]
            if c < 0x80:
                return 0  # ASCII terminates any scan-back
            if c >= 0xC0:  # lead byte k bytes from the end
                need = 2 if c < 0xE0 else 3 if c < 0xF0 else 4
                return k if need > k else 0
            # else continuation byte: keep scanning back
        return 0

    def push(self, toks: list[int]) -> str:
        if hasattr(self.tok, "decode_bytes"):
            self.buf += self.tok.decode_bytes(toks)
        else:
            self.buf += self.tok.decode(toks).encode("utf-8")
        keep = self._incomplete_tail(self.buf)
        out, self.buf = (self.buf[: len(self.buf) - keep], self.buf[len(self.buf) - keep :])
        return out.decode("utf-8", errors="replace")

    def flush(self) -> str:
        out, self.buf = self.buf, b""
        return out.decode("utf-8", errors="replace")


def _make_handler(srv: SparkServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # -to: socket read timeout per connection (BaseHTTPRequestHandler
        # closes the connection when a read blocks longer; ref -to)
        timeout = srv.cfg.timeout

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                return {}

        def _authed(self) -> bool:
            """Bearer-token check (ref: server middleware_validate_api_key;
            /health and the web UI stay open like the reference's public
            paths)."""
            key = srv.cfg.api_key
            if not key or self.path in ("/health", "/", "/index.html"):
                return True
            got = self.headers.get("Authorization", "")
            if got == f"Bearer {key}":
                return True
            self._json(401, {"error": {"message": "invalid api key",
                                       "type": "authentication_error"}})
            return False

        def _not_ported(self, e: NotImplementedError):
            self._json(501, {"error": {"message": str(e),
                                       "type": "not_implemented_error"}})

        def do_GET(self):
            if not self._authed():
                return
            try:
                self._get()
            except NotImplementedError as e:
                self._not_ported(e)

        def _get(self):
            if self.path in ("/", "/index.html"):
                from .webui import INDEX_HTML

                data = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/props":
                self._json(200, srv.props())
            elif self.path == "/metrics":
                data = srv.prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/v1/models":
                names = [srv.cfg.model_name] + sorted(srv.cfg.extra_models or {})
                self._json(200, {
                    "object": "list",
                    "data": [{"id": n, "object": "model",
                              "owned_by": "sparkinfer-tpu"} for n in names],
                })
            elif self.path == "/lora-adapters":
                self._json(200, srv.lora_list())
            elif self.path == "/slots":
                slots = [
                    {"id": i, "running": s.running, "n_past": s.n_past,
                     "n_gen": s.n_gen}
                    for i, s in enumerate(srv.sched.slots)
                ]
                self._json(200, slots)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if not self._authed():
                return
            body = self._body()
            try:
                if self.path == "/tokenize":
                    ids = srv.tokenizer.encode(
                        body.get("content", ""), add_special=bool(body.get("add_special", False))
                    )
                    self._json(200, {"tokens": ids})
                elif self.path == "/detokenize":
                    self._json(200, {"content": srv.detok(body.get("tokens", []))})
                elif self.path in ("/completion", "/completions", "/v1/completions"):
                    self._completion(body, chat=False)
                elif self.path == "/v1/chat/completions":
                    self._completion(body, chat=True)
                elif self.path in ("/embeddings", "/v1/embeddings"):
                    self._json(200, srv.embeddings(body))
                elif self.path == "/infill":
                    self._infill(body)
                elif self.path in ("/rerank", "/reranking", "/v1/rerank",
                                   "/v1/reranking"):
                    self._json(200, srv.rerank(body))
                elif self.path == "/v1/messages":
                    self._anthropic_messages(body)
                elif self.path == "/apply-template":
                    # render the chat template without generating
                    # (ref server.cpp handle_apply_template)
                    prompt = apply_template(body.get("messages", []),
                                            srv.template)
                    self._json(200, {"prompt": prompt})
                elif self.path == "/lora-adapters":
                    items = body if isinstance(body, list) else [body]
                    self._json(200, srv.lora_set(items))
                elif self.path.startswith("/slots/"):
                    self._slot_action(body)
                else:
                    self._json(404, {"error": "not found"})
            except NotImplementedError as e:
                self._not_ported(e)
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except BrokenPipeError:
                pass

        def _slot_action(self, body: dict):
            """/slots/<id>?action=save|restore (ref: server slot save)."""
            import os
            import urllib.parse

            parsed = urllib.parse.urlparse(self.path)
            s_i = int(parsed.path.split("/")[2])
            action = urllib.parse.parse_qs(parsed.query).get("action", [""])[0]
            fname = body.get("filename")
            if not fname or "/" in fname or ".." in fname:
                self._json(400, {"error": "filename required (no paths)"})
                return
            path = os.path.join(srv.cfg.slot_save_path or ".", fname)
            sched = srv.sched
            if action not in ("save", "restore"):
                self._json(400, {"error": "action must be save|restore"})
                return
            try:
                with sched.lock:  # between ticks
                    if action == "save":
                        out = {"saved": True, "n_bytes": sched.save_slot(s_i, path)}
                    else:
                        out = {"restored": True, **sched.restore_slot(s_i, path)}
            except OSError as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, out)

        def _anthropic_messages(self, body: dict):
            """Anthropic-compatible messages endpoint (parity:
            tools/server test_compat_anthropic.py): system string + messages
            with string-or-block content, max_tokens required."""
            msgs = []
            sys_prompt = body.get("system")
            if isinstance(sys_prompt, list):
                sys_prompt = "".join(
                    blk.get("text", "") for blk in sys_prompt
                )
            if sys_prompt:
                msgs.append({"role": "system", "content": sys_prompt})
            for m in body.get("messages", []):
                content = m.get("content", "")
                if isinstance(content, list):
                    content = "".join(
                        blk.get("text", "") for blk in content
                        if blk.get("type") == "text"
                    )
                msgs.append({"role": m.get("role", "user"), "content": content})
            inner = {
                "messages": msgs,
                "max_tokens": int(body.get("max_tokens", 128)),
                "temperature": body.get("temperature", 1.0),
                "top_p": body.get("top_p", 0.95),
                "top_k": body.get("top_k", 40),
            }
            req = srv.chat_completion(inner)
            toks = req.tokens()
            text = srv.detok(toks)
            self._json(200, {
                "id": f"msg_{req.id}",
                "type": "message",
                "role": "assistant",
                "model": srv.cfg.model_name,
                "content": [{"type": "text", "text": text}],
                "stop_reason": "end_turn",
                "usage": {"input_tokens": req.n_prompt,
                          "output_tokens": len(toks)},
            })

        def _infill(self, body: dict):
            """llama.cpp-compatible /infill (ref tools/server/server.cpp:171):
            FIM prompt assembled server-side, plain completion response."""
            req = srv.infill(body)
            toks = req.tokens()
            text = srv.detok(toks)
            self._json(200, {
                "content": text,
                "tokens": toks,
                "stop": True,
                "model": srv.cfg.model_name,
                "tokens_predicted": len(toks),
                "tokens_evaluated": req.n_prompt,
            })

        def _completion(self, body: dict, chat: bool):
            req = srv.chat_completion(body) if chat else srv.completion(body)
            created = int(time.time())
            rid = f"cmpl-{req.id}"
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = f"data: {json.dumps(obj)}\n\n".encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

                dec = srv.utf8_stream()
                # tool-enabled chats stream through the incremental chat
                # parser: content/reasoning/tool-call deltas in OpenAI
                # shape (ref: server oaicompat streaming + chat-parser)
                sp = None
                if chat and getattr(req, "_has_tools", False):
                    from .chat_parser import StreamParser

                    sp = StreamParser(
                        getattr(req, "_chat_format", "hermes"),
                        thinking_open=getattr(req, "_thinking_open", False))

                def emit_chat_deltas(deltas, finish=None):
                    for d in deltas:
                        chunk({
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": srv.cfg.model_name,
                            "choices": [{"index": 0, "delta": d,
                                         "finish_reason": None}],
                        })

                for tok in req.stream():
                    text = dec.push([tok])
                    if not text:
                        continue  # held-back incomplete UTF-8 tail
                    if sp is not None:
                        emit_chat_deltas(sp.update(text))
                    elif chat:
                        chunk({
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": srv.cfg.model_name,
                            "choices": [{"index": 0, "delta": {"content": text},
                                         "finish_reason": None}],
                        })
                    else:
                        chunk({
                            "id": rid, "object": "text_completion",
                            "created": created, "model": srv.cfg.model_name,
                            "choices": [{"index": 0, "text": text,
                                         "finish_reason": None}],
                        })
                tail = dec.flush()
                if sp is not None:
                    emit_chat_deltas(sp.update(tail) + sp.finish())
                    finish = ("tool_calls" if sp.message.tool_calls
                              else "stop")
                    chunk({
                        "id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": srv.cfg.model_name,
                        "choices": [{"index": 0, "delta": {},
                                     "finish_reason": finish}],
                    })
                elif tail:
                    delta = ({"delta": {"content": tail}} if chat
                             else {"text": tail})
                    chunk({
                        "id": rid,
                        "object": ("chat.completion.chunk" if chat
                                   else "text_completion"),
                        "created": created, "model": srv.cfg.model_name,
                        "choices": [{"index": 0, **delta,
                                     "finish_reason": None}],
                    })
                data = b"data: [DONE]\n\n"
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                return
            toks = req.tokens()
            text = getattr(req, "_detok", srv.detok)(toks)
            usage = {
                "prompt_tokens": req.n_prompt,
                "completion_tokens": len(toks),
                "total_tokens": req.n_prompt + len(toks),
            }
            if chat:
                message = {"role": "assistant", "content": text}
                finish = "stop"
                if getattr(req, "_has_tools", False):
                    from .chat_parser import parse_chat, to_openai_tool_calls

                    parsed = parse_chat(
                        text, getattr(req, "_chat_format", "hermes"),
                        thinking_open=getattr(req, "_thinking_open", False))
                    if parsed.tool_calls:
                        message = {"role": "assistant",
                                   "content": parsed.content or None,
                                   "tool_calls": to_openai_tool_calls(parsed)}
                        if parsed.reasoning:
                            message["reasoning_content"] = parsed.reasoning
                        finish = "tool_calls"
                self._json(200, {
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": srv.cfg.model_name,
                    "choices": [{"index": 0,
                                 "message": message,
                                 "finish_reason": finish}],
                    "usage": usage,
                })
            else:
                self._json(200, {
                    "id": rid, "object": "text_completion", "created": created,
                    "model": srv.cfg.model_name,
                    "choices": [{"index": 0, "text": text, "finish_reason": "stop"}],
                    "usage": usage,
                })

    return Handler
