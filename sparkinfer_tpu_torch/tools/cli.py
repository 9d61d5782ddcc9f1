"""sparkinfer-torch-cli, the port of sparkinfer_tpu/tools/cli.py (the llama-cli
analogue, ref: tools/main/main.cpp) over the port's single-sequence runtime.

    python -m sparkinfer_tpu_torch.tools.cli -m model.gguf -p "..." -n 64 [--device cpu]

It runs on the CUDA card unless `--device` names another torch device. The
flags come from the port's copy of the declarative table (common/args.py,
cli scope):
  -m/--model, -p/--prompt, -f/--prompt-file, -n/--n-predict, -c/--ctx-size,
  the sampler chain (--temp --top-k --top-p --min-p --typical
  --repeat-penalty --repeat-last-n --presence-penalty --frequency-penalty
  --mirostat --xtc-*), --keep (context shift), -gan/-gaw (self-extend),
  --draft-mode lookup|lookahead and --draft, --grammar/--grammar-file/-j
  (a 1-slot Scheduler), --lora/--lora-scaled and --control-vector*, -nps
  with --json (bench mode), -i (chat REPL), --ignore-eos, -ctk/-ctv
  f32|bf16|q8 (q8 both or neither: the int8 cache; a float -ctv of its own
  splits the cache),
  -b (the prefill chunk), --moe-mode, and the SparkInfer sparse knobs
  (--sparse/--dense, --group-size, --capacity-groups, --hot-groups, -vb,
  --cold-mode, --split, --rebalance-every).
A GGUF without a vocabulary takes the prompt as space-separated token ids
and prints ids. --attn-w8a8 re-quantizes the attention projections to
row-wise W8A8 at load. --kv-iswa gives the Engine the iSWA dual cache
(rings for the sliding-window layers of gpt-oss and the gemma family).
Flags whose modules are not ported yet (-hf) and encoder-decoder models
fail at startup with an error naming the module; a non-causal encoder
(bert, neo-bert, gemma-embedding) raises ValueError naming the arch.
"""

from __future__ import annotations

import json
import sys
import time


def build_parser():
    """All flags come from the shared declarative table."""
    from ..common.args import build_parser as table_parser

    return table_parser("cli", prog="sparkinfer-torch-cli", description=__doc__)


def sparse_from_args(args, model):
    """The SparseConfig the flags ask for, or None (dense): sparse when the
    model has predictors unless --dense; a group size that does not divide
    n_ff falls back to its largest power-of-two divisor."""
    from ..sparse.config import SparseConfig, hbm_budget_to_hot_groups

    cfg = model.config
    if not ((args.sparse or cfg.has_predictors) and not args.dense and cfg.has_predictors):
        return None
    hot = args.hot_groups
    if not hot and args.hbm_budget:
        hot = hbm_budget_to_hot_groups(args.hbm_budget, cfg, args.group_size)
    gs = args.group_size
    if cfg.n_ff % gs != 0:
        gs = 1 << (cfg.n_ff & -cfg.n_ff).bit_length() - 1
        while cfg.n_ff % gs:
            gs //= 2
    return SparseConfig(group_size=gs, capacity_groups=args.capacity_groups,
                        hot_groups=hot, reload_budget_mb=args.reload_budget_mb,
                        swap_hysteresis=args.swap_hysteresis)


def make_engine(args, model):
    from ..common.args import kv_dtypes_from_args, sampler_from_args
    from ..runtime.engine import Engine

    kv_dtype, kv_dtype_v, kv_quant = kv_dtypes_from_args(args)
    eng = Engine(
        model,
        max_seq=args.ctx_size,
        sampler=sampler_from_args(args),
        kv_dtype=kv_dtype,
        kv_dtype_v=kv_dtype_v,
        kv_quantized=kv_quant,
        sparse=sparse_from_args(args, model),
        sparse_cold_mode=args.cold_mode or "host",
        split=args.split,
        rebalance_every=args.rebalance_every,
        self_extend=(args.grp_attn_n, args.grp_attn_w) if args.grp_attn_n > 1 else None,
        kv_iswa=args.kv_iswa,
        moe_mode=args.moe_mode,
        device=args.device,
    )
    if args.batch_size:
        eng.prefill_chunk = args.batch_size  # -b: prefill ubatch length
    return eng


def apply_adapters(args, model) -> None:
    """Merge --lora/--lora-scaled and --control-vector* into the loaded
    params before any engine prepares its stores (ref:
    common_init_from_params applies adapters after load,
    common/common.cpp:1068-1085)."""
    from ..common.args import adapters_from_args, control_vectors_from_args

    loras = adapters_from_args(args)
    cvecs = control_vectors_from_args(args)
    if not loras and not cvecs:
        return
    from ..models.lora import apply_control_vector, apply_lora, load_control_vector

    for path, scale in loras:
        model.params = apply_lora(model.params, model.config, path, scale)
    for path, scale in cvecs:
        cv = load_control_vector(path, model.config.n_layer, model.config.n_embd)
        model.params = apply_control_vector(model.params, model.config, cv, scale)


def _prompt(args) -> str | None:
    if args.prompt is None and args.prompt_file:
        with open(args.prompt_file) as f:
            return f.read()
    return args.prompt


def grammar_main(args, model, gbnf: str) -> int:
    """Grammar-constrained generation through a 1-slot Scheduler, the
    server's masking path (ref: grammar-first sampling in
    common/sampling.cpp:104); sparse models tick through v1."""
    from ..common.args import kv_dtypes_from_args, sampler_from_args
    from ..runtime.scheduler import Request, Scheduler
    from ..server.app import _Utf8Stream
    from ..tokenizer import build_tokenizer

    if model.vocab is None:
        print("--grammar needs a model with a tokenizer", file=sys.stderr)
        return 1
    prompt = _prompt(args)
    if prompt is None:
        print("need -p/--prompt or -f/--prompt-file", file=sys.stderr)
        return 1
    tk = build_tokenizer(model.vocab)
    sched = Scheduler(model, n_slots=1, max_seq=args.ctx_size,
                      sampler=sampler_from_args(args), tokenizer=tk,
                      **dict(zip(("kv_dtype", "kv_dtype_v", "kv_quantized"),
                                 kv_dtypes_from_args(args))),
                      sparse=sparse_from_args(args, model),
                      sparse_cold_mode=args.cold_mode or "host", split=args.split,
                      rebalance_every=args.rebalance_every, device=args.device)
    req = sched.submit(Request(prompt_tokens=tk.encode(prompt, add_special=True),
                               max_new_tokens=args.n_predict, grammar=gbnf, seed=args.seed))
    sys.stdout.write(prompt)
    sched.start()
    try:
        us = _Utf8Stream(tk)
        for tok in req.stream():
            sys.stdout.write(us.push([tok]))
            sys.stdout.flush()
        sys.stdout.write(us.flush() + "\n")
    finally:
        sched.stop()
    return 0


def bench_main(args, model) -> int:
    """Batch-bench mode (ref: tools/main/main.cpp:185 bench_main): N prompts
    from --prompt-file (one per line), prefill and decode t/s of each."""
    from ..tokenizer import build_tokenizer

    if not args.prompt_file:
        print("bench mode needs --prompt-file", file=sys.stderr)
        return 1
    with open(args.prompt_file) as f:
        prompts = [ln.rstrip("\n") for ln in f if ln.strip()][: args.n_bench_prompts]
    tk = build_tokenizer(model.vocab) if model.vocab is not None else None
    eng = make_engine(args, model)
    rows = []
    for i, p in enumerate(prompts):
        ids = tk.encode(p, add_special=True) if tk else [int(x) for x in p.split()]
        eng.perf.__init__()
        eng.generate(ids, max_new_tokens=args.n_predict)
        s = eng.perf.summary()
        s["prompt"] = i
        rows.append(s)
        if not args.json:
            print(f"prompt {i}: prefill {s['prefill_tokens']} tok "
                  f"@ {s['prefill_tps']} t/s | decode {s['decode_tokens']} tok "
                  f"@ {s['decode_tps']} t/s")
    if args.json:
        print(json.dumps(rows))
    return 0


def chat_main(args, model) -> int:
    """Interactive chat REPL (ref: tools/main interactive + tools/run)."""
    from ..server.app import _template_for
    from ..server.chat import apply_template
    from ..tokenizer import build_tokenizer

    if model.vocab is None:
        print("interactive mode needs a tokenizer", file=sys.stderr)
        return 1
    tk = build_tokenizer(model.vocab)
    template = _template_for(model.vocab, args.chat_template)
    eng = make_engine(args, model)
    stop = {i for i in range(model.vocab.n_tokens) if model.vocab.is_eog(i)}
    history = []
    print(f"(interactive; template={template.name}; /bye to exit)", file=sys.stderr)
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() in ("/bye", "/exit", "/quit"):
            break
        if not line.strip():
            continue
        history.append({"role": "user", "content": line})
        ids = tk.encode(apply_template(history, template), add_special=True)
        out = []
        for tok in eng.generate(ids, max_new_tokens=args.n_predict, stop_ids=stop,
                                stream=True):
            sys.stdout.write(tk.decode([tok]))
            sys.stdout.flush()
            out.append(tok)
        sys.stdout.write("\n")
        history.append({"role": "assistant", "content": tk.decode(out)})
    return 0


def _check_model(ap, path: str):
    """Fail at startup, naming the module, on a model the port cannot run."""
    from ..gguf.reader import GGUFReader
    from ..models.config import ModelConfig
    from ..models.transformer import check_decoder

    with GGUFReader(path) as r:
        cfg = ModelConfig.from_gguf(r)
    if cfg.traits.enc_dec:
        ap.error(f"{cfg.arch} is an encoder-decoder model: it needs runtime/seq2seq.py "
                 "(Seq2SeqEngine), which is not ported yet")
    check_decoder(cfg, "generation")


def main(argv=None) -> int:
    from ..common.args import (
        apply_model_overrides,
        grammar_from_args,
        kv_dtypes_from_args,
        unported_flags,
    )

    ap = build_parser()
    args = ap.parse_args(argv)
    kv_dtypes_from_args(args)  # validates the -ctk/-ctv combination
    missing = unported_flags(args)
    if missing:
        ap.error("; ".join(missing))
    if args.model is None:
        print("need -m/--model", file=sys.stderr)
        return 1
    _check_model(ap, args.model)

    from ..models.loader import load_model

    t0 = time.time()
    model = load_model(args.model, device=args.device, attn_w8a8=args.attn_w8a8)
    apply_model_overrides(args, model)  # --rope-*/--yarn-*/-t
    if args.verbose:
        print(f"loaded {args.model} ({model.config.arch}) in {time.time() - t0:.1f}s",
              file=sys.stderr)
    apply_adapters(args, model)

    gbnf = grammar_from_args(args)
    if gbnf is not None:
        return grammar_main(args, model, gbnf)
    if args.n_bench_prompts > 0:
        return bench_main(args, model)
    if args.interactive:
        return chat_main(args, model)

    prompt = _prompt(args)
    if prompt is None:
        print("need -p/--prompt or -f/--prompt-file", file=sys.stderr)
        return 1

    if args.kv_iswa and (args.draft_mode != "none" or args.grp_attn_n > 1):
        print("--kv-iswa cannot run with --draft-mode or -gan: the drafters and self-extend "
              "need a full KV cache", file=sys.stderr)
        return 1
    eng = make_engine(args, model)
    drafter = None
    if args.draft_mode != "none":
        if args.temp > 0:
            print("--draft-mode requires --temp 0 (greedy)", file=sys.stderr)
            return 1
        from ..runtime.sampling import penalizes

        if penalizes(eng.sampler_cfg):
            print("--draft-mode cannot run with --repeat-penalty, --presence-penalty or "
                  "--frequency-penalty: drafts are accepted on the unpenalized logits",
                  file=sys.stderr)
            return 1
        if args.draft_mode == "lookup":
            from ..runtime.lookup import LookupEngine

            drafter = LookupEngine(eng, n_draft=args.draft)
        else:
            from ..runtime.lookahead import LookaheadEngine

            drafter = LookaheadEngine(eng, n_draft=args.draft)
    if model.vocab is not None:
        from ..tokenizer import build_tokenizer

        tk = build_tokenizer(model.vocab)
        ids = tk.encode(prompt, add_special=True)
        stop = set()
        if model.vocab.eos_id is not None and model.vocab.eos_id >= 0 and not args.ignore_eos:
            stop.add(model.vocab.eos_id)
        sys.stdout.write(prompt)
        sys.stdout.flush()
        toks = (drafter.generate(ids, max_new_tokens=args.n_predict, stop_ids=stop)
                if drafter is not None else
                eng.generate(ids, max_new_tokens=args.n_predict, stop_ids=stop,
                             stream=True, n_keep=args.keep))
        for tok in toks:
            sys.stdout.write(tk.decode([tok]))
            sys.stdout.flush()
        sys.stdout.write("\n")
    else:
        ids = [int(x) for x in prompt.split()]
        out = (drafter.generate(ids, max_new_tokens=args.n_predict)
               if drafter is not None else
               eng.generate(ids, max_new_tokens=args.n_predict, n_keep=args.keep))
        print(" ".join(map(str, out)))
    if drafter is not None and args.verbose:
        st = drafter.stats
        print(json.dumps({"draft_mode": args.draft_mode, "rounds": st.n_rounds,
                          "drafted": st.n_drafted, "accepted": st.n_accepted,
                          "accept_rate": round(st.accept_rate, 3)}), file=sys.stderr)
    if args.verbose:
        print(json.dumps(eng.perf.summary()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
