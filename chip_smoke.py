#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparkinfer_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the numbers in PERF.md). It exits non-zero, printing no result, where torch
sees no card or the package is missing. Phases, each of which fails the run:

  1. device: name, count, nvidia-smi name and power limit;
  2. build: every CUDA kernel of the main paths, one nvcc per source, all
     started at once from csrc/;
  3. reference, f32 on small inputs, kernel path against plain path, the
     engines' and Scheduler's decode steps replaying CUDA graphs: tokens
     equal and first-decode logits within 1e-4 of their scale:
       serving (v1): a tiny model served by the Scheduler, 4 requests on 2
       slots, on the card against the CPU;
       union (v7u): ProSparse-Llama-2-7B widths cut to 2 layers, B=8, the
       union FFN of layer 1 on the card against "gather_union" at one
       selection (v7u rounds the hidden and W_down to bf16, so a full f32
       forward is chaotic: within 1e-2 of the output's scale, UNION_TOL),
       and the full forward finite;
       bench path (v2, v1): ProSparse-Llama-2-7B widths cut to 2 layers,
       sparkinfer-bench's pipelined decode over the v1 row layout, greedy
       through a bare forward: the v2 path (SPIF_KERNEL_V2) and the v1 path
       against the "gather" math, all on the card, each kernel launched
       n_layer times per forward;
       bf16 stores (v6): a tiny model on the card against the CPU, and
       ProSparse-Llama-2-7B widths cut to 2 layers, kernel against "gather"
       mode, both on the card;
       Q8_0 (v6q, quant_matmul): a tiny Q8_0 model (attention, head, flat
       stores, predictor stacks) on the card against the CPU; and
       ProSparse-Llama-2-13B widths cut to 2 layers, kernel against
       "gather" mode on the card, layer by layer: the plain path decodes 8
       greedy steps and feeds each layer's FFN input (its normed residual
       and carried selection) to the kernel FFN too, whose output must lie
       within 1e-4 of the plain one's scale and whose carried selection
       must be equal, at weight seeds 27, 3-9, 20 and 22. Whole forwards
       are no gate there: the quant products round their activations to
       bf16, so where the two FFNs differ in the last f32 bit an activation
       next to a bf16 rounding midpoint rounds apart and the difference
       cascades (0 to 1.4e-3 of the logits' scale over seeds on an H100);
       their first decode logits are printed and their greedy tokens
       checked equal at seed 27;
  4. kernels: each kernel against its plain torch version on the card at
     its main path's decode shapes, over stores that keep the 50 MB L2
     cold (CUDA-graph replay): 64 random row sets of the flat stores, 64
     of the model's attention matrices, 64 random Q4_0 stores, the 40
     layers of each predictor stack, and the 184 MB head alone; with
     max_abs_err, tol, ms, plain_ms, bound_ms and library_ms (the bf16
     torch.matmul of the dequantized weight for the quant products):
       sparse_ffn_block_v6 at 7B widths (E=4096, G=128, C=12 of 86, bf16),
       N=1 and 4, and N=6 (a speculative verify, K=5) and 32 (a 32-token
       sparse prefill) with every token's groups in one layer, with the
       kernel one call launches and its span (torch.profiler: v6_ffn
       alone) and its launch plan;
       sparse_ffn_block (v1) at 7B widths, N=1 and 4, over the Scheduler's
       row stores, and v3 and v5 over the same stores, v4 over their
       interleave (L, ng, 3, G, E), v2 over the bench path's concatenated
       store (L, 3*ng, G, E), these four with an up bias; all five run one
       strided kernel (csrc/sparse_ffn_v1.cu), each row with the kernel one
       call launches and its span (torch.profiler: v1_ffn alone), the time
       of an eager call and its launch plan; sparse_ffn_block_v7u at 7B
       widths, B=1, 4 and 8, Cu=48, over the model's stores, and at 13B
       widths, B=8, Cu=64 of 108, E=5120, over one layer's bf16 stores, each
       with the kernels one call launches (torch.profiler: v7u_up then
       v7u_down) and its launch plan (clusters, blocks, wave ratios);
       sparse_ffn_block_v6q at 13B widths (E=5120, G=128, C=16 of 108), N=1
       and 4, with the kernels one call launches and their spans
       (torch.profiler: v6q_up then v6q_down) and its launch plan;
       quant_matmul_2d Q8_0/Q4_0 5120x5120 at N=1 and 32 and Q8_0 at N=4, 8
       and 512, Q8_0 head 5120x32000 at N=1 and 32; quant_matmul_flat at the
       predictor shapes 5120x1280 and 1280x13824, N=1 and 32, and 1280x13824
       at N=4; each with the kernels one call launches (torch.profiler: one,
       qmm_decode at N <= 4, qmm_prefill above) and the launch plan (tile, K
       splits, wave ratio);
  5. main paths, each decode step (or tick forward) one replay of a CUDA
     graph, each with every launch count set to 0 just before and read just
     after (a replay credits the launches its capture recorded; a capture's
     warm-up is one more step forward, counted), all logits finite, a
     profile of a few decode steps (torch.profiler, which sees the kernels
     inside the graphs: the independent count) and peak memory:
       ProSparse-Llama-2-7B widths, bf16 (bench.py "7b" preset scales; the
       full run takes FULL_RUN_7B_L of the 32 layers for every 7B path of
       phases 4 and 5, 32 with --7b-paths, which runs phases 1, 2 and
       those paths alone and prints no result), sparse greedy generate of
       64 tokens from a 32-token prompt: v6
       n_layer times per decode step, with v6's device time and launches (1
       kernel a call) and the f32 copies' in the profiled steps;
       the Scheduler at the same widths: 8 greedy requests (32-token
       prompts, 32 new tokens) on 4 slots, so half of them queue, with
       sparse_batch_max = 4: v1 n_layer times per tick and no other kernel,
       with v1's device time and launches (1 kernel a call) and the f32
       copies' in a profile of 6 ticks;
       batched decode at the same widths (bench.py batch): aggregate tok/s
       of dense, masked-dense, per-token v6, union v7u and the Scheduler's
       v1 step at B = 1, 2, 4, 8 (the Scheduler's two ticks at 16 too), each
       from its own dense prefill, best of 3 runs of 8 steps, exact launch
       counts per run; the Scheduler's two ticks (masked-dense and v1)
       replay a CUDA graph of their forward as the Scheduler does, with the
       device span of one replay, while dense, v6 and v7u stay eager; then a
       profile of 4 v7u steps at B = 8 (v7u's share of the step's device
       time); the largest B (the rows a tick computes, the Scheduler's
       n_slots) at which the graphed v1 tick beats the graphed masked-dense
       tick is the crossover that sparse.config.sparse_batch_crossover
       holds;
       sparkinfer-bench's decode rows at the same widths
       (tools.bench_matrix.bench_tg: a 512-token seed prefill into a
       1024-token cache, tg 16, 3 runs, B = 1 and 4): dense, sparse over the
       v1 row layout (v1 n_layer times per forward, no other kernel) and
       sparse with SPIF_KERNEL_V2 (v2 n_layer times per forward), with tok/s,
       ms per step and peak memory;
       ProSparse-Llama-2-13B widths, Q8_0 (bench.py "13b" preset; random
       weights made and quantized on the card layer by layer, through the
       ggml Q8_0 blocks a GGUF holds; the full run takes FULL_RUN_13B_L of
       its 40 layers for 5c, 5d, 5h, 5i, 5j and 5m(a), and --quant,
       --tiered and --prefill-profile all 40): v6q L, quant_matmul_2d 4L+1 and
       quant_matmul_flat 2(L+1) times per decode step, with v6q's device
       time and launches (2 kernels a call) and 6L+3 qmm_decode kernels in
       the profiled steps; a profiled 32-token prefill (device time of the
       qmm_* kernels and their launches, prefill tok/s);
     5h. graph against eager, for the 7B bf16 sparse engine and the dense
       one on the same weights, the Scheduler's tick, the 13B Q8_0 sparse
       engine and the dense one (Q8_0 FFN from the same weights): each eager
       side (cuda_graph=False) over the same params or prepared stores, the
       same greedy requests; the streams equal and the first decode (tick)
       logits bit-equal, or the run fails; two generate calls on one engine
       capture one graph; wall ms a step (tick) and tok/s, device ms and
       busy share over profiled replayed steps (busy share: of the profiled
       window; device share of wall: of the unprofiled step), the device
       span of one replay (CUDA events), the host time of its replay()
       call and the wall time of a replay synchronized after, an engine
       step taken apart (host ms of the fills, the replay call and the token
       read; device ms around the replay), capture seconds and graph pool
       bytes, and the sparse/dense decode tok/s ratio of graph and of eager.
     5i. the OpenAI-compatible server (server/app.py) over HTTP on
       127.0.0.1, with an in-memory SPM vocabulary of 32000 pieces from the
       seed and a llama-2 chat template: the 7B bf16 model behind
       SparkServer (4 slots, max_seq 1024, SparseConfig(128, 12), the
       crossover table's sparse_batch_max), 4 concurrent streamed
       completions of 32-token prompts (32 greedy tokens) equal to the same
       requests through its Scheduler directly, 2 streamed chats equal to
       the same chats not streamed, a json_schema request whose text the
       grammar accepts, /tokenize, /detokenize, /health and /metrics, v1
       launched L times in each sparse tick; the 13B Q8_0 dense model with
       its packed linears behind a second SparkServer, 4 concurrent
       requests equal to its Scheduler, quant_matmul_2d launched 7L + 1
       times a forward; time to first token and end-to-end ms of each
       request, the clients' aggregate decode tok/s against the bare
       Scheduler's, ms a tick of the grammar mask; and
       `python -m sparkinfer_tpu_torch.server` on a small GGUF written by
       the port's writer, started as a child process, answering /health
       and one completion.
     5j. hot/cold tiering (sparse/tiering.py, balancer.py, the host
       library csrc/spark_host.cpp built with g++ in phase 2), with the
       predictor bias of bench.py's tiered harness (a random fifth of each
       layer's groups fires): an f32 gate at 7B widths cut to 4 layers, 22
       of 86 groups hot, host mode's FFN (v6 plus the host complement)
       within 1e-4 of the untiered sparse FFN over the same groups at every
       layer of 8 decode steps, and the two forwards' greedy tokens equal;
       the 7B bf16 model, SparseConfig(128, 12), 22 of 86 groups hot:
       the tiered Engine in fetch and drop modes (CUDA graphs, 64 tokens, a
       rebalance after every step) and host mode (eager, 16 tokens), one
       f16 cold store at a time, v6 launched n_layer times a step; in fetch
       mode the misses a token of the last 16 steps below those of the
       first 16, and after at least 8 rebalances that swapped a replay's
       logits bit-equal to the eager step's on the same state; then the
       4-slot Scheduler with prefill_mode="tiered" (4 requests of 32
       tokens), which takes the dense FFN out of the model and keeps no row
       store; the 13B widths with a Q8_0 hot store of 27 of 108 groups
       (v6q, init_tiered(quant="q8_0"), bf16 rows drawn a layer at a time
       into host RAM), fetch mode as a CUDA graph of the tiered step driven
       directly (the Engine builds no Q8_0 hot store, as in the JAX
       package), v6q L, quant_matmul_2d 4L+1 and quant_matmul_flat 2L
       times a step; each with tok/s, wall and device ms a step, ms a
       rebalance, swaps, bytes copied to the card, window, overruns, misses
       a token, host complement ms a layer and peak memory, beside phase
       5h's 7B steps and the dense engine's peak. `python3 chip_smoke.py
       --tiered` runs phases 1, 2 and 5j alone and prints no result.
     5k. Mixture-of-Experts (sparse/moe.py) at Qwen3-30B-A3B widths
       (Qwen/Qwen3-30B-A3B config.json: L=48, E=2048, 32 heads, 4 KV heads,
       head_dim 128, 128 experts of width 768, 8 used, V=151936), random
       weights from SEED built on the card, one resident copy of the
       experts, in a child process started right after phase 2 (before
       this process builds any model; it prints the free memory it starts
       with): an f32 gate at 4 layers, the fused mode (v1, mask_mode
       "scale") against dense mode layer by layer over a 32-token prompt
       and 8 decode steps (each FFN output within 1e-4 of its scale, the
       routed experts and greedy tokens equal), and host-mode expert
       tiering (eager, 32 of 128 experts hot, an f32 cold store) within
       1e-4 of dense mode with misses; v1 against its plain version at
       the MoE shapes (N = 1 and 32, C = 48, G = 128, E = 2048, bf16); the
       bf16 model (48 layers, its full depth, with --moe; 12 in the full
       run, FULL_RUN_MOE_L) through Engine(moe_mode="pallas") (v1
       n_layer times a forward) and Engine(moe_mode="dense") (no counted
       kernel), a 32-token prompt and 64 greedy tokens each, decode as CUDA
       graphs whose first decode logits equal an eager engine's bit for
       bit, with tok/s, wall and device ms a step, v1's share, the replay
       span, prefill ms and peak memory; the 4-slot Scheduler (max_seq
       1024, 8 requests of 32 + 32 tokens, dense MoE, the tick a graph);
       expert tiering at 12 layers (a router skewed towards a random fifth
       of each layer's experts, 32 of 128 hot, an f16 cold store in host
       RAM, the expert stacks then dropped from the card), drop mode as a
       CUDA graph of the tiered step, 64 tokens, a rebalance after every
       step, the misses a token of the last 16 steps below those of the
       first 16. `python3 chip_smoke.py --moe` runs phases 1, 2 and 5k
       alone and prints no result.
     5l. the single-sequence runtime and the CLI, on the 7B bf16 model
       (full width and depth, SparseConfig(128, 12), decode steps as CUDA
       graphs), right after 5h: the static sampler chain (repetition
       penalty 1.1 over the last 64 tokens) and a context shift (max_seq
       128, a 32-token prompt, 160 tokens) and self-extend ((4, 64),
       max_seq 256, 200 tokens), each a graph engine's stream against an
       eager engine's over the same stores, every token's logits bit-equal
       and no capture in the compared run; mirostat v2 seeded (64 tokens,
       mu moved on the device); the 32-token prompt prefilled through v6
       (sparse_prefill="sparse": v6 at N=32, n_layer launches) against the
       masked-dense prefill; speculative decoding (the sparse target, a
       dense draft on the same weights, K=5), lookup and lookahead over a
       repeated prompt, 64 tokens each, with accept rate, ms a round, the
       plain step's ms and v6 launches a round (v6 at N=6 in each verify),
       on the random weights and on echo weights (greedy decoding repeats
       its last token: every draft accepted); the 4-slot v1 Scheduler's
       slot saved after 16 tokens, zeroed and restored into another slot,
       whose continuation streams the saved slot's, no capture; a rank-8
       LoRA adapter (attn_q, ffn_up, ffn_down, written by the port's GGUF
       writer) re-merged in place into the weights and flat stores (scale 0
       and 1 give back their logits bit for bit) and served by SparkServer,
       /lora-adapters at scale 0 and 1 each streaming its text again; f32
       gates at 7B widths cut to 4 layers: the three drafters' greedy
       streams against plain greedy decode (a difference only at a top-2
       gap below 1e-4 of the scale) and the in-place LoRA merge against a
       plain torch merge (prefill and first decode logits within 1e-3); and
       `python -m sparkinfer_tpu_torch.tools.cli` as a child process on a
       GGUF at 7B widths cut to 2 layers (F16 weights, predictors, the
       32000-piece SPM vocabulary), sparse decode, --draft-mode lookup and
       -gan 4 -gaw 64 each printing the in-process engine's stream, and
       -nps 2 --json. `python3 chip_smoke.py --runtime` runs phases 1, 2
       and 5l alone and prints no result.
     5m. the quantized formats and embeddings: (a) the JAX bench's
       headline row at ProSparse-Llama-2-13B widths and 5c's depth (5c's
       draws): W8A8 attention (wq wk wv wo) and W8A8 predictor stacks,
       quantized a layer at a time by W8A8Tensor.from_float, over 5c's
       Q8_0 flat FFN stores (v6q) and Q8_0 head (quant_matmul_2d); the
       int8 product (torch._int_mm) bit-equal to the f64 product, and
       w8a8_linear to its plain composition, at 5120x5120, 5120x1280 and
       1280x13824, N=1 and 32; the untiered sparse Engine as a graph (v6q
       L and quant_matmul_2d once a step, int8 products 6L+2 a step, all
       counted exactly) against an eager engine (streams equal, first
       decode logits bit-equal), its profiled step against 5d's Q8_0 step
       (the kernels W8A8 adds, by name), the share of its greedy tokens
       equal to 5d's stream, and one attention projection (5120x5120,
       N=1) by w8a8_linear, by the int8 product alone, by qmm_decode and by
       the bf16 torch.matmul over every layer's weights; then tiered
       fetch over 5j's 13B hot and cold stores, right after 5j's Q8_0
       drive, with W8A8 attention and predictor stacks (v6q L,
       quant_matmul_2d once and 6L int8 products a forward); (b) a GGUF at
       ProSparse-Llama-2-7B widths cut to 4 layers (host decoding at load
       bounds the depth) in llama.cpp's Q4_K_M mix (Q4_K, Q6_K for attn_v,
       ffn_down and output; f16 predictors), its blocks written directly
       with sane f16 scales, loaded by load_model and run by the sparse
       Engine through v6 (L a step), against the BF16 GGUF of its values
       decoded on the host: prefill logits bit-equal, streams equal, load
       seconds and decode M elements/s a format; (c) the 7B bf16 model of
       the main path (full width and depth, the SPM vocabulary, a seeded
       cls_out_w (1, E)) behind SparkServer: /v1/embeddings of 8 inputs of
       16-512 tokens bit-equal to the Embedder's vectors of each input
       alone, an input sent alone equal to itself among the 8, /v1/rerank
       of 8 documents whose scores equal the head applied in f64 on the
       host to the forward's hidden state, and the ms of a 512-token
       embedding. `python3 chip_smoke.py --quant` runs phases 1, 2, 5m(c),
       5m(b), 5c's engine and 5d's main path, then 5m(a) (tiered fetch
       with W8A8 only) and prints no result.
     5o. sliding-window attention (models/transformer.py, the iSWA ring
       cache of runtime/kv_cache.py) at gpt-oss-20b's width and depth
       (openai/gpt-oss-20b config.json: L=24, E=2880, 64 heads, 8 KV heads
       of 64, 32 experts of 2880, 4 used, window 128 on alternate layers,
       V=201088, yarn; sinks and attention biases), random bf16 weights
       from SEED (41.8 GB, one resident copy of the experts; 8 layers in
       the full run, FULL_RUN_SWA_L, 24 with --swa), in a child process
       started after 5k's: an f32 gate at 4 layers (the fused FFN,
       v1 with the bias rows and swiglu_oai, against dense mode layer by
       layer within 1e-4 of its scale, greedy tokens equal; the iSWA cache
       against the full cache teacher-forced over a 1400-token prompt and
       32 steps, past the ring's wrap, within 1e-4; the 4-slot Scheduler's
       streams against the Engine's, as below, parted only within 1e-4 of
       a tie); v1 against its plain
       version at the gpt-oss shape (C = 180, G = 64, E = 2880, N = 1 and
       32); Engine(moe_mode="pallas") with and without kv_iswa (v1 once a
       layer a forward) and Engine(moe_mode="dense"), a 32-token prompt and
       128 greedy tokens past the window, decode as CUDA graphs whose
       streams and first decode logits equal an eager engine's; the bf16
       iSWA cache against the full cache teacher-forced as in the gate,
       within 5e-2 of the logits' scale, on the model with a decisive
       router (4 experts a layer biased by 30: random weights let a
       last-bit difference move a token to another expert), and printed
       for the model as drawn beside two full caches of another width;
       KV bytes and the step's device ms of both caches at max_seq 32768;
       the 4-slot Scheduler (dense MoE, the window as a mask, the decisive
       router, 4 requests of 32 + 128 tokens) against the Engine's
       single-sequence streams (equal, or parted at a near-tie);
       and a gemma3 cut at Gemma-3-4B width (6 layers: five sliding, one
       global; two rope bases; q/k and sandwich norms; tied head), iSWA
       rings of 1280 slots, a 1400-token prompt, graph against eager
       bit-equal. `python3 chip_smoke.py --swa` runs phases 1, 2 and 5o
       alone and prints no result.
     5p. deepseek2 (multi-head latent attention over the latent cache,
       the leading dense layer and the MoE layers as layer segments, two
       shared experts) at DeepSeek-V2-Lite's width and depth
       (deepseek-ai/DeepSeek-V2-Lite config.json: L=27, E=2048, 16 heads,
       a direct q, kv_lora_rank 512, qk_nope 128, qk_rope 64, v_head 128,
       one dense layer of 10944, 64 experts of 1408, 6 used, softmax, no
       top-k renormalization, routed scale 1.0, 2 shared experts,
       V=102400, yarn factor 40), random bf16 weights from SEED (31.4 GB;
       the full run takes FULL_RUN_MLA_L of the 27 layers, 27 with --mla),
       in a child process started after 5o's: an f32 gate at 4 layers
       (the fused FFN against dense mode layer by layer within 1e-4 of its
       scale, greedy tokens equal); v1 against its plain version at the
       DeepSeek-V2-Lite shape (C = 66, G = 128, E = 2048, N = 1 and 32);
       Engine(moe_mode="pallas") (v1 26 times a forward) and
       Engine(moe_mode="dense"), a 32-token prompt and 128 greedy tokens,
       decode as CUDA graphs whose streams and first decode logits equal
       an eager engine's, tok/s of each and their ratio; the latent
       cache's bytes against a per-head cache's and the step's device ms
       at max_seq 2048 and 32768; the 4-slot Scheduler (dense MoE, a
       decisive router: a selection-only bias of 30 on 6 experts a layer,
       4 requests of 32 + 64 tokens) against the Engine's streams (equal,
       or parted at a near-tie). `python3 chip_smoke.py --mla` runs phases
       1, 2 and 5p alone and prints no result.
     5q. the llama-shaped and MoE archs (models/transformer.py,
       sparse/moe.py) at full width and depth, in a child process started
       after 5p's, random weights from SEED drawn on the card: Qwen3-8B
       (Qwen/Qwen3-8B config.json: L=36, E=4096, 32 heads, 8 KV heads of
       128, F=12288, V=151936, rope base 1e6, per-head q/k RMS norms, an
       untied head) with Q8_0 attention, FFN and head (8.5 GB packed):
       quant_matmul_2d against its plain version at its five shapes (4096 x
       4096, 4096 x 1024, 4096 x 12288, 12288 x 4096, the head 4096 x
       151936; N = 1 and 32; one kernel a call, as the profiled decode
       step and prefill count); the dense
       Engine (quant_matmul_2d 7L + 1 times a forward), 32 + 128 tokens,
       the graph against an eager engine (streams equal, first decode
       logits bit-equal), qmm_decode and qmm_prefill launches a step and a
       prefill (profiled), and the step's bound (every packed weight and
       the K/V read once at 3.35 TB/s); an f32 gate at 4 layers (each
       packed product within 1e-4 of its plain version's scale, on the
       plain path's inputs; the two paths' greedy tokens equal or parted at
       a near-tie). Qwen1.5-MoE-A2.7B (Qwen/Qwen1.5-MoE-A2.7B config.json:
       L=24, E=2048, 16 heads of 128, 60 experts of 1408, 4 used, no top-k
       renormalization, a shared expert of 5632 with its sigmoid gate, qkv
       biases, V=151936; 28.6 GB in bf16): v1 against its plain version at
       C = 44, G = 128 (N = 1 and 32); the fused (v1 L times a forward) and
       the dense Engines, 32 + 128 tokens, each a graph against an eager
       engine (streams equal, first decode logits bit-equal); an f32 gate
       at 4 layers (the fused FFN within 1e-4 of dense mode's, tokens
       equal). Then 4-layer bf16 cuts of hunyuan-dense (q/k norms after
       rope) and stablelm (LayerNorm, qkv biases, partial rope, per-head q/k
       LayerNorms), graph against eager. `python3 chip_smoke.py --archs`
       runs phases 1, 2 and 5q alone and prints no result; the full run
       cuts Qwen3-8B to FULL_RUN_ARCHS_QWEN3_L layers and Qwen1.5-MoE to
       FULL_RUN_ARCHS_MOE_L.
     5r. the int8 KV cache (-ctk q8 -ctv q8: int8 codes and an f32 scale a
       token and head, runtime/kv_cache.py) and a split cache (-ctk bf16
       -ctv f32), in the main process over the 7B model's prepared stores:
       an f32 gate (ProSparse-Llama-2-7B widths cut to 2 layers, the v6
       path against the "gather" path, each over an int8 cache: first
       decode logits within 1e-4 of their scale, streams equal, layer 0's
       codes and scales bit-equal); the 7B bf16 sparse Engine (v6 32 times
       a step) over an int8 cache, 32 + 32 tokens, its graph against an
       eager engine (streams equal, first decode logits bit-equal), its
       first logits and stream against the bf16 cache's; the caches' bytes
       (int8 exactly 132/256 of bf16 at 4096 and 32768 slots) and a decode
       step's device ms at max_seq 2048 and 32768, bf16 against int8; the
       4-slot v1 Scheduler over an int8 cache (8 requests of 32 + 32
       tokens), its graph ticks against eager ticks, then a context shift
       of every slot and a slot saved, zeroed and restored, the first tick
       after each bit-equal to the eager tick; the split cache's Engine,
       graph against eager, 32 tokens. `python3 chip_smoke.py --kvq` runs
       phases 1, 2 and 5r alone (on the 7B model's main path) and prints no
       result.
     5s. the last MLA archs, in a child process started after 5q's:
       MiniCPM3-4B (openbmb/MiniCPM3-4B config.json: L=62, E=2560, 40
       heads, q-lora 768, kv-lora 256, qk_nope 64, qk_rope 32, v_head 64,
       F=6400, V=73448; embedding, residual and logit multipliers 12,
       1.4/sqrt(62), 256/2560) with Q8_0 wq_a, wq_b, wkv_a, wo, FFN and
       head drawn on the card (4.49 GB packed with f32 scales, the GGUF's
       4.24 GB; the full run takes FULL_RUN_MLA_ARCHS_L of the 62 layers,
       62 with --mla-archs): an f32 gate at 4 layers (each packed product
       within 1e-4 of its plain version's scale); the dense Engine
       (quant_matmul_2d 7L + 1 times a forward, 435 at 62 layers), 32 + 64
       tokens, graph against eager, qmm_decode and qmm_prefill counted by
       profiles; its latent cache at max_seq 32768 (L x 288 x 2 bytes a
       token, 35,712 at 62 layers); quant_matmul_2d at its seven
       shapes (the head's OUT of 73448 not 16-aligned), N = 1 and 32; then
       4-layer cuts of plm (a direct q, an ungated relu² FFN, Q8_0, its
       widths) and nemotron (E=2560, F=6400, LayerNorm with biases, rope
       over half of each head, relu²), graph against eager. `python3
       chip_smoke.py --mla-archs` runs phases 1, 2 and 5s alone and prints
       no result.
     5t. ALiBi and the GPT family, in a child process started after 5s's:
       BLOOM-7b1 (bigscience/bloom-7b1 config.json: L=30, E=4096, 32 heads
       of 128, F=16384, V=250880, LayerNorm eps 1e-5, the post-embedding
       LayerNorm, biases everywhere, ALiBi, tied head) with Q8_0 wq, wk,
       wv, wo, up and down drawn on the card (6.79 GB packed with f32
       scales, the GGUF's 6.42 GB; the bf16 head, the embedding's
       transpose, 2.06 GB; the full run takes FULL_RUN_GPT_L of the 30
       layers, 30 with --gpt-archs): an f32 gate at 4 layers (each packed
       product within 1e-4 of its plain version's scale); the dense Engine
       (quant_matmul_2d 6L times a forward, 180 at 30 layers), 32 + 64
       tokens, graph against eager, qmm_decode and qmm_prefill counted by
       profiles, the replay against its bound; a replay's device ms at
       max_seq 2048 and 16384 (491,520 bytes of K/V a token at 30 layers);
       quant_matmul_2d at its three shapes, N = 1 and 32; then 2-layer
       bf16 cuts at their config.json widths, graph against eager:
       mosaicml/mpt-7b (ALiBi, no biases, tied head), EleutherAI/gpt-j-6b
       (the parallel block, interleaved rope over 64 of 256 lanes, the
       head bias) and bigcode/starcoder (MQA, 8192 learned positions).
       `python3 chip_smoke.py --gpt-archs` runs phases 1, 2 and 5t alone
       and prints no result.
     5u. Decoders with features of their own, in a child process started
       after 5t's: OLMo-2-1124-7B (allenai/OLMo-2-1124-7B config.json:
       L=32, E=4096, 32 heads of 128 (MHA), F=11008, V=100352, RMS eps
       1e-6, rope theta 500000, an untied head; post-norms only and
       full-width q/k norms) with Q8_0 wq, wk, wv, wo, up, gate, down and
       head drawn on the card (7.75 GB packed with f32 scales, the GGUF's
       7.32 GB; the full run takes FULL_RUN_FEATURE_L of the 32 layers, 32
       with --feature-archs): an f32 gate at 4 layers (each packed product
       within 1e-4 of its plain version's scale); the dense Engine
       (quant_matmul_2d 7L + 1 times a forward, 225 at 32 layers), 32 + 64
       tokens, graph against eager, qmm_decode and qmm_prefill counted by
       profiles, the replay against its bound; a replay's device ms at
       max_seq 2048 and 16384 (524,288 bytes of K/V a token at 32 layers);
       quant_matmul_2d at its three new shapes (4096x11008, 11008x4096,
       4096x100352), N = 1 and 32; apply_mrope over three equal streams
       against neox rope at Qwen2-VL-7B's widths; then 2-layer bf16 cuts
       at their config.json widths, graph against eager:
       swiss-ai/Apertus-8B-2509 (xIELU), microsoft/bitnet-b1.58-2B-4T
       (relu2_glu, sub-norms, tied head), facebook/chameleon-7b ((H, D)
       LayerNorm q/k norms) and Qwen2-VL-7B-Instruct's text stack (qkv
       biases, M-RoPE sections); and a 4-layer deci stack of synthetic
       widths (KV heads 8, 4, 0, 8, FFN 14336, 11008, 14336, 8192: one
       layer narrower than the cache, one attention-free), graph against
       eager past a context shift. `python3 chip_smoke.py --feature-archs`
       runs phases 1, 2 and 5u alone and prints no result.
     5v. The non-causal encoders and the trait decoders, in a child
       process started after 5u's, at full width and depth: BAAI/
       bge-large-en-v1.5 (config.json: BertModel, L=24, E=1024, 16 heads,
       F=4096, V=30522, 512 learned positions, 2 token types, erf gelu,
       LayerNorm eps 1e-12, CLS pooling) with Q8_0 wq, wk, wv, wo, up and
       down drawn on the card, a synthetic WordPiece vocabulary of V
       pieces and a seeded cls/cls.output head: an f32 gate, layer by
       layer (each layer of the kernel path and of the plain path fed the
       plain path's input: each packed product within 1e-4 of its plain
       version's scale, each layer's hidden states within
       ENCODER_GATE_TOL, at four seeds and 512, 512, 32 and 4 tokens); the
       Embedder at 1, 4, 32, 128 and 512 tokens with quant_matmul_2d 144
       times a forward (6 a layer), qmm_decode at N <= 4 and qmm_prefill
       above counted by profiles, wall and device ms; quant_matmul_2d at
       its three shapes, N = 1, 32 and 512; SparkServer's /v1/embeddings
       bit-equal to the Embedder, /v1/rerank within an f32 rounding bound
       of the head in f64, a completion answered with the error that names
       the arch; google/embeddinggemma-300m (gemma-embedding: 24 layers,
       E=768, 3 heads over 1 of 256, F=1152, V=262144, window 512 over
       five of six layers) and chandar-lab/NeoBERT (28 layers, E=768, 12
       heads, swiglu F=2048, V=30522) in bf16, 600 and 512 tokens, the
       symmetric band binding, and 2-layer f32 cuts on the card against
       the CPU; then 2-layer bf16 cuts of the 15g trait archs, graph
       against eager: ibm-granite/granite-3.1-8b-instruct, openbmb/
       MiniCPM-2B, bigcode/starcoder2-7b, CohereForAI/c4ai-command-r-v01,
       microsoft/Phi-3-mini-4k-instruct, pfnet/plamo-13b and a
       pangu-embedded stack of synthetic widths (not a published config).
       The widths are the named config.json's as recalled.
       `python3 chip_smoke.py --encoders` runs phases 1, 2 and 5v alone
       and prints no result.
     (At bf16 and random weights, decode is chaotic: a last-bit difference
     can flip a later group selection, so the full-size runs are checked
     for finiteness and counts, and agreement is checked in f32, phase 3.)

The line before the last is {"kernels": [...]} (v1's entry counts its MoE
launches too, and carries its MoE-shape timing under "moe", its
gpt-oss-shape timing under "gpt_oss" and its DeepSeek-V2-Lite-shape
timing under "deepseek_v2_lite"; v6's counts
phase 5l's, 5m(b)'s and 5r's and carries its N=6 and N=32 timings under
"shapes"; v6q's and quant_matmul_2d's count 5m(a)'s, quant_matmul_2d's
5q's, 5s's, 5t's, 5u's and 5v's too, with their shapes' timings under
"qwen3_8b", "minicpm3_4b", "bloom_7b1", "olmo2_7b" and "bge_large"); the
last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --prefill-profile

runs only the profiled 32-token prefill of the 13B Q8_0 engine, for the
sparkinfer_tpu_torch beside the script: a copy of the script placed in a
checkout of another revision profiles that revision.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

SEED = 0
KERNEL_TOL = 1e-3  # relative to max|plain|: f32 sums over 4096-5120 terms in other orders
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_S = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12  # H100 SXM, dense bf16 tensor cores
N_SETS = 64  # cold row sets / distinct stores per kernel timing
# depths the full run gives its largest cells, so that with phases 5p-5s
# and every eager stream decoded in full it ends within 700 s on a host
# whose eager 7B sparse steps take about 45 ms, and inside the run's limit
# on a slower one (PERF.md); each phase run alone (--moe, --swa,
# --families, --mla, --archs, --mla-archs, --quant, --tiered) keeps its
# full depth or the depth that fits (--gpt-archs, --feature-archs too)
FULL_RUN_MOE_L = 4  # of Qwen3-30B-A3B's 48 layers (phase 5k)
FULL_RUN_SWA_L = 4  # of gpt-oss-20b's 24 (phase 5o)
FULL_RUN_FAMILY_L = 2  # of ReluFalcon-40B's 60, bf16 and Q8_0 (phase 5n(a), (b))
FULL_RUN_MLA_L = 5  # of DeepSeek-V2-Lite's 27: the dense layer and 4 MoE layers (phase 5p)
FULL_RUN_13B_L = 4  # of ProSparse-Llama-2-13B's 40 (phases 5c, 5d, 5h, 5i, 5j, 5m(a))
FULL_RUN_ARCHS_QWEN3_L = 4  # of Qwen3-8B's 36 (phase 5q)
FULL_RUN_ARCHS_MOE_L = 4  # of Qwen1.5-MoE-A2.7B's 24 (phase 5q)
FULL_RUN_MLA_ARCHS_L = 4  # of MiniCPM3-4B's 62 (phase 5s)
FULL_RUN_GPT_L = 4  # of BLOOM-7b1's 30 (phase 5t)
FULL_RUN_FEATURE_L = 4  # of OLMo-2-1124-7B's 32 (phase 5u)
# of ProSparse-Llama-2-7B's 32 (phases 4a, 4c-4e, 5b, 5e-5j, 5l, 5m(c), 5r;
# --7b-paths keeps 32): an eager 7B step costs host time a layer, so this
# depth pays for phase 5v; every stream keeps its length
FULL_RUN_7B_L = 8
# v7u rounds the hidden and W_down to bf16: each product within 2^-8, about
# 2e-3 of the output's scale summed with random signs; a wrong row or mask
# errs by the scale itself
UNION_TOL = 1e-2
BATCHES = (1, 2, 4, 8, 16)
GRAPHED = ("masked_dense", "v1")  # the Scheduler's two ticks, replayed as CUDA graphs
EAGER_BATCH_MAX = 8  # dense, v6 and v7u decode eagerly up to this B; the graphed ticks at every B
PROFILE_STEPS = 4  # profiled v7u batched decode steps at EAGER_BATCH_MAX


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def prosparse_config(L, E, H, F, V, R):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="prosparse_llama", n_layer=L, n_embd=E, n_head=H,
                       n_head_kv=H, n_ff=F, n_vocab=V, head_dim=E // H,
                       pred_lora=(R,) * L)


def random_model(cfg, dtype, device, seed):
    """A LoadedModel with the loader's keys and dtypes, weights drawn on the
    device from a seeded generator at bench.py's "7b" scales: N(0, 0.02)
    projections, N(0, 0.05) pred_up, N(0, 0.6) pred_down and a predictor
    bias of N(0, 0.5) - 1.2."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device=device).manual_seed(seed)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab
    HD, KD, R = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim, cfg.max_pred_rank

    def w(*shape, scale=0.02, shift=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(scale).add_(shift)

    ones = dict(dtype=torch.float32, device=device)
    layers = {
        "attn_norm_w": torch.ones((L, E), **ones), "wq": w(L, E, HD),
        "wk": w(L, E, KD), "wv": w(L, E, KD), "wo": w(L, HD, E),
        "ffn_norm_w": torch.ones((L, E), **ones), "w_up": w(L, E, F),
        "w_gate": w(L, E, F), "w_down": w(L, F, E),
        "pred_up": w(L, E, R, scale=0.05),
        "pred_up_b": torch.zeros((L, R), dtype=dtype, device=device),
        "pred_down": w(L, R, F, scale=0.6),
        "pred_down_b": w(L, F, scale=0.5, shift=-1.2),
    }
    params = {"tok_embd": w(V, E), "output_norm_w": torch.ones((E,), **ones),
              "output": w(E, V), "layers": layers}
    return LoadedModel(config=cfg, params=params)


class Q8Weights:
    """Random weights of one ProSparse model, each tensor drawn on the device
    from its own seeded generator (so a tensor can be drawn again, equal, for
    the dense engine), and packed as a Q8_0 GGUF load packs them: the ggml
    blocks of the (out, in) weight (gguf.quants.quantize, on the card), the
    loader's repack, the IN-major QuantTensor."""

    NAMES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "output",
             "tok_embd", "pred_up", "pred_down", "pred_down_b")

    def __init__(self, cfg, dtype, device, seed):
        self.cfg, self.dtype, self.device, self.seed = cfg, dtype, device, seed

    def draw(self, name, il, shape, scale=0.02, shift=0.0):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * len(self.NAMES) + self.NAMES.index(name)) * 4096 + il)
        t = torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype)
        return t.mul_(scale).add_(shift)

    def pack(self, w_oi, kind="q8_0"):
        """(out, in) weight -> IN-major (packed, scales) on its device."""
        import torch

        from sparkinfer_tpu_torch.gguf.constants import GGMLType
        from sparkinfer_tpu_torch.gguf.quants import quantize
        from sparkinfer_tpu_torch.ops.quant_matmul import REPACK

        raw = quantize(w_oi, getattr(GGMLType, kind.upper())).cpu().numpy()
        qw, sc = REPACK[kind](raw, *w_oi.shape)
        return (torch.from_numpy(qw).to(w_oi.device).T,
                torch.from_numpy(sc).to(w_oi.device).T)

    def packed_stack(self, name, out, inn):
        """A layer-stacked Q8_0 QuantTensor of W (in, out), filled per layer."""
        import torch

        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

        L = self.cfg.n_layer
        qt = QuantTensor(torch.empty((L, inn, out), dtype=torch.int8, device=self.device),
                         torch.empty((L, inn // 32, out), dtype=torch.float32,
                                     device=self.device), "q8_0")
        for il in range(L):
            q, s = self.pack(self.draw(name, il, (out, inn)))
            qt.q[il].copy_(q)
            qt.s[il].copy_(s)
        return qt

    def dense_stack(self, name, out, inn):
        """(L, in, out) in the model's dtype, the same draws as packed_stack."""
        import torch

        L = self.cfg.n_layer
        w = torch.empty((L, inn, out), dtype=self.dtype, device=self.device)
        for il in range(L):
            w[il].copy_(self.draw(name, il, (out, inn)).T)
        return w

    def ffn_shapes(self):
        E, F = self.cfg.n_embd, self.cfg.n_ff
        return {"w_up": (F, E), "w_gate": (F, E), "w_down": (E, F)}

    def sparse_model(self, scfg):
        """The Q8_0 sparse model: Q8_0 attention and head, Q8_0 flat FFN
        stores (prepare_pipelined_params(layout="v6", quant="q8_0", drop_dense=True),
        quantized one layer at a time) and Q8_0 predictor stacks."""
        import torch

        from sparkinfer_tpu_torch.models.loader import LoadedModel
        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor, flat_quantize
        from sparkinfer_tpu_torch.sparse.ffn import prepare_pipelined_params

        cfg, dev = self.cfg, self.device
        L, E, V, R = cfg.n_layer, cfg.n_embd, cfg.n_vocab, cfg.max_pred_rank
        HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        ones = dict(dtype=torch.float32, device=dev)
        layers = {"attn_norm_w": torch.ones((L, E), **ones),
                  "ffn_norm_w": torch.ones((L, E), **ones),
                  "wq": self.packed_stack("wq", HD, E), "wk": self.packed_stack("wk", KD, E),
                  "wv": self.packed_stack("wv", KD, E), "wo": self.packed_stack("wo", E, HD)}
        layers.update({k: self.dense_stack(k, *shape)
                       for k, shape in self.ffn_shapes().items()})
        q, s = self.pack(self.draw("output", 0, (V, E)))
        params = {"tok_embd": self.draw("tok_embd", 0, (V, E)),
                  "output_norm_w": torch.ones((E,), **ones),
                  "output": QuantTensor(q.contiguous(), s.contiguous(), "q8_0"),
                  "layers": layers}
        params = prepare_pipelined_params(params, cfg, scfg, drop_dense=True, layout="v6",
                                          quant="q8_0")
        del layers  # the bf16 FFN: only the flat Q8_0 stores stay
        flat = params["sparse_flat"]
        pu = torch.stack([self.draw("pred_up", il, (E, R), scale=0.05) for il in range(L)])
        flat["pred_up_qt"] = flat_quantize(pu)
        del pu
        pd = torch.stack([self.draw("pred_down", il, (R, cfg.n_ff), scale=0.6)
                          for il in range(L)])
        flat["pred_down_qt"] = flat_quantize(pd)
        del pd
        flat["pred_up_b_all"] = torch.zeros((L, R), dtype=self.dtype, device=dev)
        flat["pred_down_b_all"] = torch.stack([
            self.draw("pred_down_b", il, (cfg.n_ff,), scale=0.5, shift=-1.2)
            for il in range(L)])
        return LoadedModel(config=cfg, params=params)

    def dense_ffn(self):
        """The same FFN weights as Q8_0 QuantTensors (a Q8_0 GGUF's FFN)."""
        return {k: self.packed_stack(k, *shape) for k, shape in self.ffn_shapes().items()}

    def w8a8_stack(self, draw_in_out):
        """A layer-stacked W8A8Tensor, each layer quantized on the card from
        draw_in_out(il), its (in, out) weight."""
        from sparkinfer_tpu_torch.ops.quant_matmul import W8A8Tensor

        first = draw_in_out(0)
        st = W8A8Tensor.empty((self.cfg.n_layer,) + tuple(first.shape), self.device)
        for il in range(self.cfg.n_layer):
            st[il] = W8A8Tensor.from_float(first if il == 0 else draw_in_out(il))
        return st

    def w8a8_draws(self) -> dict:
        """Phase 5m's W8A8 stacks by their params key, each a function of the
        layer giving its (in, out) bf16 draw: the attention projections (wq
        wk wv wo, attn_w8a8's layout) and the predictor stacks (pred_up_w8,
        pred_down_w8), as bench.py's headline row has them."""
        cfg = self.cfg
        E, F, R = cfg.n_embd, cfg.n_ff, cfg.max_pred_rank
        HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        draws = {k: (lambda il, k=k, o=o, i=i: self.draw(k, il, (o, i)).T)
                 for k, o, i in (("wq", HD, E), ("wk", KD, E), ("wv", KD, E), ("wo", E, HD))}
        draws["pred_up_w8"] = lambda il: self.draw("pred_up", il, (E, R), scale=0.05)
        draws["pred_down_w8"] = lambda il: self.draw("pred_down", il, (R, F), scale=0.6)
        return draws

    def w8a8_parts(self):
        """The stacks of w8a8_draws, each quantized a layer at a time by
        W8A8Tensor.from_float: (attention, predictor stacks)."""
        st = {k: self.w8a8_stack(draw) for k, draw in self.w8a8_draws().items()}
        return ({k: st[k] for k in ("wq", "wk", "wv", "wo")},
                {k: st[k] for k in ("pred_up_w8", "pred_down_w8")})

    def bf16_params(self):
        """The same draws unquantized, laid out as the loader lays out a bf16
        ProSparse model: dense attention, FFN and head, stacked predictors."""
        import torch

        cfg, dev = self.cfg, self.device
        L, E, F, V, R = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.max_pred_rank
        HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        ones = dict(dtype=torch.float32, device=dev)
        layers = {"attn_norm_w": torch.ones((L, E), **ones),
                  "ffn_norm_w": torch.ones((L, E), **ones),
                  **{k: self.dense_stack(k, o, i) for k, o, i in (
                      ("wq", HD, E), ("wk", KD, E), ("wv", KD, E), ("wo", E, HD))},
                  **{k: self.dense_stack(k, *shape) for k, shape in self.ffn_shapes().items()},
                  "pred_up": torch.stack([self.draw("pred_up", il, (E, R), scale=0.05)
                                          for il in range(L)]),
                  "pred_up_b": torch.zeros((L, R), dtype=self.dtype, device=dev),
                  "pred_down": torch.stack([self.draw("pred_down", il, (R, F), scale=0.6)
                                            for il in range(L)]),
                  "pred_down_b": torch.stack([
                      self.draw("pred_down_b", il, (F,), scale=0.5, shift=-1.2)
                      for il in range(L)])}
        return {"tok_embd": self.draw("tok_embd", 0, (V, E)),
                "output_norm_w": torch.ones((E,), **ones),
                "output": self.draw("output", 0, (V, E)).T.contiguous(), "layers": layers}


def to_device(obj, device):
    """params (dicts of tensors and packed tensors) on another device"""
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj.to(device)


def events_ms(fn, reps: int) -> float:
    """Mean time of fn(i) over reps eager calls, by CUDA events: device time
    where the device is the bottleneck, host issue time where the host is."""
    import torch

    fn(0)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn(i) over reps calls captured in one CUDA graph,
    so that no host time lies between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak_flop_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(label, got, ref, tol_rel=KERNEL_TOL):
    import torch

    check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    tol = tol_rel * ref.abs().max().item()
    check(err <= tol, f"{label}: max|kernel-plain| {err:.3e} > tol {tol:.3e}")
    return err, tol


def first_decode_and_tokens(eng, prompt, n_new):
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    eng.decode_step(tok, n, cache, st)
    return eng.last_logits.float().cpu(), eng.generate(prompt, n_new)


def check_pair(label, outs):
    err = (outs[0][0] - outs[1][0]).abs().max().item()
    scale = outs[1][0].abs().max().item()
    print(f"reference ({label}): first decode logits max diff {err:.3e} "
          f"(scale {scale:.3e}); tokens {outs[0][1]} vs {outs[1][1]}")
    check(err <= 1e-4 * scale, f"{label}: logits differ")
    check(outs[0][1] == outs[1][1], f"{label}: token streams differ")


def q8_layer_gate(model, scfg, prompt, engine_cls, sampler, steps: int = 8):
    """The f32 Q8_0 FFNs held layer by layer: greedy decode through the plain
    ("gather") path, whose FFN at every layer and step also feeds its own
    input (the normed residual and the carried selection) to the kernel FFN
    (v6q, with quant_matmul_flat for the next layer's predictor). Returns
    the largest max|kernel - plain| / max|plain| over the layers and steps,
    whether every carried selection the two emitted was equal, and the
    number of FFN calls compared. No difference cascades from one layer to
    the next: each layer's inputs are the plain path's."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.sparse.ffn import make_pipelined_sparse_ffn

    cfg, dev = model.config, model.params["tok_embd"].device
    eng = engine_cls(model, max_seq=64, sampler=sampler, kv_dtype=torch.float32, sparse=scfg,
                     sparse_decode_mode="gather", sparse_preprepared=True, device=dev,
                     cuda_graph=False)
    plain, carry_init = make_pipelined_sparse_ffn(cfg, scfg, mode="gather")
    kernel, _ = make_pipelined_sparse_ffn(cfg, scfg, mode="kernel")
    rows = []

    def both(lp, x, carry, il):
        y, nxt = plain(lp, x, carry, il)
        yk, nxt_k = kernel(lp, x, carry, il)
        rows.append(((yk - y).abs().max() / y.abs().max(), torch.equal(nxt["idx"], nxt_k["idx"])))
        return y, nxt

    fwd = make_forward(cfg, ffn_fn=both, ffn_carry_init=carry_init)
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    with torch.inference_mode():
        for i in range(steps):
            logits = fwd(eng.params, torch.tensor([[tok]], device=dev),
                         torch.tensor([[n + i]], device=dev), cache)
            tok = int(logits[0, -1].argmax())
    return (torch.stack([e for e, _ in rows]).max().item(), all(eq for _, eq in rows),
            len(rows))


def phase_reference(sparse_cfg_cls, engine_cls, sampler):
    """f32 references on small inputs, kernel path against plain path."""
    import torch

    prompt = list(range(3, 40, 3))
    # bf16-layout stores (v6)
    cases = (
        ("tiny, card kernel vs CPU plain", prosparse_config(2, 256, 8, 512, 1024, 64),
         sparse_cfg_cls(group_size=128, capacity_groups=2), ("cuda", "kernel"),
         ("cpu", "kernel")),
        ("7B widths 2 layers, card kernel vs card gather",
         prosparse_config(2, 4096, 32, 11008, 32000, 1024),
         sparse_cfg_cls(group_size=128, capacity_groups=12), ("cuda", "kernel"),
         ("cuda", "gather")),  # the gather math over the v1 row stores, in f32
    )
    for label, cfg, scfg, *sides in cases:
        model = random_model(cfg, torch.float32, "cuda", SEED + 1)
        outs = []
        for dev, mode in sides:
            m = type(model)(config=cfg, params=to_device(model.params, dev))
            eng = engine_cls(m, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                             sparse=scfg, sparse_decode_mode=mode, device=dev)
            outs.append(first_decode_and_tokens(eng, prompt, 16))
            del eng, m
        check_pair(label, outs)
        del model, outs
        torch.cuda.empty_cache()
    # Q8_0 stores, packed attention and head, Q8_0 predictor stacks
    def q8_pair(model, scfg, sides):
        """Both sides' (first decode logits, tokens)."""
        outs = []
        for dev, mode in sides:
            m = type(model)(config=model.config, params=to_device(model.params, dev))
            eng = engine_cls(m, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                             sparse=scfg, sparse_decode_mode=mode,
                             sparse_preprepared=True, device=dev)
            outs.append(first_decode_and_tokens(eng, prompt, 16))
            del eng, m
        return outs

    cfg, scfg = prosparse_config(2, 512, 8, 1024, 1024, 64), sparse_cfg_cls(128, 2)
    model = Q8Weights(cfg, torch.float32, "cuda", SEED + 3).sparse_model(scfg)
    check_pair("Q8_0 tiny, card kernel vs CPU plain",
               q8_pair(model, scfg, (("cuda", "kernel"), ("cpu", "kernel"))))
    # 13B widths: every FFN layer within 1e-4 of its scale, the carried
    # selections equal, at every seed; the greedy tokens of the whole
    # forwards equal at SEED + 27; their logits printed (docstring, phase 3)
    cfg, scfg = prosparse_config(2, 5120, 40, 13824, 32000, 1280), sparse_cfg_cls(128, 16)
    label = "Q8_0 13B widths 2 layers, card kernel vs card plain"
    spread = []
    for seed in (SEED + 27, *range(SEED + 3, SEED + 10), SEED + 20, SEED + 22):
        model = Q8Weights(cfg, torch.float32, "cuda", seed).sparse_model(scfg)
        worst, same_sel, calls = q8_layer_gate(model, scfg, prompt, engine_cls, sampler)
        check(worst <= 1e-4 and same_sel,
              f"{label}, seed {seed}: an FFN layer differs by {worst:.3e} of its scale "
              f"(tolerance 1e-4) or a carried selection differs ({same_sel})")
        outs = q8_pair(model, scfg, (("cuda", "kernel"), ("cuda", "gather")))
        del model
        torch.cuda.empty_cache()
        err = (outs[0][0] - outs[1][0]).abs().max().item() / outs[1][0].abs().max().item()
        same_toks = outs[0][1] == outs[1][1]
        if seed == SEED + 27:
            print(f"reference ({label}): tokens {outs[0][1]} vs {outs[1][1]}")
            check(same_toks, f"{label}: token streams differ")
        spread.append((seed, worst, calls, err, same_toks))
    print(f"reference ({label}), per seed (seed, worst FFN layer max diff / scale, FFN calls "
          f"compared, first decode logits max diff / scale, tokens equal): {spread}")


def rows_sets(gen, n_sets, N, C, ng, L, one_layer=False):
    """n_sets random (N, C) row-id sets into a flat (L*ng, ...) store: C
    distinct groups of one random layer per token (one_layer: the same
    layer for every token of a set, as a forward's N tokens share it)."""
    import torch

    def layer():
        return int(torch.randint(L, (1,), generator=gen, device="cuda")) * ng

    sets = []
    for _ in range(n_sets):
        il = layer() if one_layer else None
        sets.append(torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                                 + (il if one_layer else layer())
                                 for _ in range(N)]).to(torch.int32))
    return sets


def phase_v6(v6, v6_plain, flat, L, ng):
    """sparse_ffn_block_v6 against its plain version at the 7B decode
    shapes, over the model's flat stores; with the kernels one call launches
    and their spans (torch.profiler in a child process: v6_ffn alone) and
    the launch plan (splits, blocks, wave ratio, stages)."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import v6_plan

    R, E, G = flat["w_upT_flat"].shape
    C = 12
    # decode (N = 1), batched decode (4), the speculative verify (K+1 = 6)
    # and the sparse prefill of a 32-token prompt (32)
    cases = ((1, "fatrelu"), (4, "fatrelu"), (4, "relu"), (6, "fatrelu"), (32, "fatrelu"))
    per_call = kernels_per_call([["v6", N, C, E, G, "bfloat16", act] for N, act in cases],
                                spans=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    results = []
    for (N, act), kernels in zip(cases, per_call):
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 1 and "v6_ffn" in names[0], f"v6 N={N} {act}: one call launched {names}")
        gated = act != "relu"
        idx = rows_sets(gen, N_SETS, N, C, ng, L, one_layer=N > 4)
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1
        wg = flat["w_gateT_flat"] if gated else None
        kw = dict(act=act, bu_sel=bu)
        args = lambda i: (x, idx[i % N_SETS], gp, flat["w_upT_flat"], wg, flat["w_down_flat"])
        got = v6(*args(0), **kw)
        torch.cuda.synchronize()
        err, tol = compare(f"v6 N={N} {act}", got, v6_plain(*args(0), **kw))
        ms = graph_ms(lambda i: v6(*args(i), **kw), N_SETS)
        host_ms = events_ms(lambda i: v6(*args(i), **kw), 200)
        plain_ms = graph_ms(lambda i: v6_plain(*args(i), **kw), 8)
        n_proj = 3 if gated else 2
        # least work per call, averaged over the row sets: each distinct
        # selected row read once, x/gp/bu/idx read and out written once;
        # 2 flops per weight and token
        rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
        nbytes = (n_proj * rows_read * G * E * 2 + N * E * 2 + 2 * N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * n_proj * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel="sparse_ffn_block_v6", N=N, act=act, max_abs_err=err, tol=tol,
                   ms=ms, eager_call_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(names),
                   span_us=kernels, plan=v6_plan(x.device, N, C, E, G, gated=gated))
        print("kernel check:", json.dumps(row))
        results.append(row)
    # N=1 fatrelu: the decode shape; N=6 and 32: the verify and prefill shapes
    return results[0], {f"N={r['N']}": r for r in results if r["N"] in (6, 32)}


def phase_v6q(flat, L, ng, C):
    """sparse_ffn_block_v6q against its plain version at the 13B decode
    shapes, over the model's flat Q8_0 stores; with the kernels one call
    launches and their spans (torch.profiler in a child process: v6q_up
    then v6q_down) and the launch plan (column tiles, clusters, blocks,
    wave ratios)."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6q,
        sparse_ffn_block_v6q_plain,
        v6q_plan,
    )

    R, E, G = flat["qw_upT_flat"].shape
    per_call = kernels_per_call([["v6q", N, C, E, G, "bfloat16"] for N in (1, 4)], spans=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    stores = [flat[k] for k in ("qw_upT_flat", "s_upT_flat", "qw_gateT_flat",
                                "s_gateT_flat", "qw_down_flat", "s_down_flat")]
    results = []
    for N, kernels in zip((1, 4), per_call):
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 2 and "v6q_up" in names[0] and "v6q_down" in names[1],
              f"v6q N={N}: one call launched {names}")
        idx = rows_sets(gen, N_SETS, N, C, ng, L, one_layer=N > 4)
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        kw = dict(act="fatrelu")
        args = lambda i: (x, idx[i % N_SETS], gp, *stores)
        got = sparse_ffn_block_v6q(*args(0), **kw)
        torch.cuda.synchronize()
        err, tol = compare(f"v6q N={N}", got, sparse_ffn_block_v6q_plain(*args(0), **kw))
        ms = graph_ms(lambda i: sparse_ffn_block_v6q(*args(i), **kw), N_SETS)
        plain_ms = graph_ms(lambda i: sparse_ffn_block_v6q_plain(*args(i), **kw), 8)
        # each distinct selected row read once: int8 weights plus one f32
        # scale per 32 (1.125 bytes per weight), three projections
        rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
        nbytes = (3 * rows_read * G * E * 1.125 + N * E * 2 + N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * 3 * N * C * G * E, PEAK_F32_FLOP_S)
        plan = v6q_plan(x.device, N, C, E, G)
        row = dict(kernel="sparse_ffn_block_v6q", N=N, C=C, G=G, E=E, act="fatrelu",
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(names),
                   span_us=kernels, plan=plan)
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]


# Run in a child process: inside this one, after phase 4's CUDA graphs, a
# short torch.profiler window records no device activity at all.
KERNELS_PER_CALL = r"""
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from sparkinfer_tpu_torch.ops import quant_matmul as qm

gen = torch.Generator(device="cuda").manual_seed(0)
result = []
for kind, N, IN, OUT, L, xdt, *rest in json.loads(sys.argv[1]):
    ld = OUT * L
    if kind == "v6":  # N tokens, IN = C selections of 86 groups, OUT = E, L = G; rest: act
        from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v6
        w = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
             for sh in ((86, OUT, L), (86, OUT, L), (86, L, OUT))]
        if rest[0] == "relu":
            w[1] = None
        idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        bu = torch.randn((N, IN, L), generator=gen, device="cuda") * 0.1
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v6(x, idx, gp, *w, act=rest[0], bu_sel=bu)
    elif kind == "v6q":  # N tokens, IN = C selections of 108 groups, OUT = E, L = G
        from sparkinfer_tpu_torch.ops.sparse_ffn import quantize_rows_q8_0, sparse_ffn_block_v6q
        w = [t for sh in ((108, OUT, L), (108, OUT, L), (108, L, OUT))
             for t in quantize_rows_q8_0(torch.randn(sh, generator=gen, device="cuda") * 0.02)]
        idx = torch.stack([torch.randperm(108, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v6q(x, idx, gp, *w, act="fatrelu")
    elif kind == "rows":  # N tokens, IN = C selections of 86 groups, OUT = E, L = G; rest: wrapper
        from sparkinfer_tpu_torch.ops import sparse_ffn as sf
        w = (torch.randn((3 * 86, L, OUT), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        bu = torch.randn((N, IN, L), generator=gen, device="cuda") * 0.1
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        if rest[0] == "sparse_ffn_block_v2":
            fn = lambda: sf.sparse_ffn_block_v2(x, idx, gp, w, act="fatrelu", gated=True, R=86,
                                                bu_sel=bu)
        elif rest[0] == "sparse_ffn_block_v4":
            il = sf.interleave_rows(w[:86], w[86:172], w[172:])
            fn = lambda: sf.sparse_ffn_block_v4(x, idx, gp, il, act="fatrelu", gated=True,
                                                bu_sel=bu)
        else:
            fn = lambda: getattr(sf, rest[0])(x, idx, gp, w[:86], w[86:172], w[172:],
                                              act="fatrelu", bu_sel=bu)
    elif kind == "v7u":  # N tokens, IN = Cu union rows, OUT = E, L = G
        from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v7u
        w = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
             for sh in ((IN + 3, OUT, L), (IN + 3, OUT, L), (IN + 3, L, OUT))]
        union = torch.randperm(IN + 3, generator=gen, device="cuda")[:IN].to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v7u(x, union, gp, *w, act="fatrelu")
    else:
        if kind == "q8_0":
            q = torch.randint(-127, 128, (IN, ld), generator=gen, device="cuda").to(torch.int8)
        else:
            q = torch.randint(0, 256, (IN // 2, ld), generator=gen, device="cuda").to(torch.uint8)
        s = torch.rand((IN // 32, ld), generator=gen, device="cuda") * 0.01
        x = torch.randn((N, IN), generator=gen, device="cuda").to(getattr(torch, xdt))
        if L == 1:
            fn = lambda: qm.quant_matmul_2d(x, q, s, kind=kind)
        else:
            fn = lambda: qm.quant_matmul_flat(x, q, s, L - 1, kind=kind, out_dim=OUT)
    fn()
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        marker.fill_(1.0)
        fn()
        marker.fill_(2.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    result.append([[e.name[:120], 1, e.time_range.start, e.time_range.end] for e in kernels])
    del fn
    torch.cuda.empty_cache()
print(json.dumps(result))
"""


def kernels_per_call(specs, names: bool = False, spans: bool = False) -> list:
    """Device kernels that one call launches, for each (kind, N, IN, OUT,
    layers, x dtype) of a quant matmul (layers > 1: quant_matmul_flat on the
    last layer's stripe), ("v7u", B, Cu, E, G, x dtype) of the union FFN
    over bf16 stores, ("v6", N, C, E, G, x dtype, act) of the decode FFN
    over 86 groups of bf16 stores with an up bias, ("rows", N, C, E, G, x
    dtype, wrapper) of a row-store wrapper (v1-v5) over 86 groups of bf16
    stores with an up bias, or ("v6q", N, C, E, G, x dtype) of the Q8_0 FFN
    over 108 groups, by torch.profiler in a child
    process over random stores of
    those shapes. The call lies between two marker kernels (fill_), and the
    window opens and closes with a pause; a window that misses a marker
    fails. names: the kernels' names in launch order; spans: their [name,
    span us] pairs; else their count."""
    proc = subprocess.run([sys.executable, "-c", KERNELS_PER_CALL, json.dumps(specs)],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"kernels-per-call profile failed: {proc.stderr[-2000:]}")
    counts = []
    for spec, rows in zip(specs, json.loads(proc.stdout.strip().splitlines()[-1])):
        fills = sum(c for k, c, *_ in rows if "FillFunctor" in k)
        check(fills == 2, f"{spec}: profile window recorded {fills} of its 2 markers: {rows}")
        calls = [r for r in rows if "FillFunctor" not in r[0]]
        kernels = [r[0] for r in calls]
        # each kernel's span in this one profiled call (us); a dependent
        # launch's span includes its wait for the kernel before it
        span_us = [round(end - start, 3) for _, _, start, end in calls]
        total = round(calls[-1][3] - calls[0][2], 3) if calls else 0
        print(f"kernels per call {spec}: {len(kernels)} {[k[:60] for k in kernels]} "
              f"span us {span_us}, first start to last end {total}")
        if spans:
            counts.append([[k[:60], us] for k, us in zip(kernels, span_us)] + [["all", total]])
        else:
            counts.append(kernels if names else len(kernels))
    return counts


def qmm_row(label, kernel, plain, stores, x, kind, per_call, flat_out=None):
    """Time one quant matmul over its list of cold (packed, scales[, il])
    stores: kernel, plain version and the bf16 torch.matmul of the
    dequantized weights (16 of them, more bytes than L2 holds). per_call:
    the kernels one call launches (kernels_per_call), which must be 1:
    qmm_decode at N <= 4, qmm_prefill above."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.ops.quant_matmul import dequant_bf16

    n = len(stores)
    N, IN = x.shape
    if flat_out is None:
        call = lambda f, i: f(x, *stores[i % n], kind=kind)
        OUT = stores[0][0].shape[1]
    else:
        call = lambda f, i: f(x, *stores[i % n], kind=kind, out_dim=flat_out)
        OUT = flat_out
    got = call(kernel, 0)
    torch.cuda.synchronize()
    err, tol = compare(label, got, call(plain, 0))
    check(per_call == 1, f"{label}: {per_call} kernels in one call")
    ms = graph_ms(lambda i: call(kernel, i), N_SETS)
    plain_ms = graph_ms(lambda i: call(plain, i), 8)

    def weight(i):
        q, s, *il = stores[i % n]
        if il:
            c0 = il[0] * OUT
            q, s = q[:, c0:c0 + OUT], s[:, c0:c0 + OUT]
        return dequant_bf16(q, s, kind)

    dense = [weight(i) for i in range(min(n, 16))]
    xb = x.to(torch.bfloat16)
    library_ms = graph_ms(lambda i: torch.matmul(xb, dense[i % len(dense)]), N_SETS)
    del dense
    div = 2 if kind == "q4_0" else 1
    nbytes = IN // div * OUT + IN // 32 * OUT * 4 + N * IN * x.element_size() + N * OUT * 4
    bound_ms, by = bound(nbytes, 2 * N * IN * OUT, PEAK_BF16_FLOP_S)
    row = dict(kernel=label.split()[0], shape=label, max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
               GB_s=nbytes / (ms * 1e-3) / 1e9, TFLOP_s=2 * N * IN * OUT / (ms * 1e-3) / 1e12,
               launches_per_call=per_call,
               plan=qm.launch_plan(x.device, N, IN, OUT, kind))  # tile, K splits, waves
    print("kernel check:", json.dumps(row))
    torch.cuda.empty_cache()
    return row


def phase_quant_matmul(params):
    """quant_matmul_2d and quant_matmul_flat against their plain versions at
    the 13B shapes: the model's own stores where it has them (up to 64 of
    its wq and wk matrices, the L layers of each predictor stack, its
    head), 64 random Q4_0 stores."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    lay, flat = params["layers"], params["sparse_flat"]
    E = lay["wq"].shape[-2]
    q8 = [(t.q[il], t.s[il]) for t in (lay["wq"], lay["wk"]) for il in range(t.q.shape[0])]
    q8 = q8[:N_SETS]
    q4q = torch.randint(0, 256, (N_SETS, E // 2, E), generator=gen, device="cuda",
                        dtype=torch.uint8)
    q4s = torch.rand((N_SETS, E // 32, E), generator=gen, device="cuda") * 0.002
    q4 = [(q4q[i], q4s[i]) for i in range(N_SETS)]
    V = params["output"].q.shape[-1]
    flat_specs = [(key, N, flat[key].shape[0], flat[key].out_dim)
                  for key, N in (("pred_up_qt", 1), ("pred_down_qt", 1), ("pred_down_qt", 4),
                                 ("pred_up_qt", 32), ("pred_down_qt", 32))]
    specs = ([("q8_0", N, E, E, 1, "bfloat16") for N in (1, 4, 8, 32, 512)]
             + [("q4_0", N, E, E, 1, "bfloat16") for N in (1, 32)]
             + [("q8_0", N, E, V, 1, "bfloat16") for N in (1, 32)]
             + [("q8_0", N, IN, OUT, 3, "float32") for _, N, IN, OUT in flat_specs])
    per_call = dict(zip(specs, kernels_per_call(specs)))
    rows = []
    # decode at B = 1 and 4; a batch of 8; a 32-token prefill; a 512-token chunk
    for N in (1, 4, 8, 32, 512):
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(qmm_row(f"quant_matmul_2d q8_0 {E}x{E} N={N}", qm.quant_matmul_2d,
                            qm.quant_matmul_2d_plain, q8, x, "q8_0",
                            per_call[("q8_0", N, E, E, 1, "bfloat16")]))
        if N in (1, 32):
            rows.append(qmm_row(f"quant_matmul_2d q4_0 {E}x{E} N={N}", qm.quant_matmul_2d,
                                qm.quant_matmul_2d_plain, q4, x, "q4_0",
                                per_call[("q4_0", N, E, E, 1, "bfloat16")]))
    del q4, q4q, q4s
    head = params["output"]
    for N in (1, 32):
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(qmm_row(f"quant_matmul_2d q8_0 head {E}x{V} N={N}",
                            qm.quant_matmul_2d, qm.quant_matmul_2d_plain, [(head.q, head.s)],
                            x, "q8_0", per_call[("q8_0", N, E, V, 1, "bfloat16")]))
    flat_rows = []
    for key, N, IN, OUT in flat_specs:
        t = flat[key]
        L = t.q.shape[1] // OUT
        x = torch.randn((N, IN), generator=gen, device="cuda")  # the predictor's f32 input
        flat_rows.append(qmm_row(
            f"quant_matmul_flat q8_0 {IN}x{OUT} N={N}", qm.quant_matmul_flat,
            qm.quant_matmul_flat_plain, [(t.q, t.s, il) for il in range(L)], x, "q8_0",
            per_call[("q8_0", N, IN, OUT, 3, "float32")], flat_out=OUT))
    return rows[0], flat_rows[1]  # the main path's attention and pred_down shapes


def phase_serving_reference(sparse_cfg_cls, sampler):
    """f32 references of the serving paths, kernel against plain: the
    Scheduler on a tiny model (v1) on the card against the CPU, and the
    union FFN (v7u) of a 2-layer 7B-width model against "gather_union"."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block, sparse_ffn_block_v7u
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler
    from sparkinfer_tpu_torch.sparse import ffn as sffn
    from sparkinfer_tpu_torch.sparse.predictor import predict_activations

    cfg = prosparse_config(2, 256, 8, 512, 1024, 64)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=2)
    model = random_model(cfg, torch.float32, "cuda", SEED + 6)
    prompts = [list(range(3 + i, 40, 2 + i)) for i in range(4)]
    outs = []
    for dev in ("cuda", "cpu"):
        m = type(model)(config=cfg, params=to_device(model.params, dev))
        sched = Scheduler(m, n_slots=2, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                          sparse=scfg, sparse_batch_max=2, device=dev)
        sparse_ffn_block.launches = 0
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=12)) for p in prompts]
        sched.step()  # admits two requests and decodes them once
        first = sched.last_logits.float().cpu()
        sched.run_until_idle()
        toks = [r.tokens() for r in reqs]
        check(all(len(t) == 12 for t in toks), f"Scheduler on {dev}: short streams {toks}")
        if dev == "cuda":  # each tick, and the graph's warm-up
            runs = sched.metrics["n_decode_steps"] + sched.graphs.captures
            check(sparse_ffn_block.launches == cfg.n_layer * runs,
                  f"v1 launched {sparse_ffn_block.launches} times in {runs} tick forwards")
        outs.append((first, toks))
        del sched, m
    check_pair("Scheduler tiny, 4 requests on 2 slots, card v1 kernel vs CPU plain", outs)

    cfg = prosparse_config(2, 4096, 32, 11008, 32000, 1024)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.float32, "cuda", SEED + 1)
    params = sffn.prepare_pipelined_params(model.params, cfg, scfg, layout="v6")
    F, E, B = cfg.n_ff, cfg.n_embd, 8
    ng, G = scfg.n_groups(F), scfg.group_size
    lp = {k: v[1] for k, v in params["layers"].items()} | dict(params["sparse_flat"], flat_il=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((1, B, E), generator=gen, device="cuda")
    probs = predict_activations(lp, x[0])
    idx = sffn.select_groups(probs, scfg, F)
    carry = {"idx": idx, "gp_sel": torch.gather(probs.reshape(B, ng, G), 1,
                                                idx.long()[..., None].expand(-1, -1, G))}
    n_union = len(torch.unique(idx))

    def union_out(mode, union_groups=None):
        ffn, _ = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode=mode, union_groups=union_groups)
        return ffn(lp, x, carry, 1)[0]

    for label, ugroups, ref_mode in (("Cu=48, truncated", None, "gather_union"),
                                     (f"Cu={ng}, the whole union", ng, "gather")):
        got = union_out("kernel_union", ugroups)
        ref = union_out(ref_mode, ugroups)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"reference (union FFN, 7B widths, B={B}, {n_union} groups selected, {label}): "
              f"kernel_union vs {ref_mode} max diff {err:.3e} (scale {scale:.3e})")
        check(bool(torch.isfinite(got).all()) and err <= UNION_TOL * scale,
              f"union FFN {label}: {err:.3e} > {UNION_TOL} of {scale:.3e}")
    ffn_u, ci_u = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel_union")
    toks = torch.randint(cfg.n_vocab, (B, 4), generator=gen, device="cuda")
    pos = torch.arange(4, device="cuda")[None].expand(B, 4)
    sparse_ffn_block_v7u.launches = 0
    logits = make_forward(cfg, ffn_fn=ffn_u, ffn_carry_init=ci_u)(
        params, toks, pos, init_cache(cfg, B, 16, torch.float32, "cuda"))
    check(bool(torch.isfinite(logits).all()), "union forward: non-finite logits")
    check(sparse_ffn_block_v7u.launches == cfg.n_layer, "union forward: v7u launches")
    print(f"reference (union forward, B={B}, 4 tokens each): logits finite, "
          f"v7u launched {cfg.n_layer} times")
    del model, params, lp
    torch.cuda.empty_cache()


ROW_WRAPPERS = ("sparse_ffn_block", "sparse_ffn_block_v2", "sparse_ffn_block_v3",
                "sparse_ffn_block_v4", "sparse_ffn_block_v5")


def row_kernels_per_call(C, E, G) -> dict:
    """{(wrapper, N): [[kernel, span us], ..., ["all", us]]} of one call of
    each row-store wrapper at N = 1 and 4, from one child process."""
    specs = [["rows", N, C, E, G, "bfloat16", name] for name in ROW_WRAPPERS for N in (1, 4)]
    spans = kernels_per_call(specs, spans=True)
    return {(spec[6], spec[1]): kernels for spec, kernels in zip(specs, spans)}


def row_kernel_rows(name, fn, plain, stores_of, layers, ng, C, seed, bias, per_call):
    """A row-store kernel (v1, v2, v3, v4, v5) against its plain version at
    the 7B decode shapes, N = 1 and 4, fatrelu: each call takes C groups of
    one random layer of `layers` per token, stores_of(il) giving that
    layer's store arguments and keyword arguments; bias adds an up bias.
    per_call: row_kernels_per_call's spans, which must be v1_ffn alone."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import v1_plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    stores, extra = stores_of(layers[0])
    G, E = stores[0].shape[-2:]
    results = []
    for N in (1, 4):
        sets = [(layers[int(torch.randint(len(layers), (1,), generator=gen, device="cuda"))],
                 torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                              for _ in range(N)]).to(torch.int32)) for _ in range(N_SETS)]
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1 if bias else None

        def call(f, i):
            il, idx = sets[i % N_SETS]
            stores, extra = stores_of(il)
            return f(x, idx, gp, *stores, act="fatrelu", bu_sel=bu, **extra)

        kernels = per_call[(name, N)]
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 1 and "v1_ffn" in names[0], f"{name} N={N}: one call launched {names}")
        got = call(fn, 0)
        torch.cuda.synchronize()
        err, tol = compare(f"{name} N={N}", got, call(plain, 0))
        ms = graph_ms(lambda i: call(fn, i), N_SETS)
        host_ms = events_ms(lambda i: call(fn, i), 200)
        plain_ms = graph_ms(lambda i: call(plain, i), 8)
        # each distinct selected row of each projection read once; x, gp,
        # (bu,) idx read and out written once; 2 flops per weight and token
        rows_read = sum(len(torch.unique(idx)) for _, idx in sets) / N_SETS
        nbytes = (3 * rows_read * G * E * 2 + N * E * 2 + (2 if bias else 1) * N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * 3 * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel=name, N=N, C=C, G=G, E=E, act="fatrelu", up_bias=bias,
                   max_abs_err=err, tol=tol, ms=ms, eager_call_ms=host_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   rows_read=rows_read, GB_s=nbytes / (ms * 1e-3) / 1e9,
                   launches_per_call=len(names), span_us=kernels,
                   plan=v1_plan(x.device, N, C, E, G))
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]


def phase_rows(rows, C):
    """v1, v3, v5 over the Scheduler's row stores (L, ng, G, E), and v4 over
    their interleave (L, ng, P, G, E), every layer's rows: v1 without a
    bias, at the draws of its earlier timings, the others with an up bias.
    Returns {kernel: N=1 row} and the five wrappers' kernels per call."""
    import torch

    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    wu, wg, wd = rows["w_up_rows"], rows["w_gate_rows"], rows["w_down_rows"]
    L, ng, G, E = wu.shape
    layers = list(range(L))
    per_call = row_kernels_per_call(C, E, G)

    def three(il):
        return (wu[il], wg[il], wd[il]), {}

    out = {}
    for seed, name, bias in ((8, "sparse_ffn_block", False), (12, "sparse_ffn_block_v3", True),
                             (13, "sparse_ffn_block_v5", True)):
        out[name] = row_kernel_rows(name, getattr(sf, name), getattr(sf, name + "_plain"),
                                    three, layers, ng, C, SEED + seed, bias, per_call)
    il_store = sf.interleave_rows(wu, wg, wd)  # (L, ng, 3, G, E): 8.7 GB at 7B bf16
    out["sparse_ffn_block_v4"] = row_kernel_rows(
        "sparse_ffn_block_v4", sf.sparse_ffn_block_v4, sf.sparse_ffn_block_v4_plain,
        lambda il: ((il_store[il],), {"gated": True}), layers, ng, C, SEED + 14, True, per_call)
    del il_store
    torch.cuda.empty_cache()
    return out, per_call


def v7u_row(label, stores, unions, B, Cu, C, gen, per_call):
    """sparse_ffn_block_v7u against its plain version over the flat stores,
    timed over the union sets (cold): bf16 x, each token having selected C
    of the Cu groups; with the launches of one call (per_call, which must be
    the up and down kernels) and the launch plan."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v7u,
        sparse_ffn_block_v7u_plain,
        v7u_plan,
    )

    R, E, G = stores[0].shape
    x = torch.randn((B, E), generator=gen, device="cuda").to(torch.bfloat16)
    sel = torch.rand((B, Cu), generator=gen, device="cuda").argsort(-1) < C
    gp = torch.rand((B, Cu, G), generator=gen, device="cuda") * sel[..., None]
    kw = dict(act="fatrelu")
    n = len(unions)
    args = lambda i: (x, unions[i % n], gp, *stores)  # noqa: E731
    got = sparse_ffn_block_v7u(*args(0), **kw)
    torch.cuda.synchronize()
    err, tol = compare(f"v7u {label}", got, sparse_ffn_block_v7u_plain(*args(0), **kw))
    check(len(per_call) == 2 and "v7u_up" in per_call[0] and "v7u_down" in per_call[1],
          f"v7u {label}: one call launched {per_call}")
    ms = graph_ms(lambda i: sparse_ffn_block_v7u(*args(i), **kw), N_SETS)
    plain_ms = graph_ms(lambda i: sparse_ffn_block_v7u_plain(*args(i), **kw), 8)
    # each union row of each projection read once, whatever B is; x, gp,
    # the union and out once; 2 flops per weight and token on the bf16
    # tensor cores
    nbytes = 3 * Cu * G * E * 2 + B * E * 2 + B * Cu * G * 4 + Cu * 4 + B * E * 4
    bound_ms, by = bound(nbytes, 2 * 3 * B * Cu * G * E, PEAK_BF16_FLOP_S)
    plan = v7u_plan(x.device, B, Cu, E, G)
    row = dict(kernel="sparse_ffn_block_v7u", shape=label, B=B, Cu=Cu, G=G, E=E, R=R,
               act="fatrelu", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
               GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(per_call),
               blocks={"up": plan["up"]["blocks"], "down": plan["down"]["blocks"]},
               cluster={"up": plan["up"]["cluster"], "down": plan["down"]["cluster"]},
               wave_ratio={"up": plan["up"]["wave_ratio"], "down": plan["down"]["wave_ratio"]})
    print("kernel check:", json.dumps(row))
    return row


def phase_v7u(flat, L, ng, C=12):
    """sparse_ffn_block_v7u against its plain version at the 7B batched
    decode shapes, B = 1, 4, 8 and Cu = 48, over the model's flat stores
    (each call's union is Cu groups of one random layer), and at 13B widths,
    B = 8, Cu = 64 of 108 groups, E = 5120, over one layer's random bf16
    stores (R = 108, 252 MB). Returns the B = 8, Cu = 48 row."""
    import torch

    specs = [["v7u", B, 48, 4096, 128, "bfloat16"] for B in (1, 4, 8)]
    specs.append(["v7u", 8, 64, 5120, 128, "bfloat16"])
    per_call = kernels_per_call(specs, names=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    stores = [flat[k] for k in ("w_upT_flat", "w_gateT_flat", "w_down_flat")]
    unions = [(torch.randperm(ng, generator=gen, device="cuda")[:48]
               + int(torch.randint(L, (1,), generator=gen, device="cuda")) * ng).to(torch.int32)
              for _ in range(N_SETS)]
    rows = {B: v7u_row(f"7B B={B} Cu=48", stores, unions, B, 48, C, gen, names)
            for B, names in zip((1, 4, 8), per_call)}
    E13, G, R13 = 5120, 128, 108
    stores13 = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
                for shape in ((R13, E13, G), (R13, E13, G), (R13, G, E13))]
    unions13 = [torch.randperm(R13, generator=gen, device="cuda")[:64].to(torch.int32)
                for _ in range(N_SETS)]
    v7u_row("13B B=8 Cu=64", stores13, unions13, 8, 64, 16, gen, per_call[3])
    del stores13
    torch.cuda.empty_cache()
    return rows[8]


def scheduler_path(sched, prompts, n_new, label="7B bf16"):
    """The Scheduler's main path: every request served, every tick's
    logits finite, v1 launched n_layer times per tick forward (each replay
    of the tick's graph, and its warm-up) and no other kernel (counts set
    to 0 just before, read just after)."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    captures = sched.graphs.captures
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    while sched.step():
        check(bool(torch.isfinite(sched.last_logits).all()), "Scheduler: non-finite logits")
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    toks = [r.tokens() for r in reqs]
    check(all(len(t) == n_new for t in toks), f"Scheduler: short streams {toks}")
    m = sched.metrics_snapshot()
    ticks = m["n_decode_steps"]
    warm = sched.graphs.captures - captures
    L = sched.cfg.n_layer
    for name, n in launches.items():
        want = L * (ticks + warm) if name == "sparse_ffn_block" else 0
        check(n == want, f"Scheduler: {name} launched {n} times, want {want}")
    check(m["n_dense_steps"] == 0, "Scheduler: a tick took the dense step")
    decode_tps = (m["n_tokens_generated"] - m["n_requests"]) / m["t_decode_s"]
    print(f"main path Scheduler {label} sparse: {len(prompts)} requests on {sched.n_slots} "
          f"slots, {ticks} ticks, decode {decode_tps:.2f} tok/s aggregate "
          f"({1e3 * m['t_decode_s'] / ticks:.2f} ms/tick), prefill {m['prefill_tps']:.1f} "
          f"tok/s, wall {wall:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {json.dumps(launches)} (as expected: {ticks} ticks, {warm} warm-up)")
    print(f"main path Scheduler tokens (first 2): {toks[:2]}")
    # a profile of a few ticks with every slot running: v1's device time
    # and launches (one kernel a call, L a decode tick), the f32 copies'
    for p in prompts[:sched.n_slots]:
        sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
    sched.step()
    ticks0 = sched.metrics_snapshot()["n_decode_steps"]
    rows, _ = profile_steps(f"Scheduler ticks ({sched.n_slots} slots)", sched.step, 6)
    ticks = sched.metrics_snapshot()["n_decode_steps"] - ticks0
    v1_prof = [(k, ms, n) for k, ms, n in rows if "v1_" in k or "sum_row_chunks" in k]
    copies = [(k, ms, n) for k, ms, n in rows if "direct_copy_kernel" in k]
    print("profile: v1 in the Scheduler's ticks:", json.dumps({
        "decode_ticks": ticks,
        "device_ms_per_tick": sum(ms for _, ms, _ in v1_prof) / ticks,
        "launches_per_tick": sum(n for _, _, n in v1_prof) / ticks,
        "kernels": {k[:60]: [ms / ticks, n / ticks] for k, ms, n in v1_prof},
        "f32_copies": {"device_ms_per_tick": sum(ms for _, ms, _ in copies) / ticks,
                       "launches_per_tick": sum(n for _, _, n in copies) / ticks}}))
    check(ticks > 0 and all("v1_ffn" in k for k, _, _ in v1_prof)
          and sum(n for _, _, n in v1_prof) == L * ticks,
          f"the profiled ticks launched {v1_prof} v1 kernels over {ticks} ticks, want {L} a tick")
    sched.run_until_idle()
    return launches["sparse_ffn_block"]


def phase_batched(cfg, scfg, dense_params, flat_params, row_params, steps: int = 8,
                  trials: int = 3):
    """Aggregate decode tok/s at B in BATCHES (bench.py batch): dense,
    masked-dense (the Scheduler's fallback), per-token v6, union v7u and
    the Scheduler's v1 step, each decoding greedily on from its own 32-token
    dense prefill. The Scheduler's two ticks (GRAPHED: masked-dense and v1)
    replay a CUDA graph of their forward, as the Scheduler runs them; dense,
    v6 and v7u stay eager (the batched Engine decode has no graph) and run
    only up to EAGER_BATCH_MAX. Every row of a tick is live, as all n_slots
    rows of a Scheduler tick are computed, idle ones included. The modes
    run in turns, `trials` runs of `steps` steps each, and the best run
    counts (the host's clock varies run to run); every run's launch counts
    are checked, a graph's warm-up included. After each B, the device span
    of one replay of each graphed tick (CUDA events around back-to-back
    replays). Returns the v7u launches of a timed run at B = 8, the
    crossover: the largest B at which the graphed v1 tick beats the graphed
    masked-dense tick, 0 where it never does, and the table's rows."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.graphs import StepGraph
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse import ffn as sffn
    from sparkinfer_tpu_torch.sparse.config import sparse_batch_crossover

    L = cfg.n_layer
    ffn6, ci6 = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel")
    ffnu, ciu = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel_union")
    all_modes = {
        "dense": (make_forward(cfg), dense_params, None),
        "masked_dense": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "dense")),
                         row_params, None),
        "v6": (make_forward(cfg, ffn_fn=ffn6, ffn_carry_init=ci6), flat_params,
               "sparse_ffn_block_v6"),
        "v7u": (make_forward(cfg, ffn_fn=ffnu, ffn_carry_init=ciu), flat_params,
                "sparse_ffn_block_v7u"),
        "v1": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "kernel")),
               row_params, "sparse_ffn_block"),
    }
    prefill = make_forward(cfg, fresh_prefill=True)
    wrappers = kernel_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    table = []
    for B in BATCHES:
        prompt = torch.randint(cfg.n_vocab, (B, 32), generator=gen, device="cuda")
        pos = torch.arange(32, device="cuda")[None].expand(B, 32)
        caches, toks, ticks = {}, {}, {}
        at_b = {name: m for name, m in all_modes.items()
                if B <= EAGER_BATCH_MAX or name in GRAPHED}
        for name in at_b:  # each mode decodes on from its own 32-token prefill
            caches[name] = init_cache(cfg, B, 32 + 2 + trials * steps + PROFILE_STEPS,
                                      torch.bfloat16, "cuda")
            toks[name] = prefill(dense_params, prompt, pos, caches[name])[:, -1].argmax(
                -1, keepdim=True)
        for name in GRAPHED:  # the tick's forward over static buffers, as the Scheduler's
            fwd, params, _ = at_b[name]
            ticks[name] = StepGraph(
                lambda t, p, fwd=fwd, params=params, cache=caches[name]:
                fwd(params, t, p, cache)[:, -1],
                B, torch.device("cuda"), capture=True, label=f"batched {name} tick")
        n_past = 32
        best = dict.fromkeys(at_b, float("inf"))
        for trial in range(trials + 1):  # the modes in turns; trial 0 warms up
            n = 1 if trial == 0 else steps
            for name, (fwd, params, kname) in at_b.items():
                tick = ticks.get(name)
                warm = int(tick is not None and tick.graph is None)
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s in range(n):
                    if tick is None:
                        logits = fwd(params, toks[name],
                                     torch.full((B, 1), n_past + s, device="cuda"),
                                     caches[name])[:, -1]
                    else:
                        tick.tokens.copy_(toks[name])
                        tick.positions.fill_(n_past + s)
                        logits = tick.run()
                    toks[name] = logits.argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check(bool(torch.isfinite(logits).all()), f"batched {name} B={B}: non-finite")
                for wname, w in wrappers.items():
                    want = L * (n + warm) if wname == kname else 0
                    check(w.launches == want,
                          f"batched {name} B={B}: {wname} launched {w.launches}, want {want}")
                if trial > 0:
                    best[name] = min(best[name], dt / n)
            n_past += n
        row = {"B": B, **{name: B / t for name, t in best.items()},
               "ms_per_step": {name: round(1e3 * t, 3) for name, t in best.items()},
               "graphed": list(GRAPHED),
               "graph_device_ms": {name: round(replay_times(tick)["replay_span_ms"], 3)
                                   for name, tick in ticks.items()}}
        print("batched decode (aggregate tok/s, best of "
              f"{trials} x {steps} steps):", json.dumps(
                  {k: (round(v, 2) if isinstance(v, float) else v) for k, v in row.items()}))
        table.append(row)
        if B == EAGER_BATCH_MAX:  # v7u's share of a profiled batched step's device time
            l_v7u = L * steps
            fwd, params, _ = at_b["v7u"]
            at = {"n": n_past}

            def step():
                toks["v7u"] = fwd(params, toks["v7u"], torch.full((B, 1), at["n"], device="cuda"),
                                  caches["v7u"])[:, -1].argmax(-1, keepdim=True)
                at["n"] += 1

            rows, wall_ms = profile_steps(f"v7u batched decode steps (B={B})", step, PROFILE_STEPS)
            v7u = [(k, ms, n) for k, ms, n in rows if "v7u_" in k]
            device_ms = sum(r[1] for r in rows)
            check(sum(r[2] for r in v7u) == 2 * L * PROFILE_STEPS,
                  f"profiled v7u step: {v7u} (want {2 * L} v7u kernels a step)")
            print("v7u step profile:", json.dumps({
                "B": B, "steps": PROFILE_STEPS, "device_ms_per_step": device_ms / PROFILE_STEPS,
                "wall_ms_per_step": wall_ms / PROFILE_STEPS,
                "v7u_ms_per_step": sum(r[1] for r in v7u) / PROFILE_STEPS,
                "v7u_share_of_device_time": sum(r[1] for r in v7u) / device_ms,
                "v7u_kernels": {k[:40]: [ms / PROFILE_STEPS, n // PROFILE_STEPS]
                                for k, ms, n in v7u}}))
        del caches, ticks
        torch.cuda.empty_cache()
    crossover = max([r["B"] for r in table if r["v1"] > r["masked_dense"]], default=0)
    print(f"batched decode: the graphed v1 tick beats the graphed masked-dense tick up to "
          f"B={crossover} (sparse_batch_crossover({cfg.n_ff}) gives "
          f"{sparse_batch_crossover(cfg.n_ff)})")
    return l_v7u, crossover, table


def greedy_forward(fwd, params, cfg, prompt, n_new):
    """Greedy decode through a bare forward, as sparkinfer-bench drives one:
    the prompt through fwd, then n_new steps. Returns (the first decode
    step's logits on the CPU, the tokens, the number of forwards)."""
    import torch

    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    cache = init_cache(cfg, 1, len(prompt) + n_new + 1, torch.float32, "cuda")
    logits = fwd(params, torch.tensor([prompt], device="cuda"),
                 torch.arange(len(prompt), device="cuda")[None], cache)[:, -1]
    toks, first = [], None
    for i in range(n_new):
        toks.append(int(logits.argmax(-1)))
        logits = fwd(params, torch.tensor([[toks[-1]]], device="cuda"),
                     torch.tensor([[len(prompt) + i]], device="cuda"), cache)[:, -1]
        first = logits.float().cpu() if first is None else first
    return first, toks, 1 + n_new


def set_kernel_v2(on: bool):
    import os

    if on:
        os.environ["SPIF_KERNEL_V2"] = "1"
    else:
        os.environ.pop("SPIF_KERNEL_V2", None)


def phase_bench_reference(sparse_cfg_cls):
    """f32 reference of sparkinfer-bench's sparse decode at 7B widths cut to
    2 layers: the v2 path (SPIF_KERNEL_V2 over w_all_rows), the v1 path and
    the "gather" math over the row stores, all on the card, give equal
    greedy tokens and first-decode logits within 1e-4 of their scale (in
    f32 the hidden's rounding to the store dtype is exact); each kernel
    path launches its kernel n_layer times per forward and no other."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.sparse import ffn as sffn

    cfg = prosparse_config(2, 4096, 32, 11008, 32000, 1024)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.float32, "cuda", SEED + 15)
    wrappers = kernel_wrappers()
    set_kernel_v2(True)
    try:
        params = sffn.prepare_pipelined_params(model.params, cfg, scfg)
        outs = {}
        for label, mode, v2, kname in (("v2", "kernel", True, "sparse_ffn_block_v2"),
                                       ("v1", "kernel", False, "sparse_ffn_block"),
                                       ("gather", "gather", False, None)):
            set_kernel_v2(v2)
            ffn, ci = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode=mode)
            for w in wrappers.values():
                w.launches = 0
            with torch.inference_mode():
                first, toks, n_fwd = greedy_forward(
                    make_forward(cfg, ffn_fn=ffn, ffn_carry_init=ci), params, cfg,
                    list(range(3, 40, 3)), 16)
            for name, w in wrappers.items():
                want = cfg.n_layer * n_fwd if name == kname else 0
                check(w.launches == want,
                      f"bench reference {label}: {name} launched {w.launches}, want {want}")
            outs[label] = (first, toks)
    finally:
        set_kernel_v2(False)
    for label in ("v2", "v1"):
        check_pair(f"bench path 7B widths 2 layers, card {label} kernel vs card gather",
                   [outs[label], outs["gather"]])
    del model, params
    torch.cuda.empty_cache()


def phase_bench(model, scfg, tg=16, reps=3, ctx=1024):
    """sparkinfer-bench's decode rows (tools.bench_matrix.bench_tg) on the
    7B-width model: a 512-token seed prefill into a ctx-token cache, one
    warm-up step, the median of `reps` runs of `tg` steps, at B = 1 and 4,
    for three paths: dense; sparse over the v1 row layout (v1 n_layer times
    per forward, no other kernel); sparse with SPIF_KERNEL_V2 (v2 n_layer
    times per forward, no other kernel). Every count is set to 0 just
    before each bench_tg call and read just after. Returns the v2 launches
    of the v2 path's runs."""
    import torch

    from sparkinfer_tpu_torch.tools.bench_matrix import bench_tg

    L = model.config.n_layer
    n_fwd = 2 + reps * tg  # the prefill, the warm-up step, the timed steps
    wrappers = kernel_wrappers()
    v2_launches = 0
    try:
        for path, sparse, v2, kname in (("dense", None, False, None),
                                        ("sparse v1", scfg, False, "sparse_ffn_block"),
                                        ("sparse v2", scfg, True, "sparse_ffn_block_v2")):
            set_kernel_v2(v2)
            for B in (1, 4):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for w in wrappers.values():
                    w.launches = 0
                tps = bench_tg(model, tg, reps, torch.bfloat16, ctx=ctx, batch=B, sparse=sparse)
                launches = {name: w.launches for name, w in wrappers.items()}
                for name, n in launches.items():
                    want = L * n_fwd if name == kname else 0
                    check(n == want, f"bench {path} B={B}: {name} launched {n}, want {want}")
                v2_launches += launches["sparse_ffn_block_v2"]
                print("bench path (sparkinfer-bench tg, 7B bf16):", json.dumps({
                    "path": path, "B": B, "ctx": ctx, "tg": tg, "reps": reps, "tok_s": tps,
                    "ms_per_step": 1e3 * B / tps,
                    "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: v for k, v in launches.items() if v}}))
    finally:
        set_kernel_v2(False)
    return v2_launches


def phase_v2(model, scfg, C, per_call):
    """sparse_ffn_block_v2 against its plain version at the 7B decode
    shapes over the bench path's concatenated store (L, 3*ng, G, E)."""
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.tools.bench_matrix import sparse_params

    set_kernel_v2(True)
    try:
        w_all = sparse_params(model, scfg)["layers"]["w_all_rows"]
    finally:
        set_kernel_v2(False)
    L, ng3 = w_all.shape[:2]
    ng = ng3 // 3
    return row_kernel_rows("sparse_ffn_block_v2", sf.sparse_ffn_block_v2,
                           sf.sparse_ffn_block_v2_plain,
                           lambda il: ((w_all[il],), {"gated": True, "R": ng}),
                           list(range(L)), ng, C, SEED + 16, True, per_call)


def profile_steps(label, step, steps: int = 8, retakes: int = 0):
    """Device time by kernel over `steps` calls of step() (torch.profiler),
    and the share of the window in which the device was busy. Returns the
    (kernel, ms, launches) rows over all steps and the window's wall ms.
    Late in a long process the profiler drops the first few device events
    of a window, a count that grows with the process's age and holds
    across retakes and pauses: on the H100 the full run's windows lost 1 to
    8 guard kernels that opened them, after a pause of 50 ms as after one
    of 200 ms, and once two of a 13B step's qmm_decode launches behind 8
    guards. So the window opens with PROFILE_OPEN_GUARDS short
    `spin_kernel`s (torch.cuda._sleep) and a synchronization, and closes
    with 8 spin kernels and a synchronization, all left out of the rows. A
    window that kept a guard at each edge lost no step's kernel; one that
    did not is taken again, up to `retakes` times (for a step that may run
    again, such as a decode step), and the last window is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(retakes + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_OPEN_GUARDS):
                torch.cuda._sleep(1_000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(8):
                torch.cuda._sleep(1_000)
            torch.cuda.synchronize()
        # device-side events only (kernels, copies), so no time counts twice,
        # summed by name from the profiler's raw events: its per-op tables
        # (key_averages) build an object for each of the eager steps' tens of
        # thousands of host events, which takes far longer than the window
        device, spins, first = {}, [], None
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if "spin_kernel" in e.name():
                    spins.append(e.start_ns())
                    continue
                ms, n = device.get(e.name(), (0.0, 0))
                device[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
                first = e.start_ns() if first is None else min(first, e.start_ns())
        opening = sum(first is not None and t < first for t in spins)
        closing = len(spins) - opening
        guards = (f"{opening} of {PROFILE_OPEN_GUARDS} + {closing} of 8 guard kernels "
                  f"recorded")
        if (opening and closing) or attempt == retakes:
            break
        print(f"profile: {steps} {label}: {guards}, the window taken again")
    rows = sorted(((k, ms, n) for k, (ms, n) in device.items()), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile: {steps} {label}, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step ({100 * busy / wall_ms:.1f}%), "
          f"{guards}")
    for key, ms, count in rows[:12]:
        print(f"  {ms / steps:8.4f} ms/step  {count // steps:5d}/step  {key[:90]}")
    return rows, wall_ms


def profile_decode(eng, prompt, steps: int = 8):
    """profile_steps over a few decode steps of the engine on a cache of
    its own (whose graph the first, unprofiled step captures); returns its
    (kernel, ms, launches) rows over all steps, the step count and the
    window's wall ms."""
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    state = {"tok": eng.decode_step(tok, n, cache, st)[0], "n": n + 1}  # warm

    def step():
        state["tok"] = eng.decode_step(state["tok"], state["n"], cache, st)[0]
        state["n"] += 1

    kind = "graph" if eng.graphs.capture else "eager"
    rows, wall_ms = profile_steps(f"decode steps ({kind})", step, steps, retakes=2)
    return rows, steps, wall_ms


def decode_timing(eng, prompt, n_new) -> tuple[list, "torch.Tensor", dict, tuple]:
    """One engine's greedy stream of n_new tokens from `prompt` and its
    first decode step's logits (a copy); the decode wall ms a step and tok/s
    of a second generate, which must give the same stream and capture no
    graph (the first captures one unless the engine's cache had one), with
    the median and the largest wall ms between its tokens; then device ms a
    step and busy share over 8 profiled steps, whose (rows, steps) come
    last."""
    from sparkinfer_tpu_torch.runtime.engine import PerfCounters

    toks, first = [], None
    c0, had_cache = eng.graphs.captures, eng.cache is not None
    for tok in eng.generate(prompt, n_new, stream=True):
        toks.append(tok)
        if len(toks) == 2:  # the first decode step's token: its logits
            first = eng.last_logits.clone()
    c1 = eng.graphs.captures
    eng.perf = PerfCounters()
    stamps, again = [], []
    for tok in eng.generate(prompt, n_new, stream=True):
        stamps.append(time.perf_counter())
        again.append(tok)
    check(again == toks, "a second generate gave another stream")
    # wall ms between tokens: one decode step each, and the generator's turn
    gaps = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    wall, tok_s = 1e3 * eng.perf.t_decode_s / eng.perf.n_decode, eng.perf.decode_tps
    if eng.graphs.capture:
        check(c1 - c0 == (0 if had_cache else 1) and eng.graphs.captures == c1,
              f"two generate calls captured {eng.graphs.captures - c0} graphs "
              f"(the engine's cache {'had' if had_cache else 'had no'} graph before)")
    rows, steps, wall_ms = profile_decode(eng, prompt)
    busy = sum(r[1] for r in rows)
    return toks, first, {"wall_ms_per_step": wall, "tok_s": tok_s,
                         "step_ms_median": gaps[len(gaps) // 2], "step_ms_max": gaps[-1],
                         "device_ms_per_step": busy / steps, "busy_share": busy / wall_ms,
                         "device_share_of_wall": busy / steps / wall}, (rows, steps)


def replay_times(step, reps: int = 20) -> dict:
    """Replays of a captured step on its last inputs, which rewrite the same
    cache rows with the same values: the device span of one replay (CUDA
    events around `reps` back-to-back replays: its kernels and the gaps
    between them, the host's part hidden behind the device); the host time
    of one `replay()` call on an idle card, and the wall time from that
    call to the end of a synchronization after it (`reps` calls each). A
    decode step's wall time less the last is the host's part around the
    replay (the static buffers' fills, the token read, Python). These
    replays credit no launch counter."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    launch = synced = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        step.graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch += t1 - t0
        synced += time.perf_counter() - t0
    return {"replay_span_ms": start.elapsed_time(end) / reps,
            "replay_launch_ms": 1e3 * launch / reps, "replay_sync_ms": 1e3 * synced / reps}


def step_breakdown(eng, steps: int = 16) -> dict:
    """Decode steps of the graph engine on its own cache, after the tokens
    generate left there, taken apart as `Engine.decode_step` runs them: host
    ms of the static buffers' fills, of the replay call (with its counter
    credits), and of the token read (the wait for the card); and the device
    ms between CUDA events recorded around the replay call."""
    import torch

    step = eng.graphs.get(eng.cache, 1, "decode", None)
    tok, n_past = int(step.tokens[0, 0]), int(step.positions[0, 0]) + 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host, device = [0.0, 0.0, 0.0], 0.0
    with torch.inference_mode():  # the static buffers are inference tensors
        for i in range(steps):
            t0 = time.perf_counter()
            step.tokens.fill_(tok)
            step.positions.fill_(n_past + i)
            t1 = time.perf_counter()
            start.record()
            _, out = step.run()
            end.record()
            t2 = time.perf_counter()
            tok = int(out[0])
            t3 = time.perf_counter()
            device += start.elapsed_time(end)
            for j, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                host[j] += dt
    return {"fill_ms": 1e3 * host[0] / steps, "replay_call_ms": 1e3 * host[1] / steps,
            "token_read_ms": 1e3 * host[2] / steps, "replay_device_ms": device / steps}


def graph_vs_eager(label, graph_eng, eager_eng, prompt, n_new) -> dict:
    """Phase 5h for one Engine path, graph against eager over the same
    params: greedy streams equal and first decode logits bit-equal, or the
    run fails; wall ms a step, tok/s, device ms a step and busy share of
    each, the graph's capture time and pool bytes. The graph engine's
    profiled steps are kept in PROFILES[label]."""
    import torch

    (gt, gf, g, PROFILES[label]), (et, ef, e, _) = (decode_timing(eng, prompt, n_new)
                                                    for eng in (graph_eng, eager_eng))
    check(gt == et, f"5h {label}: graph stream {gt} differs from eager {et}")
    check(torch.equal(gf, ef), f"5h {label}: first decode logits differ by up to "
                               f"{(gf - ef).abs().max().item():.3e}")
    step = graph_eng.graphs.get(graph_eng.cache, 1, "decode", None)
    row = {"path": label, "graph": g, "eager": e, **replay_times(step),
           "step_breakdown": step_breakdown(graph_eng),
           "capture_s": step.stats["capture_s"], "graph_pool_bytes": step.stats["pool_bytes"],
           "wall_speedup": e["wall_ms_per_step"] / g["wall_ms_per_step"]}
    print("phase 5h, graph vs eager (streams equal, first decode logits bit-equal):",
          json.dumps(row))
    return row


def sparse_dense_ratio(label, sparse_row, dense_row) -> dict:
    ratio = {"path": label, **{k: sparse_row[k]["tok_s"] / dense_row[k]["tok_s"]
                               for k in ("graph", "eager")}}
    print("phase 5h, sparse/dense decode tok/s:", json.dumps(ratio))
    return ratio


def scheduler_graph_vs_eager(graph_sched, eager_sched, prompts, n_new,
                             label="7B bf16") -> dict:
    """Phase 5h for the Scheduler: the same requests through the graph
    Scheduler (its tick captured already) and an eager one; streams equal
    and the first tick's logits bit-equal, or the run fails; wall ms a
    tick, aggregate decode tok/s, and device ms a tick and busy share over
    6 profiled ticks with every slot running."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    got = {}
    for name, sched in (("graph", graph_sched), ("eager", eager_sched)):
        m0, c0 = sched.metrics_snapshot(), sched.graphs.captures
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
        sched.step()
        first = sched.last_logits.clone()
        sched.run_until_idle()
        m = sched.metrics_snapshot()
        ticks = m["n_decode_steps"] - m0["n_decode_steps"]
        secs = m["t_decode_s"] - m0["t_decode_s"]
        gen = (m["n_tokens_generated"] - m0["n_tokens_generated"]
               - (m["n_requests"] - m0["n_requests"]))
        for p in prompts[:sched.n_slots]:
            sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
        sched.step()
        rows, wall_ms = profile_steps(f"Scheduler ticks ({name})", sched.step, 6)
        sched.run_until_idle()
        check(sched.graphs.captures == c0, f"5h Scheduler ({name}): a tick captured again")
        busy = sum(r[1] for r in rows)
        got[name] = ([r.tokens() for r in reqs], first,
                     {"wall_ms_per_tick": 1e3 * secs / ticks, "tok_s": gen / secs,
                      "device_ms_per_tick": busy / 6, "busy_share": busy / wall_ms,
                      "device_share_of_wall": busy / 6 / (1e3 * secs / ticks)})
    (gt, gf, g), (et, ef, e) = got["graph"], got["eager"]
    check(gt == et, "5h Scheduler: graph streams differ from eager")
    check(torch.equal(gf, ef), f"5h Scheduler: first tick logits differ by up to "
                               f"{(gf - ef).abs().max().item():.3e}")
    step = graph_sched.graphs.get(graph_sched.cache, graph_sched.n_slots, "decode", None)
    row = {"path": f"Scheduler {label} sparse, {graph_sched.n_slots} slots", "graph": g,
           "eager": e, **replay_times(step),
           "capture_s": step.stats["capture_s"], "graph_pool_bytes": step.stats["pool_bytes"],
           "wall_speedup": e["wall_ms_per_tick"] / g["wall_ms_per_tick"]}
    print("phase 5h, graph vs eager (streams equal, first tick logits bit-equal):",
          json.dumps(row))
    return row


def profile_prefill(eng, prompt, steps: int = 4) -> dict:
    """The engine's prefill of `prompt` into one cache: prefill tok/s from
    `steps` synchronized calls, then the same calls under torch.profiler:
    device time per prefill by kernel, and the packed linears' share (every
    kernel named qmm_*) with their launches per prefill."""
    import torch

    cache, st = eng.new_cache(), eng.new_sampler_state()
    eng.prefill(prompt, cache, st)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.prefill(prompt, cache, st)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows, _ = profile_steps(f"{len(prompt)}-token prefills", lambda: eng.prefill(prompt, cache, st),
                            steps, retakes=2)
    qmm = [(k, ms, n) for k, ms, n in rows if "qmm_" in k]
    got = dict(tokens=len(prompt), wall_ms=wall_ms, prefill_tps=len(prompt) / wall_ms * 1e3,
               device_ms=sum(r[1] for r in rows) / steps,
               qmm_ms=sum(r[1] for r in qmm) / steps,
               qmm_launches=sum(r[2] for r in qmm) // steps,
               qmm_kernels={k[:60]: [ms / steps, n // steps] for k, ms, n in qmm})
    print("prefill profile:", json.dumps(got))
    check(got["qmm_launches"] > 0, "the profiled prefill recorded no quant_matmul kernel")
    return got


def q8_13b_engine(greedy, L: int = 40):
    """ProSparse-Llama-2-13B widths, L of its 40 layers, Q8_0, random
    weights made and quantized on the card layer by layer, and its sparse
    engine."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    cfg = prosparse_config(L, 5120, 40, 13824, 32000, 1280)
    scfg = SparseConfig(group_size=128, capacity_groups=16)  # 16 of 108 groups, 12.5%
    t0 = time.perf_counter()
    weights = Q8Weights(cfg, torch.bfloat16, "cuda", SEED)
    model = weights.sparse_model(scfg)
    eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
                 device="cuda")
    torch.cuda.synchronize()
    print(f"model: ProSparse-Llama-2-13B widths, L={cfg.n_layer} E={cfg.n_embd} "
          f"F={cfg.n_ff} V={cfg.n_vocab} R={cfg.max_pred_rank}, Q8_0 attention/head/"
          f"FFN stores/predictor stacks, built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return cfg, scfg, weights, model, eng


def prefill_only() -> int:
    """`chip_smoke.py --prefill-profile`: only the profiled 32-token prefill
    of the 13B Q8_0 engine, for whichever sparkinfer_tpu_torch the script's
    directory holds (so a copy of this script beside another revision's
    package profiles that revision). Prints the card and one JSON line."""
    import torch

    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    *_, eng = q8_13b_engine(SamplerConfig(temp=0.0))
    print(json.dumps({"prefill_profile": profile_prefill(eng, prompt)}))
    return 0


def run_generate(eng, prompt, n_new):
    """Greedy generate, checking every logit row the engine produced."""
    import torch

    toks = []
    for tok in eng.generate(prompt, n_new, stream=True):
        check(bool(torch.isfinite(eng.last_logits).all()), "non-finite logits")
        toks.append(tok)
    check(len(toks) == n_new, f"generated {len(toks)} of {n_new} tokens")
    return toks


def kernel_wrappers():
    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    return {"sparse_ffn_block_v6": sf.sparse_ffn_block_v6,
            "sparse_ffn_block_v6q": sf.sparse_ffn_block_v6q,
            "sparse_ffn_block": sf.sparse_ffn_block,
            "sparse_ffn_block_v2": sf.sparse_ffn_block_v2,
            "sparse_ffn_block_v3": sf.sparse_ffn_block_v3,
            "sparse_ffn_block_v4": sf.sparse_ffn_block_v4,
            "sparse_ffn_block_v5": sf.sparse_ffn_block_v5,
            "sparse_ffn_block_v7u": sf.sparse_ffn_block_v7u,
            "quant_matmul_2d": qm.quant_matmul_2d,
            "quant_matmul_flat": qm.quant_matmul_flat}


PEAKS = {}  # peak device GiB of each main path, by label
STREAMS = {}  # greedy tokens of each main path, by label
PROFILES = {}  # phase 5h's profiled graph steps of each Engine path: (rows, steps), by label
PROFILE_OPEN_GUARDS = 1024  # spin kernels that open a profile window (profile_steps)
START = [time.perf_counter()]  # the run's start, reset by main


def mark(what):
    """A line with the seconds since the run's start, after each part."""
    print(f"{what} done at {time.perf_counter() - START[0]:.1f} s", flush=True)


def main_path(label, eng, prompt, n_new, want):
    """Generate with every launch count set to 0 just before and read just
    after; `want(runs)` gives the exact count each kernel must show after
    `runs` decode-step forwards: each step (a replay of its graph) and the
    graph's warm-up where this generate captured it."""
    import torch

    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    captures = eng.graphs.captures
    for w in wrappers.values():
        w.launches = 0
    toks = run_generate(eng, prompt, n_new)
    launches = {name: w.launches for name, w in wrappers.items()}
    steps = eng.perf.n_decode
    check(steps == n_new - 1, f"{steps} decode steps for {n_new} tokens")
    warm = eng.graphs.captures - captures
    check(warm == 1, f"{label}: generate captured {warm} graphs, want 1")
    expect = want(steps + warm)
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"{label}: {name} launched {n} times, want {expect.get(name, 0)}")
    summary = eng.perf.summary()
    peak = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    STREAMS[label] = toks
    print(f"main path {label}: prefill {summary['prefill_tps']} tok/s, decode "
          f"{summary['decode_tps']} tok/s ({steps} steps), peak {peak:.2f} GiB, "
          f"launches {json.dumps(launches)} (as expected: {steps} steps, {warm} warm-up)")
    print(f"main path {label} tokens: {toks}")
    return launches


# --- phase 5i: the OpenAI-compatible server over the Scheduler ---------------

# llama-2's chat format (the ProSparse models' family), without the BOS the
# tokenizer adds itself
CHAT_TEMPLATE = (
    "{% for m in messages %}{% if m['role'] == 'system' %}<<SYS>>\n{{ m['content'] }}"
    "\n<</SYS>>\n\n{% elif m['role'] == 'user' %}[INST] {{ m['content'] }} [/INST]"
    "{% else %} {{ m['content'] }} {{ eos_token }}{% endif %}{% endfor %}")
SERVER_KEYS = ("client_decode_tok_s", "server_ms_per_tick", "server_prefill_ms",
               "bare_ms_per_tick", "bare_decode_tok_s", "bare_prefill_ms", "ticks")
JSON_SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                                "age": {"type": "integer"}},
               "required": ["name", "age"]}


def spm_vocab(n_vocab: int, seed: int):
    """An SPM Vocab of n_vocab pieces, as a llama-2 GGUF holds one: <unk>,
    <s>, </s>, the 256 byte-fallback pieces and word pieces made from the
    seed, each word with every prefix a piece (the merge chain SPM needs),
    and CHAT_TEMPLATE."""
    import numpy as np

    from sparkinfer_tpu_torch.tokenizer import Vocab

    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + ["▁"]
    seen = set(tokens)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(tokens) < n_vocab:
        word = "".join(rng.choice(letters, size=int(rng.integers(1, 9))))
        for k in range(1, len(word) + 1):
            piece = "▁" + word[:k]
            if piece not in seen and len(tokens) < n_vocab:
                seen.add(piece)
                tokens.append(piece)
    types = np.full(n_vocab, 1, np.int32)  # NORMAL
    types[0], types[1:3], types[3:259] = 2, 3, 6  # UNKNOWN, CONTROL, BYTE
    scores = np.zeros(n_vocab, np.float32)
    scores[259:] = -np.arange(n_vocab - 259, dtype=np.float32) / n_vocab
    return Vocab(model="llama", pre="default", tokens=tokens, token_types=types,
                 scores=scores, merges=None, bos_id=1, eos_id=2, unk_id=0, add_bos=True,
                 add_space_prefix=True, chat_template=CHAT_TEMPLATE)


def http(port: int, path: str, body=None, timeout: float = 300.0) -> dict:
    """One request to the server on 127.0.0.1:port: its status, its body
    (JSON, or for an SSE stream the text of its deltas, joined), and the
    client's ms to the first SSE chunk and to the end. Fails the run on a
    status other than 200."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"server {path}: HTTP {r.status}")
        if not isinstance(body, dict) or not body.get("stream"):
            raw = r.read()
            out = (json.loads(raw) if r.headers.get("Content-Type") == "application/json"
                   else raw.decode())
        else:
            parts, done = [], False
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                if first is None:
                    first = time.perf_counter()
                if line == "data: [DONE]":
                    done = True
                    break
                ch = json.loads(line[6:])["choices"][0]
                parts.append(ch.get("text") or ch.get("delta", {}).get("content") or "")
            check(done, f"server {path}: the stream ended without [DONE]")
            out = "".join(parts)
    end = time.perf_counter()
    return {"body": out, "ttft_ms": 1e3 * ((first or end) - t0), "e2e_ms": 1e3 * (end - t0)}


def fresh_slots(sched):
    """Forget the prompts the slots hold, so that every next request
    prefills from position 0 as its reference did (a reused prefix prefills
    the rest another way, whose last bits differ at bf16)."""
    for slot in sched.slots:
        slot.cached_tokens = []


def held_requests(srv, bodies, path):
    """Send `bodies` to `path` at once, each on a thread of its own, with the
    Scheduler's loop held until all of them wait in its queue, so that they
    are admitted together into fresh slots, as their reference was. Returns
    the responses in order."""
    import threading

    sched = srv.sched
    sched.stop()
    fresh_slots(sched)
    out = [None] * len(bodies)
    errors = []

    def call(i):
        try:
            out[i] = http(srv.port, path, bodies[i])
        except BaseException as e:  # noqa: BLE001 - reported below, the run fails
            errors.append(f"{path} request {i}: {e!r}")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 120
    while sched.pending.qsize() < len(bodies) and not errors:
        check(time.perf_counter() < deadline, f"server {path}: requests never queued")
        time.sleep(0.005)
    sched.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and all(o is not None for o in out), f"server: {errors}")
    return out


def reference_ids(srv, bodies):
    """The bodies' requests, built by the server's own request maker, served
    by its Scheduler directly (loop stopped, slots fresh, all admitted
    together): their token ids, and the bare Scheduler's ms a tick and
    aggregate decode tok/s. A first pass of 2 tokens each captures the
    ticks' graphs, so that no capture is timed."""
    sched = srv.sched
    sched.stop()
    for b in bodies:
        sched.submit(srv._make_request(b["prompt"], {**b, "max_tokens": 2}))
    sched.run_until_idle()
    fresh_slots(sched)
    m0 = sched.metrics_snapshot()
    reqs = [sched.submit(srv._make_request(b["prompt"], b)) for b in bodies]
    sched.run_until_idle()
    m = sched.metrics_snapshot()
    ticks = m["n_decode_steps"] - m0["n_decode_steps"]
    secs = m["t_decode_s"] - m0["t_decode_s"]
    gen = m["n_tokens_generated"] - m0["n_tokens_generated"] - len(reqs)
    return [r.tokens() for r in reqs], {
        "ms_per_tick": 1e3 * secs / ticks, "decode_tok_s": gen / secs, "ticks": ticks,
        "prefill_ms": 1e3 * (m["t_prefill_s"] - m0["t_prefill_s"]) / len(reqs)}


def server_path(label, srv, prompts, n_new, want):
    """The server's main path: `prompts` (token ids) as concurrent streamed
    /v1/completions of n_new greedy tokens, held to the bare Scheduler's
    streams on the same weights (detokenized; the stream keeps the SPM
    leading space that a whole decode drops). Every launch count is set to
    0 just before the HTTP requests and read just after; want(runs) gives
    each kernel's count after `runs` forwards: the prefills (one a
    request), the sparse and dense ticks and the captures' warm-ups.
    Returns the launches, the counts of ticks and the numbers printed."""
    sched = srv.sched
    bodies = [{"prompt": p, "max_tokens": n_new, "temperature": 0.0, "stream": True}
              for p in prompts]
    ref, bare = reference_ids(srv, bodies)
    # a first request warms the client and the server (about 150 ms of first
    # use, not the path's), so that the times below start warm
    check(http(srv.port, "/health")["body"] == {"status": "ok"}, f"{label}: /health")
    wrappers = kernel_wrappers()
    m0, c0 = sched.metrics_snapshot(), len(sched.graphs.captured)
    for w in wrappers.values():
        w.launches = 0
    got = held_requests(srv, bodies, "/v1/completions")
    launches = {name: w.launches for name, w in wrappers.items()}
    m = sched.metrics_snapshot()
    for i, (r, ids) in enumerate(zip(got, ref)):
        check(r["body"].removeprefix(" ") == srv.detok(ids),
              f"{label}: request {i} streamed {r['body']!r}, the Scheduler gave "
              f"{srv.detok(ids)!r}")
    ticks = m["n_decode_steps"] - m0["n_decode_steps"]
    dense = m["n_dense_steps"] - m0["n_dense_steps"]
    warm = [c["label"] for c in sched.graphs.captured[c0:]]
    runs = {"prefill": m["n_requests"] - m0["n_requests"], "sparse": ticks - dense,
            "dense": dense, "warm_sparse": warm.count("decode step"),
            "warm_dense": warm.count("dense step")}
    expect = want(runs)
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"{label}: {name} launched {n} times, want {expect.get(name, 0)} ({runs})")
    secs = m["t_decode_s"] - m0["t_decode_s"]
    first = min(r["ttft_ms"] for r in got)
    last = max(r["e2e_ms"] for r in got)
    n_dec = sum(len(ids) - 1 for ids in ref)
    stats = {
        "requests": [{"ttft_ms": round(r["ttft_ms"], 2), "e2e_ms": round(r["e2e_ms"], 2),
                      "tokens": len(ids)} for r, ids in zip(got, ref)],
        "client_decode_tok_s": 1e3 * n_dec / (last - first),
        "server_ms_per_tick": 1e3 * secs / max(ticks, 1),
        "server_prefill_ms": 1e3 * (m["t_prefill_s"] - m0["t_prefill_s"]) / runs["prefill"],
        "bare_ms_per_tick": bare["ms_per_tick"], "bare_decode_tok_s": bare["decode_tok_s"],
        "bare_prefill_ms": bare["prefill_ms"],
        "ticks": runs, "launches": launches}
    print(f"phase 5i, {label}:", json.dumps(stats))
    return launches, runs, stats


def phase_server(model, scfg, n_new: int = 32):
    """Phase 5i: the 7B-width bf16 model behind SparkServer (4 slots,
    max_seq 1024, the sparse Scheduler with the crossover table's
    sparse_batch_max), driven over HTTP on 127.0.0.1: 4 concurrent streamed
    completions held to the bare Scheduler; 2 streamed chats each equal to
    the same chat not streamed; a json_schema request whose text the
    grammar accepts; /tokenize, /detokenize, /health and /metrics."""
    import torch

    from sparkinfer_tpu_torch.grammar import json_schema_to_gbnf, parse_gbnf
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    cfg = model.config
    L = cfg.n_layer
    model.vocab = spm_vocab(cfg.n_vocab, SEED)
    t0 = time.perf_counter()
    srv = SparkServer(model, ServerConfig(port=0, n_slots=4, max_seq=1024, sparse=scfg),
                      sampler=SamplerConfig(temp=0.0))
    bmax = srv.sched.sparse_batch_max
    print(f"phase 5i: SparkServer 7B bf16 sparse, 4 slots, sparse_batch_max {bmax}, built in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated")
    try:
        srv.serve(block=False)
        gen = torch.Generator().manual_seed(SEED + 12)
        prompts = [torch.randint(259, cfg.n_vocab, (32,), generator=gen).tolist()
                   for _ in range(4)]

        def want(r):  # v1 once a layer in each sparse tick forward
            return {"sparse_ffn_block": L * (r["sparse"] + r["warm_sparse"])}

        launches, runs, stats = server_path("7B bf16 sparse server", srv, prompts, n_new, want)
        if bmax == 0:
            print("phase 5i: the crossover is 0, so every tick took the masked-dense step "
                  f"and v1 launched {launches['sparse_ffn_block']} times; the Q8_0 server "
                  "carries the kernel requirement")
        else:
            check(launches["sparse_ffn_block"] > 0, "phase 5i: v1 never ran in the server")
        # streamed chats, each against the same chat not streamed
        chats = [[{"role": "system", "content": "You answer briefly."},
                  {"role": "user", "content": "hello world"}],
                 [{"role": "user", "content": "what is sparse decoding"}]]
        bodies = [{"messages": c, "max_tokens": 16, "temperature": 0.0, "stream": s}
                  for c in chats for s in (True, False)]
        out = held_requests(srv, bodies, "/v1/chat/completions")
        for i in range(0, len(out), 2):
            sse = out[i]["body"]
            text = out[i + 1]["body"]["choices"][0]["message"]["content"]
            check(sse.removeprefix(" ") == text,
                  f"phase 5i: chat {i // 2} streamed {sse!r}, not streamed {text!r}")
        # one grammar-constrained request, its mask timed a tick
        m0 = srv.sched.metrics_snapshot()
        r = http(srv.port, "/v1/completions", {
            "prompt": "the person:", "max_tokens": 8, "temperature": 0.0,
            "response_format": {"type": "json_schema", "json_schema": {"schema": JSON_SCHEMA}}})
        text = r["body"]["choices"][0]["text"]
        g = parse_gbnf(json_schema_to_gbnf(JSON_SCHEMA))
        stacks = g.accept_text(g.start_stacks(), text) or g.accept_text(g.start_stacks(),
                                                                       " " + text)
        check(bool(stacks), f"phase 5i: {text!r} is no prefix of the schema's language")
        if g.is_complete(stacks):
            obj = json.loads(text)
            check(isinstance(obj.get("name"), str) and isinstance(obj.get("age"), int),
                  f"phase 5i: {obj} does not match the schema")
        m = srv.sched.metrics_snapshot()
        n_masks = m["n_grammar_masks"] - m0["n_grammar_masks"]
        mask_ms = 1e3 * (m["t_grammar_s"] - m0["t_grammar_s"]) / n_masks
        # the plain routes
        words = "hello sparse world"
        ids = http(srv.port, "/tokenize", {"content": words})["body"]["tokens"]
        back = http(srv.port, "/detokenize", {"tokens": ids})["body"]["content"]
        check(back.strip() == words, f"phase 5i: /tokenize then /detokenize gave {back!r}")
        check(http(srv.port, "/health")["body"] == {"status": "ok"}, "phase 5i: /health")
        metrics = http(srv.port, "/metrics")["body"]
        check("sparkinfer_n_decode_steps" in metrics, "phase 5i: /metrics lacks the ticks")
        m = srv.sched.metrics_snapshot()
        print("phase 5i, 7B server checks:", json.dumps({
            "completions_equal_scheduler": True, "sse_equals_non_streamed": True,
            "json_schema_text": text, "json_schema_ms": round(r["e2e_ms"], 2),
            "grammar_mask_ms_per_tick": mask_ms, "grammar_masks": n_masks,
            "vocab": cfg.n_vocab, "tokenize_ids": len(ids),
            "ticks": {"sparse": m["n_decode_steps"] - m["n_dense_steps"],
                      "dense": m["n_dense_steps"]}}))
    finally:
        srv.shutdown()
        model.vocab = None
    return launches["sparse_ffn_block"], stats, mask_ms


def phase_server_q8(cfg, dense, n_new: int = 16):
    """Phase 5i, Q8_0: the 13B-width dense model with its packed linears
    (Q8_0 attention, FFN and head) behind SparkServer, 4 concurrent
    streamed requests of 32-token prompts held to its bare Scheduler;
    quant_matmul_2d launched 7L + 1 times a forward."""
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    L = cfg.n_layer
    dense.vocab = spm_vocab(cfg.n_vocab, SEED)
    srv = SparkServer(dense, ServerConfig(port=0, n_slots=4, max_seq=128),
                      sampler=SamplerConfig(temp=0.0))
    try:
        srv.serve(block=False)
        import torch

        gen = torch.Generator().manual_seed(SEED + 13)
        prompts = [torch.randint(259, cfg.n_vocab, (32,), generator=gen).tolist()
                   for _ in range(4)]

        def want(r):
            return {"quant_matmul_2d": (7 * L + 1) * (r["prefill"] + r["dense"] + r["sparse"]
                                                      + r["warm_dense"] + r["warm_sparse"])}

        launches, _, stats = server_path("13B Q8_0 dense server", srv, prompts, n_new, want)
        check(launches["quant_matmul_2d"] > 0, "phase 5i: quant_matmul never ran")
    finally:
        srv.shutdown()
        dense.vocab = None
    return launches["quant_matmul_2d"], stats


def write_tiny_gguf(path, seed: int):
    """A small ProSparse GGUF at the llama-2 layout, written by the port's
    gguf writer: 2 layers, E=128, 4 heads, F=256, a rank-16 predictor, and
    an SPM vocabulary of 512 pieces with CHAT_TEMPLATE."""
    write_prosparse_gguf(path, seed, L=2, E=128, H=4, F=256, R=16, n_vocab=512)


def write_prosparse_gguf(path, seed: int, L, E, H, F, R, n_vocab, f16=False):
    """A ProSparse GGUF at the llama-2 layout, written by the port's gguf
    writer, with an SPM vocabulary of n_vocab pieces and CHAT_TEMPLATE;
    weights drawn from the seed (N(0, 0.08), or with f16 stored as F16 at
    bench.py's "7b" scales, drawn on the card)."""
    import numpy as np

    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    arch = "prosparse_llama"
    vocab = spm_vocab(n_vocab, seed)
    V = vocab.n_tokens
    rng = np.random.default_rng(seed)
    if f16:
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, scale=0.08, shift=0.0):
        if f16:
            t = torch.randn(shape, generator=gen, device="cuda") * scale + shift
            return t.half().cpu().numpy()
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    sc = dict(proj=0.02, pred_up=0.05, pred_down=0.6, bias=0.5) if f16 else dict(
        proj=0.08, pred_up=0.08, pred_down=0.08, bias=0.08)
    wr = GGUFWriter(str(path), arch)
    wr.add_kv("tokenizer.ggml.model", "llama")
    wr.add_array("tokenizer.ggml.tokens", vocab.tokens)
    wr.add_array("tokenizer.ggml.scores", vocab.scores)
    wr.add_array("tokenizer.ggml.token_type", vocab.token_types)
    for key, v in (("bos", 1), ("eos", 2), ("unknown", 0)):
        wr.add_kv(f"tokenizer.ggml.{key}_token_id", np.uint32(v))
    wr.add_kv("tokenizer.chat_template", CHAT_TEMPLATE)
    for key, v in (("block_count", L), ("embedding_length", E), ("attention.head_count", H),
                   ("attention.head_count_kv", H), ("feed_forward_length", F),
                   ("vocab_size", V), ("context_length", 4096 if f16 else 256),
                   ("rope.dimension_count", E // H)):
        wr.add_kv(f"{arch}.{key}", np.uint32(v))
    wr.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    wr.add_kv(f"{arch}.rope.freq_base", np.float32(10000.0))
    wr.add_array(f"{arch}.pred_lora", np.full(L, R, np.uint32))
    wr.add_tensor("token_embd.weight", w(V, E, scale=sc["proj"]))
    wr.add_tensor("output_norm.weight", np.ones(E, np.float32))
    wr.add_tensor("output.weight", w(V, E, scale=sc["proj"]))
    for i in range(L):
        p = f"blk.{i}."
        for name, shape in (("attn_norm.weight", (E,)), ("ffn_norm.weight", (E,))):
            wr.add_tensor(p + name, np.ones(shape, np.float32))
        for name, shape, scale in (
                ("attn_q.weight", (E, E), "proj"), ("attn_k.weight", (E, E), "proj"),
                ("attn_v.weight", (E, E), "proj"), ("attn_output.weight", (E, E), "proj"),
                ("ffn_up.weight", (F, E), "proj"), ("ffn_gate.weight", (F, E), "proj"),
                ("ffn_down.weight", (E, F), "proj"), ("ffn_pred_up.weight", (R, E), "pred_up"),
                ("ffn_pred_down.weight", (F, R), "pred_down")):
            wr.add_tensor(p + name, w(*shape, scale=sc[scale]))
        wr.add_tensor(p + "ffn_pred_up.bias", np.zeros(R, np.float32) if f16 else w(R))
        wr.add_tensor(p + "ffn_pred_down.bias",
                      (w(F, scale=sc["bias"], shift=-1.2) if f16 else w(F) - 1.0)
                      .astype(np.float32))
    wr.write()


def phase_entry_point(timeout: float = 240.0) -> dict:
    """`python -m sparkinfer_tpu_torch.server -m tiny.gguf -np 2 --port 0` as a
    child process on the card: load_model, the Scheduler and HTTP through
    the real entry point. Waits for its "listening on" line and /health,
    sends one completion, and stops the process whatever happens."""
    import os
    import pathlib
    import queue
    import tempfile
    import threading
    import urllib.error

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        gguf = pathlib.Path(tmp) / "tiny-prosparse.gguf"
        write_tiny_gguf(gguf, SEED)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "sparkinfer_tpu_torch.server", "-m", str(gguf), "-np", "2",
             "--port", "0", "-c", "256"], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines: "queue.Queue[str | None]" = queue.Queue()
        log: list[str] = []

        def read():
            for line in proc.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=read, daemon=True).start()
        try:
            port = None
            deadline = time.perf_counter() + timeout
            while port is None:
                try:
                    line = lines.get(timeout=max(deadline - time.perf_counter(), 0.01))
                except queue.Empty:
                    fail(f"entry point: no 'listening on' line in {timeout} s: {log}")
                if line is None:
                    fail(f"entry point exited {proc.wait()}: {''.join(log)}")
                log.append(line)
                if line.startswith("listening on http://"):
                    port = int(line.split()[2].rsplit(":", 1)[1])
            while True:
                try:
                    health = http(port, "/health", timeout=10)["body"]
                    break
                except (urllib.error.URLError, ConnectionError):
                    check(time.perf_counter() < deadline, "entry point: /health never answered")
                    time.sleep(0.2)
            r = http(port, "/v1/completions",
                     {"prompt": "hello world", "max_tokens": 8, "temperature": 0.0})
            out = r["body"]
            check(health == {"status": "ok"} and out["object"] == "text_completion"
                  and out["usage"]["completion_tokens"] >= 1
                  and isinstance(out["choices"][0]["text"], str),
                  f"entry point: /health {health}, completion {out}")
            row = {"listening": log[-1].strip(), "start_to_answer_s": time.perf_counter() - t0,
                   "completion_ms": round(r["e2e_ms"], 2),
                   "completion_tokens": out["usage"]["completion_tokens"]}
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    print("phase 5i, entry point:", json.dumps(row))
    return row


# --- phase 5j: hot/cold tiering with online balancing ------------------------

TIER_HOT_7B = 22  # of 86 groups a layer, 0.25
TIER_HOT_13B = 27  # of 108 groups a layer, 0.25
TIER_TOL = 1e-4  # host mode's FFN against the untiered one, f32: of the output's scale


def skewed_pred_bias(cfg, group_size: int):
    """bench.py:765-780: a random fifth of each layer's neuron groups fire
    often, the rest almost never, shuffled per layer, so that the balancer
    has a hot set to find; the offsets scale with the predictor logits'
    spread at these weight scales. (L, F) f32 on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    L, F, R = cfg.n_layer, cfg.n_ff, cfg.max_pred_rank
    ng = F // group_size
    sigma = 0.6 * (0.05 * np.sqrt(cfg.n_embd)) * np.sqrt(R / 2)
    b = np.full((L, F), -4.0 * sigma, np.float32)
    for l in range(L):
        for g in rng.choice(ng, size=max(1, ng // 5), replace=False):
            b[l, g * group_size:(g + 1) * group_size] = (
                rng.standard_normal(group_size).astype(np.float32) * 0.5 - 0.5) * sigma
    return torch.from_numpy(b)


def untiered_ffn(cfg, scfg):
    """The untiered sparse FFN over the full row stores (the gather math, on
    the card) over the groups host mode computes: each token's selected
    groups that are hot, and every active group that is cold (the
    complement takes them whether or not they were selected). Where every
    active group is selected this is the plain sparse FFN."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import combine
    from sparkinfer_tpu_torch.sparse.ffn import select_groups
    from sparkinfer_tpu_torch.sparse.predictor import predict_activations

    G, F, thr = scfg.group_size, cfg.n_ff, scfg.threshold
    ng = F // G

    def ffn(lp, x):
        B, T, E = x.shape
        xt = x.reshape(B * T, E)
        probs = predict_activations(lp, xt)
        gp = probs.reshape(-1, ng, G)
        idx = select_groups(probs, scfg, F).long()
        selected = torch.zeros(gp.shape[:2], dtype=torch.bool, device=x.device)
        selected.scatter_(1, idx, True)
        hot = lp["group_map"] >= 0
        groups = (selected & hot) | ((gp >= thr).any(-1) & ~hot)
        up = torch.einsum("ne,kge->nkg", xt, lp["w_up_rows"])
        gate = torch.einsum("ne,kge->nkg", xt, lp["w_gate_rows"])
        h = combine(cfg.traits.sparse_act, cfg.fatrelu_threshold, gate, up)
        h = h * ((gp >= thr) & groups[..., None]).to(h.dtype)
        return torch.einsum("nkg,kge->ne", h, lp["w_down_rows"]).reshape(B, T, E)

    return ffn


def tier_f32_gate(greedy_steps: int = 8):
    """ProSparse-Llama-2-7B widths cut to 4 layers, f32, skewed predictor
    bias, 22 of 86 groups hot: host mode (v6 over the hot store plus the host
    library's complement) against the untiered sparse FFN over the same
    selections (`untiered_ffn`), layer by layer on the untiered path's inputs,
    and the greedy tokens of the two whole forwards."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.ffn import prepare_sparse_params
    from sparkinfer_tpu_torch.sparse.tiering import (
        ColdStore,
        init_tiered,
        make_tiered_ffn,
        tiered_layer_params,
    )

    cfg = prosparse_config(4, 4096, 32, 11008, 32000, 1024)
    scfg = SparseConfig(128, 12, hot_groups=TIER_HOT_7B)
    model = random_model(cfg, torch.float32, "cuda", SEED + 41)
    model.params["layers"]["pred_down_b"].copy_(skewed_pred_bias(cfg, 128))
    params = prepare_sparse_params(model.params, cfg, scfg, drop_dense=True)
    layers = params["layers"]
    tp, fs = init_tiered(cfg, scfg, layers, scfg.hot_groups)
    cold = ColdStore(cfg, scfg, {k: v for k, v in layers.items() if k.endswith("_rows")},
                     dtype=torch.float32)
    tiered = make_tiered_ffn(cfg, scfg, cold, mode="host")
    plain = untiered_ffn(cfg, scfg)
    flat = tiered_layer_params(layers, tp)[1]
    params = {**params, "layers": {**layers, "group_map": tp.group_map}, "sparse_flat": flat}
    errs = []

    def both(lp, x, state, il):
        y = plain(lp, x)
        errs.append(((tiered(lp, x, state, il) - y).abs().max() / y.abs().max()).item())
        return y

    prompt = torch.randint(cfg.n_vocab, (1, 32), generator=torch.Generator().manual_seed(SEED + 5))
    plain_fwd = make_forward(cfg, ffn_fn=plain)
    host_fwd = make_forward(cfg, ffn_fn=tiered, stateful_ffn=True)
    gate_fwd = make_forward(cfg, ffn_fn=both, stateful_ffn=True)
    streams = {}
    with torch.inference_mode():
        # the gate decodes from the plain path's prefill
        for name, pre, fwd in (("plain", plain_fwd, plain_fwd), ("gate", plain_fwd, gate_fwd),
                               ("host", host_fwd, host_fwd)):
            cache = init_cache(cfg, 1, 64, torch.float32, "cuda")

            def run(f, toks, pos):
                return f(params, toks, pos, cache, *(() if f is plain_fwd else (fs,)))

            logits = run(pre, prompt.cuda(), torch.arange(32, device="cuda")[None])
            toks = [int(logits[0, -1].argmax())]
            for i in range(greedy_steps):
                logits = run(fwd, torch.tensor([[toks[-1]]], device="cuda"),
                             torch.tensor([[32 + i]], device="cuda"))
                toks.append(int(logits[0, -1].argmax()))
            streams[name] = toks
    worst = max(errs)
    row = {"layers_compared": len(errs), "max_rel_err": worst, "tol": TIER_TOL,
           "misses": float(fs.miss.sum()), "host_calls": cold.n_calls,
           "tokens_equal": streams["host"] == streams["plain"]}
    print("phase 5j, f32 gate (7B widths, 4 layers, host mode vs untiered):", json.dumps(row))
    check(len(errs) == cfg.n_layer * greedy_steps, f"5j: {len(errs)} layers compared")
    check(worst <= TIER_TOL, f"5j: a host-mode layer differs by {worst:.3e} of its scale")
    check(row["misses"] > 0, "5j: the f32 gate missed no cold group: nothing was tested")
    check(streams["host"] == streams["plain"] == streams["gate"],
          f"5j: greedy tokens differ: {streams}")
    return row


def settled_gib() -> float:
    """Device GiB allocated once everything dropped is collected, with the
    peak counter reset to it: the base of the next build's own peak."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def miss_trend(misses) -> dict:
    """Mean misses a token over the first and the last 16 steps (over the
    run's halves where it has fewer than 32 steps)."""
    k = min(16, len(misses) // 2)
    return {"misses_per_token_first16": sum(misses[:k]) / k,
            "misses_per_token_last16": sum(misses[-k:]) / k}


def tier_decode(label, eng, prompt, n_new, kernel, gate_graph=False):
    """Greedy decode through a tiered Engine, step by step (each decode step
    followed by the engine's rebalance): every launch count set to 0 just
    before and read just after, and `kernel` launched n_layer times a step
    (and a warm-up step where a graph is captured); misses a token, swaps,
    host-to-card bytes, window and overruns, wall ms a step and a rebalance,
    host complement ms a layer, device ms a step (profiled steps after), peak
    memory. gate_graph: after the run, one replay of the captured step
    against the eager step on the same state, logits bit-equal."""
    import torch

    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    captures = eng.graphs.captures
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    fs, bal = eng.fstate, eng.balancer
    misses, swapped, walls = [], 0, []
    for i in range(n_new - 1):
        m0, s0 = float(fs.miss.sum()), bal.total_swaps
        t0 = time.perf_counter()
        tok, cache, st = eng.decode_step(tok, n + i, cache, st)
        walls.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(eng.last_logits).all()), f"5j {label}: non-finite logits")
        misses.append(float(fs.miss.sum()) - m0)
        swapped += bal.total_swaps > s0
    steps = n_new - 1
    launches = {name: w.launches for name, w in wrappers.items()}
    warm = eng.graphs.captures - captures
    L = eng.cfg.n_layer
    for name, got in launches.items():
        want = L * (steps + warm) if name == kernel else 0
        check(got == want, f"5j {label}: {name} launched {got} times, want {want}")
    row = {"path": label, "steps": steps, "graph": eng.graphs.capture, "launches": launches[kernel],
           "tok_s": eng.perf.decode_tps,
           "wall_ms_per_step": 1e3 * eng.perf.t_decode_s / eng.perf.n_decode,
           "wall_ms_per_step_with_rebalance": 1e3 * sum(walls) / steps,
           "rebalances": bal.rebalances, "rebalances_that_swapped": swapped,
           "ms_per_rebalance": 1e3 * bal.t_total_s / max(bal.rebalances, 1),
           "swaps": bal.total_swaps, "h2d_bytes": bal.bytes_h2d, "window": bal.window,
           "overruns": bal.overruns, **miss_trend(misses),
           "hot_store_bytes": eng.tiered_params.nbytes, "cold_store_bytes": eng.cold.nbytes,
           "cold_store_dtype": str(eng.cold.dtype)}
    if eng.cold.n_calls:
        row.update(host_calls=eng.cold.n_calls,
                   host_library_ms_per_layer=1e3 * eng.cold.t_call_s / eng.cold.n_calls,
                   host_ms_per_layer=1e3 * eng.cold.t_layer_s / eng.cold.n_calls,
                   host_share_of_step=eng.cold.t_layer_s / eng.perf.t_decode_s)
    if gate_graph:
        check(swapped >= 8, f"5j {label}: {swapped} rebalances swapped, want at least 8")
        step = eng.graphs.get(cache, 1, "decode", None)
        live = [t for t in fs if t is not None]
        saved = [t.clone() for t in live]
        with torch.inference_mode():
            step.tokens.fill_(tok)
            step.positions.fill_(n + steps)
            graph_logits = step.run()[0].clone()
            for t, v in zip(live, saved):
                t.copy_(v)
            eager_logits = eng._decode_fn(cache)(step.tokens, step.positions)[0]
        check(torch.equal(graph_logits, eager_logits),
              f"5j {label}: the replay's logits differ from the eager step's by up to "
              f"{(graph_logits - eager_logits).abs().max().item():.3e}")
        row["replay_equals_eager_after_swaps"] = True
        row.update(replay_times(step))  # the replay's device span and host call
    rows, n_prof, wall_ms = profile_decode(eng, prompt, steps=4)
    row["device_ms_per_step"] = sum(r[1] for r in rows) / n_prof
    row["kernels_per_step"] = sum(r[2] for r in rows) / n_prof
    row["h2d_copy_ms_per_step"] = sum(r[1] for r in rows if "Memcpy HtoD" in r[0]) / n_prof
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 5j, {label}:", json.dumps(row))
    return row


def phase_tiered_7b(model, greedy, prompt, n_new):
    """The 7B bf16 model, skewed predictor bias, 22 of 86 groups hot: the
    tiered Engine in fetch and drop modes (graphs, n_new tokens, a rebalance
    every step) and host mode (eager, 16 tokens), one cold store at a time;
    then the 4-slot Scheduler with prefill_mode="tiered" (fetch mode), which
    takes the dense FFN out of `model` and leaves no row store on the card.
    Returns the rows and the tiered path's v6 launches."""
    import gc

    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    cfg = model.config
    L = cfg.n_layer
    model.params["layers"]["pred_down_b"].copy_(skewed_pred_bias(cfg, 128))
    scfg = SparseConfig(128, 12, hot_groups=TIER_HOT_7B)
    rows = []
    for mode, steps in (("fetch", n_new), ("drop", n_new), ("host", 16)):
        base = settled_gib()
        t0 = time.perf_counter()
        eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, sparse_cold_mode=mode,
                     device="cuda")
        built = time.perf_counter() - t0
        row = tier_decode(f"7B bf16 tiered {mode}", eng, prompt, steps, "sparse_ffn_block_v6",
                          gate_graph=(mode == "fetch"))
        row.update(build_s=built, base_gib=base, own_peak_gib=row["peak_gib"] - base)
        rows.append(row)
        if mode == "fetch":
            check(row["misses_per_token_last16"] < row["misses_per_token_first16"],
                  f"5j: fetch misses a token did not fall: {row['misses_per_token_first16']} "
                  f"-> {row['misses_per_token_last16']}")
        del eng
    # the dense engine's peak on the same weights, for the memory comparison
    base = settled_gib()
    dense = Engine(model, max_seq=1024, sampler=greedy, device="cuda")
    run_generate(dense, prompt, 8)
    dense_peak = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30, "base_gib": base,
                  "model_gib": sum(t.numel() * t.element_size() for t in
                                   [model.params[k] for k in ("tok_embd", "output")]
                                   + list(model.params["layers"].values())) / 2**30}
    dense_peak["own_peak_gib"] = dense_peak["peak_gib"] - base
    del dense

    # the Scheduler, tiered prefill: the FFN never takes row form on the card
    base = settled_gib()
    t0 = time.perf_counter()
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_cold_mode="fetch", prefill_mode="tiered", device="cuda")
    built = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    allocated = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    check(not {"w_up", "w_gate", "w_down"} & set(model.params["layers"]),
          "5j: the tiered Scheduler left the dense FFN on the card")
    check(not any(k.endswith("_rows") for k in sched.params["layers"]),
          "5j: the tiered Scheduler holds a row store")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    gen = torch.Generator().manual_seed(SEED + 17)
    reqs = [sched.submit(Request(prompt_tokens=torch.randint(cfg.n_vocab, (32,), generator=gen)
                                 .tolist(), max_new_tokens=32)) for _ in range(4)]
    t0 = time.perf_counter()
    sched.run_until_idle()
    wall = time.perf_counter() - t0
    toks = [r.tokens() for r in reqs]
    m = sched.metrics_snapshot()
    ticks = m["n_decode_steps"]
    want = L * (ticks + sched.graphs.captures + 4)  # ticks, the warm-up, 4 prefills
    got = {k: w.launches for k, w in wrappers.items()}
    check(got["sparse_ffn_block_v6"] == want and sum(got.values()) == want,
          f"5j: the tiered Scheduler launched {got}, want v6 {want} alone")
    check(all(len(t) == 32 for t in toks), "5j: a tiered request ended early")
    srow = {"path": "7B bf16 Scheduler, 4 slots, prefill tiered, fetch", "ticks": ticks,
            "launches": got["sparse_ffn_block_v6"], "build_s": built, "wall_s": wall,
            "decode_tok_s": m.get("decode_tps"), "ms_per_tick": 1e3 * m["t_decode_s"] / ticks,
            "rebalances": m["n_rebalances"], "swaps": m["n_swaps"],
            "h2d_bytes": m["rebalance_bytes"], "hot_store_bytes": sched.tiered_params.nbytes,
            "base_gib": base, "allocated_after_build_gib": allocated,
            "build_peak_gib": build_peak, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("phase 5j, 7B Scheduler tiered prefill:", json.dumps(srow))
    launches = sum(r["launches"] for r in rows) + srow["launches"]
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return rows, srow, dense_peak, launches


def phase_tiered_13b(cfg, scfg_all, weights, model, prompt, n_new, w8a8=None,
                     q8_0=True):
    """The 13B widths: a Q8_0 hot store of 27 of 108 groups (v6q) quantized
    from the bf16 rows, the f16 cold store built from the same rows, fetch
    mode, the tiered step captured as a CUDA graph, a rebalance after every
    step. Driven first (q8_0=True) with the Q8_0 attention, head and
    predictor stacks of `model`, then, where w8a8 = (attention, predictor
    stacks) is given, with W8A8 attention and predictor stacks and the same
    Q8_0 head (phase 5m: the JAX bench's headline row), over the same hot
    and cold stores and balancer. The tiered library pieces are driven
    directly, as bench.py's tiered harness drives them: the Engine builds
    no Q8_0 hot store, as the JAX Engine does not. Each prompt prefills
    through the tiered forward (the full FFN is not kept). Returns the rows
    and each kernel's launches over all drives."""
    import gc

    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.runtime.graphs import StepGraph
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse.balancer import Balancer
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.tiering import (
        ColdStore,
        init_tiered,
        make_tiered_ffn,
        tiered_layer_params,
    )

    L, E, F = cfg.n_layer, cfg.n_embd, cfg.n_ff
    scfg = SparseConfig(128, scfg_all.capacity_groups, hot_groups=TIER_HOT_13B)
    ng = F // 128
    base = settled_gib()
    t0 = time.perf_counter()
    # the bf16 rows on the host, drawn a layer at a time on the card: only
    # the hot blocks go back up
    rows = {k: torch.empty((L, ng, 128, E), dtype=torch.bfloat16)
            for k in ("w_up_rows", "w_gate_rows", "w_down_rows")}
    for il in range(L):
        rows["w_up_rows"][il].copy_(weights.draw("w_up", il, (F, E)).reshape(ng, 128, E))
        rows["w_gate_rows"][il].copy_(weights.draw("w_gate", il, (F, E)).reshape(ng, 128, E))
        rows["w_down_rows"][il].copy_(weights.draw("w_down", il, (E, F)).T.reshape(ng, 128, E))
    tp, fs = init_tiered(cfg, scfg, rows, scfg.hot_groups, quant="q8_0",
                         track_miss_groups=True, device="cuda")
    cold = ColdStore(cfg, scfg, rows)
    del rows
    gc.collect()
    fwd = make_forward(cfg, ffn_fn=make_tiered_ffn(cfg, scfg, cold, mode="fetch"),
                       stateful_ffn=True)
    bal = Balancer(cold=cold, scfg=scfg)
    built = time.perf_counter() - t0
    skew = skewed_pred_bias(cfg, 128).to("cuda", torch.bfloat16)
    flat = {k: v for k, v in model.params["sparse_flat"].items() if k.startswith("pred_")}
    flat["pred_down_b_all"] = skew.to(flat["pred_down_b_all"].dtype)
    drives = []
    if q8_0:
        drives.append(("13B Q8_0 tiered fetch (v6q hot store)", model.params["layers"],
                       {k: v for k, v in flat.items() if not k.endswith("_w8")},
                       {"quant_matmul_2d": 4 * L + 1, "quant_matmul_flat": 2 * L}, 0))
    if w8a8 is not None:
        attn, pred = w8a8
        drives.append(("13B W8A8 tiered fetch (v6q hot store)",
                       {**model.params["layers"], **attn},
                       {**{k: v for k, v in flat.items() if not k.endswith("_qt")}, **pred},
                       {"quant_matmul_2d": 1}, 6 * L))  # int8: attention, own predictor
    out, launches = [], {}
    for label, layers, pflat, per_fwd, int8_per_fwd in drives:
        lay, hot = tiered_layer_params(layers, tp)
        params = {**model.params, "layers": lay, "sparse_flat": {**pflat, **hot}}
        cache = init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")

        def one(tokens, positions, params=params, cache=cache):
            logits = fwd(params, tokens, positions, cache, fs)[:, -1]
            return logits, logits.argmax(-1)

        step = StepGraph(one, 1, torch.device("cuda"), capture=True, label=label,
                         restore=tuple(t for t in fs if t is not None))
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        i0 = qm.int8_matmul.launches
        torch.cuda.reset_peak_memory_stats()
        misses, walls, swapped = [], [], 0
        s0_all, b0 = bal.total_swaps, bal.bytes_h2d
        r0, t_bal0 = bal.rebalances, bal.t_total_s
        with torch.inference_mode():
            logits = fwd(params, torch.tensor([prompt], device="cuda"),
                         torch.arange(len(prompt), device="cuda")[None], cache, fs)
            tok = int(logits[0, -1].argmax())
            bal.rebalance(tp, fs.dfr, miss_g=fs.miss_g)
            fs.miss_g.zero_()
            n = len(prompt)
            for i in range(n_new - 1):
                m0, s0 = float(fs.miss.sum()), bal.total_swaps
                t0 = time.perf_counter()
                step.tokens.fill_(tok)
                step.positions.fill_(n + i)
                logits, nxt = step.run()
                tok = int(nxt[0])
                t1 = time.perf_counter()
                bal.rebalance(tp, fs.dfr, miss_g=fs.miss_g)
                fs.miss_g.zero_()
                walls.append((t1 - t0, time.perf_counter() - t1))
                check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
                misses.append(float(fs.miss.sum()) - m0)
                swapped += bal.total_swaps > s0
        steps = n_new - 1
        fwds = steps + 2  # steps, warm-up, prefill
        got = {k: w.launches for k, w in wrappers.items()}
        want = {"sparse_ffn_block_v6q": L * fwds, **{k: n * fwds for k, n in per_fwd.items()}}
        for name, n_got in got.items():
            check(n_got == want.get(name, 0),
                  f"{label}: {name} launched {n_got} times, want {want.get(name, 0)}")
        int8 = qm.int8_matmul.launches - i0
        check(int8 == int8_per_fwd * fwds,
              f"{label}: {int8} int8 products, want {int8_per_fwd * fwds}")
        rebal = bal.rebalances - r0
        row = {"path": label, "steps": steps, "graph": True,
               "launches": got["sparse_ffn_block_v6q"], "int8_products": int8,
               "build_s": built,
               "wall_ms_per_step": 1e3 * sum(w[0] for w in walls) / steps,
               "tok_s": steps / sum(w[0] for w in walls),
               "wall_ms_per_step_with_rebalance": 1e3 * sum(a + b for a, b in walls) / steps,
               "ms_per_rebalance": 1e3 * (bal.t_total_s - t_bal0) / rebal,
               "rebalances": rebal, "rebalances_that_swapped": swapped,
               "swaps": bal.total_swaps - s0_all, "h2d_bytes": bal.bytes_h2d - b0,
               "window": bal.window, "overruns": bal.overruns, **miss_trend(misses),
               "hot_store_bytes": tp.nbytes, "cold_store_bytes": cold.nbytes,
               "cold_store_dtype": str(cold.dtype)}
        if not out:  # the first drive starts from the initial hot set
            check(row["misses_per_token_last16"] < row["misses_per_token_first16"],
                  f"{label}: fetch misses a token did not fall: "
                  f"{row['misses_per_token_first16']} -> {row['misses_per_token_last16']}")

        def replay(step=step):
            with torch.inference_mode():
                step.run()

        rows_p, wall_ms = profile_steps(f"{label} steps (graph)", replay, 4)
        row["device_ms_per_step"] = sum(r[1] for r in rows_p) / 4
        row["kernels_per_step"] = sum(r[2] for r in rows_p) / 4
        row.update(replay_times(step))
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row.update(base_gib=base, own_peak_gib=row["peak_gib"] - base)
        print(f"phase {'5m(a)' if w8a8 and label.startswith('13B W8A8') else '5j'}, "
              f"{label}:", json.dumps(row))
        out.append(row)
        for name, n_got in got.items():
            launches[name] = launches.get(name, 0) + n_got
        del step, params, cache, one, replay
        torch.cuda.empty_cache()
    del cold, tp, fs, bal
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def tier_summary(gate, rows7, sched, row13, h5, dense_peak) -> dict:
    """Phase 5j beside phase 5h's 7B graph steps of the same call: tok/s,
    wall and device ms a step and peak memory of the tiered paths, the
    all-on-device sparse step and the dense one."""
    keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "peak_gib", "base_gib",
            "own_peak_gib", "ms_per_rebalance",
            "swaps", "h2d_bytes", "window", "overruns", "misses_per_token_first16",
            "misses_per_token_last16", "host_library_ms_per_layer", "host_ms_per_layer",
            "host_share_of_step", "hot_store_bytes", "cold_store_bytes")
    out = {"f32_gate": gate, "tiered": [{"path": r["path"], **{k: r[k] for k in keys if k in r}}
                                       for r in rows7 + [row13]], "scheduler": sched}
    for r in h5 or []:
        if r["path"] in ("7B bf16 sparse", "7B bf16 dense", "13B Q8_0 sparse"):
            g = r["graph"]
            out[r["path"]] = {"tok_s": g["tok_s"], "wall_ms_per_step": g["wall_ms_per_step"],
                              "device_ms_per_step": g["device_ms_per_step"],
                              "peak_gib": PEAKS.get(r["path"])}
    out["7B bf16 dense memory"] = dense_peak
    return out


def tiered_phases(greedy_cfg) -> int:
    """`chip_smoke.py --tiered`: phase 5j alone, for working on it; prints
    its summary and no result."""
    import torch

    cfg = prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    gate = tier_f32_gate()
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    rows7, sched, dense_peak, _ = phase_tiered_7b(model, greedy_cfg, prompt, 64)
    del model
    torch.cuda.empty_cache()
    cfg, scfg, weights, model, eng = q8_13b_engine(greedy_cfg)
    del eng
    for k in [k for k in model.params["sparse_flat"] if not k.startswith("pred_")]:
        del model.params["sparse_flat"][k]
    torch.cuda.empty_cache()
    (row13,), _ = phase_tiered_13b(cfg, scfg, weights, model, prompt, 64)
    print("phase 5j summary:", json.dumps(tier_summary(gate, rows7, sched, row13, None,
                                                       dense_peak)))
    return 0


# --- phase 5k: Mixture-of-Experts at Qwen3-30B-A3B widths --------------------
# Qwen/Qwen3-30B-A3B config.json: 48 layers, hidden 2048, 32 heads, 4 KV heads,
# head_dim 128, 128 experts of width 768, 8 used, norm_topk_prob, vocab 151936,
# rope theta 1e6, rms eps 1e-6, untied head. Random weights from SEED, built on
# the card.

MOE_TOL = 1e-4  # the f32 gates' FFN outputs against dense mode, of the output's scale
MOE_HOT_EXPERTS = 32  # of 128: expert tiering's hot set, 192 of 768 groups a layer
MOE_SKEW = 4.0  # a random fifth of each layer's experts: their router columns scaled by this


def qwen3moe_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen3moe", n_layer=L, n_embd=2048, n_head=32, n_head_kv=4,
                       head_dim=128, n_ff=6144, n_ff_exp=768, n_vocab=151936, n_expert=128,
                       n_expert_used=8, norm_topk_prob=True, norm_eps=1e-6,
                       rope_freq_base=1e6)


def random_moe_model(cfg, dtype, seed):
    """A LoadedModel with the MoE loader's keys, weights drawn on the card:
    N(0, 0.02) projections, router and experts (one resident copy, the
    port's (L, X, Fe, E) stacks), q/k norms 1 + N(0, 0.1), ones for the
    block norms."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32

    def normal(shape, std=0.02, dt=dtype):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(0.0, std, generator=gen)

    L, E, H, Hkv, D = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim
    X, Fe, V = cfg.n_expert, cfg.n_ff_exp, cfg.n_vocab
    ones = dict(dtype=f32, device="cuda")
    layers = {"attn_norm_w": torch.ones((L, E), **ones), "ffn_norm_w": torch.ones((L, E), **ones),
              "wq": normal((L, E, H * D)), "wk": normal((L, E, Hkv * D)),
              "wv": normal((L, E, Hkv * D)), "wo": normal((L, H * D, E)),
              "attn_q_norm_w": 1.0 + normal((L, D), 0.1, f32),
              "attn_k_norm_w": 1.0 + normal((L, D), 0.1, f32),
              "w_router": normal((L, E, X))}
    for name in ("up", "gate", "down"):
        layers[f"w_{name}_exps"] = normal((L, X, Fe, E))
    params = {"tok_embd": normal((V, E)), "output_norm_w": torch.ones((E,), **ones),
              "output": normal((E, V)), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def skew_router(w_router, seed):
    """In place: a random fifth of each layer's experts get their router
    columns scaled by MOE_SKEW, so they take most of the routing mass."""
    import torch

    gen = torch.Generator(device=w_router.device).manual_seed(seed)
    L, _, X = w_router.shape
    for il in range(L):
        hot = torch.randperm(X, generator=gen, device=w_router.device)[:X // 5]
        w_router[il][:, hot] *= MOE_SKEW


def greedy_tokens(fwd, params, cfg, prompt, steps, *state):
    """The prompt's prefill and `steps` greedy decode steps through a bare
    forward on a cache of its own: the steps + 1 greedy tokens."""
    import torch

    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    cache = init_cache(cfg, 1, len(prompt) + steps + 1, torch.float32, "cuda")
    toks = []
    with torch.inference_mode():
        logits = fwd(params, torch.tensor([prompt], device="cuda"),
                     torch.arange(len(prompt), device="cuda")[None], cache, *state)
        for i in range(steps + 1):
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            toks.append(int(logits[0, -1].argmax()))
            if i < steps:
                logits = fwd(params, torch.tensor([[toks[-1]]], device="cuda"),
                             torch.tensor([[len(prompt) + i]], device="cuda"), cache, *state)
    return toks


def moe_f32_gates(prompt, steps: int = 8) -> dict:
    """Qwen3-30B-A3B widths cut to 4 layers, f32. (1) The fused mode (v1)
    against dense mode: the dense forward feeds each layer's FFN input to
    the fused FFN too, whose output must lie within MOE_TOL of the dense
    one's scale at every layer of the prompt and `steps` decode steps; the
    fused forward's routed experts at every layer and step and its greedy
    tokens must equal the dense forward's. (2) Expert tiering in host mode
    (eager), the router skewed, 32 of 128 experts hot, an f32 cold store:
    its FFN within MOE_TOL of dense mode's on the same inputs, with misses."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.moe import (
        MoEColdStore,
        expert_groups,
        make_moe_ffn,
        make_tiered_moe_ffn,
        moe_layout,
        moe_rows_layout,
        route,
    )
    from sparkinfer_tpu_torch.sparse.tiering import init_tiered, tiered_layer_params

    t0 = time.perf_counter()
    cfg = qwen3moe_config(4)
    model = random_moe_model(cfg, torch.float32, SEED + 31)
    params = {**model.params, "layers": moe_layout(model.params["layers"], cfg)}
    dense, fused = make_moe_ffn(cfg, mode="dense"), make_moe_ffn(cfg, mode="pallas")
    E = cfg.n_embd
    errs, routes = [], {"dense": [], "pallas": []}

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    def gate(lp, x):
        want = dense(lp, x)
        errs.append(rel(fused(lp, x), want))
        routes["dense"].append(route(cfg, lp, x.reshape(-1, E))[0])
        return want

    def kernel(lp, x):
        routes["pallas"].append(route(cfg, lp, x.reshape(-1, E))[0])
        return fused(lp, x)

    n0 = sf.sparse_ffn_block.launches
    toks = {name: greedy_tokens(make_forward(cfg, ffn_fn=f), params, cfg, prompt, steps)
            for name, f in (("dense", gate), ("pallas", kernel))}
    n_fwd = 4 * (steps + 1)
    check(sf.sparse_ffn_block.launches - n0 == 2 * n_fwd and len(errs) == n_fwd,
          f"5k gate: {sf.sparse_ffn_block.launches - n0} v1 launches, {len(errs)} layers")
    worst = max(errs)
    check(worst <= MOE_TOL, f"5k gate: a layer's fused FFN is {worst:.3e} of its scale off")
    check(toks["dense"] == toks["pallas"], f"5k gate: greedy tokens differ {toks}")
    check(all(torch.equal(a, b) for a, b in zip(routes["dense"], routes["pallas"])),
          "5k gate: the routed experts differ")
    row = {"layers": 4, "steps": steps, "layer_outputs": n_fwd, "worst_rel_err": worst,
           "tokens": toks["dense"]}

    # (2) host-mode expert tiering on the same f32 weights
    del params
    skew_router(model.params["layers"]["w_router"], SEED + 32)
    G, ng_e = expert_groups(cfg, 128)
    scfg = SparseConfig(group_size=G, hot_groups=MOE_HOT_EXPERTS * ng_e)
    rows = moe_rows_layout(model.params["layers"], cfg)
    tp, fs = init_tiered(cfg, scfg, rows, scfg.hot_groups)
    cold = MoEColdStore(cfg, scfg, {k: v for k, v in rows.items() if k.endswith("_rows")},
                        dtype=torch.float32)
    tiered = make_tiered_moe_ffn(cfg, scfg, cold, mode="host")
    host_errs = []

    def both(lp, x, state, il):
        want = dense(lp, x)
        host_errs.append(rel(tiered(lp, x, state, il), want))
        return want

    lay, hot = tiered_layer_params(rows, tp)
    params = {**model.params, "layers": lay, "sparse_flat": hot}
    host_steps = 4
    greedy_tokens(make_forward(cfg, ffn_fn=both, stateful_ffn=True), params, cfg,
                  prompt[:16], host_steps, fs)
    worst = max(host_errs)
    misses = float(fs.miss.sum())
    check(worst <= MOE_TOL, f"5k host mode: a layer's FFN is {worst:.3e} of its scale off")
    check(misses > 0, "5k host mode: no routed expert was cold")
    row["host_mode"] = {"layers": 4, "prompt": 16, "steps": host_steps,
                        "layer_outputs": len(host_errs), "worst_rel_err": worst,
                        "cold_routed_experts": misses, "complement_calls": cold.n_calls,
                        "hot_experts": MOE_HOT_EXPERTS}
    row["seconds"] = time.perf_counter() - t0
    print("phase 5k, f32 gates (Qwen3-30B-A3B widths, 4 layers):", json.dumps(row))
    return row


def moe_v1_rows(model, path="MoE", Ns=(1, 32)) -> list:
    """v1 (`sparse_ffn_block`, mask_mode "scale") against its plain version
    at the MoE shapes of the main path, N = 1 (decode) and 32 (prefill):
    each token's k experts (C = k * ng_e groups of G rows), router weights
    as the scale, bf16 row stores of one random layer (views of the expert
    stacks), the model's activation, and its up and gate bias rows
    (gpt-oss's bu_sel, bg_sel) where it has them; over 64 random draws that
    keep the L2 cold."""
    import torch

    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.sparse.moe import expert_rows, moe_layout

    cfg = model.config
    lay = moe_layout(model.params["layers"], cfg)
    up, gate, down = lay["moe_up_rows"], lay["moe_gate_rows"], lay["moe_down_rows"]
    ub, gb = lay.get("moe_up_b_rows"), lay.get("moe_gate_b_rows")
    L, R, G, E = up.shape
    k, ng_e = cfg.n_expert_used, R // cfg.n_expert
    C, act = k * ng_e, cfg.traits.act
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    out = []
    for N in Ns:
        sets = []
        for _ in range(N_SETS):
            il = int(torch.randint(L, (1,), generator=gen, device="cuda"))
            idx = torch.stack([torch.randperm(cfg.n_expert, generator=gen, device="cuda")[:k]
                               for _ in range(N)]).to(torch.int32)
            w = torch.rand((N, k), generator=gen, device="cuda")
            w = w / w.sum(-1, keepdim=True)
            scale = w[:, :, None, None].expand(N, k, ng_e, G).reshape(N, C, G).contiguous()
            rows = expert_rows(idx, ng_e)
            # the bias rows gathered once, outside the timed calls
            kw = {} if ub is None else {"bu_sel": ub[il][rows.long()],
                                        "bg_sel": gb[il][rows.long()]}
            sets.append((il, rows, scale, kw))
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)

        def call(f, i):
            il, rows, scale, kw = sets[i % N_SETS]
            return f(x, rows, scale, up[il], gate[il], down[il], act=act, mask_mode="scale",
                     **kw)

        got = call(sf.sparse_ffn_block, 0)
        torch.cuda.synchronize()
        err, tol = compare(f"v1 {path} N={N}", got, call(sf.sparse_ffn_block_plain, 0))
        ms = graph_ms(lambda i: call(sf.sparse_ffn_block, i), N_SETS)
        plain_ms = graph_ms(lambda i: call(sf.sparse_ffn_block_plain, i), 8 if N == 1 else 2)
        rows_read = sum(len(torch.unique(r)) for _, r, _, _ in sets) / N_SETS
        nbytes = 3 * rows_read * G * E * 2 + N * E * 2 + N * C * G * 4 + N * C * 4 + N * E * 4
        if ub is not None:  # the up and gate bias rows: gathered in bf16, read as f32
            nbytes += 2 * N * C * G * 4
        bound_ms, by = bound(nbytes, 2 * 3 * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel="sparse_ffn_block", path=path, N=N, C=C, G=G, E=E, act=act,
                   biases=ub is not None,
                   mask_mode="scale", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   rows_read=rows_read, GB_s=nbytes / (ms * 1e-3) / 1e9,
                   plan=sf.v1_plan(x.device, N, C, E, G))
        print("kernel check:", json.dumps(row))
        out.append(row)
    return out


def moe_engine(label, model, greedy, prompt, n_new, mode, phase="5k", eager_stream=False,
               **engine_kw) -> dict:
    """One Engine(moe_mode=mode, **engine_kw) over the full model: the main
    path (launch counts 0 just before, read just after: v1 once an MoE
    layer a forward in "pallas" mode, prefill included, none in "dense"), the
    decode timings and a profile (v1's share of the device time), the
    replay span, the first decode logits of the graph against an eager
    engine's (bit-equal; with eager_stream its whole greedy stream too),
    and the prefill's wall ms."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    cfg = model.config  # v1 once an MoE layer: deepseek2's leading dense layers run none
    per_fwd = cfg.n_layer - cfg.n_dense_lead if mode == "pallas" else 0
    kw = {"max_seq": 1024, "sampler": greedy, "device": "cuda", "moe_mode": mode,
          **engine_kw}
    eng = Engine(model, **kw)
    launches = main_path(label, eng, prompt, n_new,
                         lambda runs: {"sparse_ffn_block": per_fwd * (runs + 1)})
    toks, first, timing, (rows, steps) = decode_timing(eng, prompt, n_new)
    v1 = [(k, ms, n) for k, ms, n in rows if "v1_" in k]
    check(sum(n for _, _, n in v1) == per_fwd * steps and all("v1_ffn" in k for k, _, _ in v1),
          f"{phase} {label}: the profiled steps launched {v1}, want {per_fwd} v1_ffn a step")
    device = sum(r[1] for r in rows)
    eager = Engine(model, cuda_graph=False, **kw)
    cache, st = eager.new_cache(), eager.new_sampler_state()
    tok, cache, st, n = eager.prefill(prompt, cache, st)
    eager.decode_step(tok, n, cache, st)
    check(torch.equal(first, eager.last_logits), f"{phase} {label}: the replay's first decode "
          f"logits differ from the eager step's by "
          f"{(first - eager.last_logits).abs().max().item():.3e}")
    if eager_stream:
        eager_toks = eager.generate(prompt, n_new)
        check(eager_toks == toks, f"{phase} {label}: graph stream {toks} differs from the "
                                  f"eager stream {eager_toks}")
    del eager, cache
    step = eng.graphs.get(eng.cache, 1, "decode", None)
    cache, st = eng.new_cache(), eng.new_sampler_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        eng.prefill(prompt, cache, st)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / 4
    row = {"path": label, "moe_mode": mode, "launches": launches["sparse_ffn_block"],
           **timing, "v1_device_ms_per_step": sum(ms for _, ms, _ in v1) / steps,
           "v1_share_of_device": sum(ms for _, ms, _ in v1) / device,
           "profiled_device_ms_per_step": device / steps, **replay_times(step),
           "capture_s": step.stats["capture_s"], "graph_pool_bytes": step.stats["pool_bytes"],
           "prefill_ms": prefill_ms, "prefill_tokens": len(prompt), "peak_gib": PEAKS[label],
           "tokens_first8": toks[:8], "eager_stream_equal": eager_stream}
    print(f"phase {phase}, {label}:", json.dumps(row))
    return row


def moe_scheduler(model, greedy, n_new: int = 32) -> dict:
    """The Scheduler over the full model (dense MoE, the tick a CUDA graph):
    8 greedy requests of 32-token prompts and 32 new tokens on 4 slots,
    max_seq 1024; every tick's logits finite, no counted kernel launched."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler

    sched = Scheduler(model, n_slots=4, max_seq=1024, sampler=greedy, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 34)
    prompts = [torch.randint(model.config.n_vocab, (32,), generator=gen).tolist()
               for _ in range(8)]
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    while sched.step():
        check(bool(torch.isfinite(sched.last_logits).all()), "5k Scheduler: non-finite logits")
    wall = time.perf_counter() - t0
    check(all(len(r.tokens()) == n_new for r in reqs), "5k Scheduler: short streams")
    launches = {k: w.launches for k, w in wrappers.items()}
    check(not any(launches.values()), f"5k Scheduler: dense MoE launched {launches}")
    check(sched.graphs.captures == 1, f"5k Scheduler: {sched.graphs.captures} captures")
    m = sched.metrics_snapshot()
    ticks = m["n_decode_steps"]
    row = {"path": "Qwen3-30B-A3B Scheduler, dense MoE", "slots": 4, "requests": 8,
           "ticks": ticks, "decode_tok_s": (m["n_tokens_generated"] - m["n_requests"])
           / m["t_decode_s"], "ms_per_tick": 1e3 * m["t_decode_s"] / ticks,
           "prefill_tps": m["prefill_tps"], "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("phase 5k, Scheduler:", json.dumps(row))
    return row


def moe_tiered_drop(greedy_prompt, n_new: int = 64) -> dict:
    """Expert tiering at Qwen3-30B-A3B widths cut to 12 layers, bf16, the
    router skewed, 32 of 128 experts hot (init_tiered: the first 32), an f16
    cold store in host RAM, the expert stacks then dropped from the card;
    drop mode, the tiered step captured as a CUDA graph and driven
    directly (no Engine option wires expert tiering, as in the JAX
    package), a rebalance after every step. The misses a token of the last
    16 steps must lie below those of the first 16."""
    import gc

    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.graphs import StepGraph
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse.balancer import Balancer
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.moe import (
        MoEColdStore,
        expert_groups,
        make_tiered_moe_ffn,
        moe_rows_layout,
    )
    from sparkinfer_tpu_torch.sparse.tiering import init_tiered, tiered_layer_params

    base = settled_gib()
    t0 = time.perf_counter()
    cfg = qwen3moe_config(12)
    model = random_moe_model(cfg, torch.bfloat16, SEED + 41)
    skew_router(model.params["layers"]["w_router"], SEED + 42)
    G, ng_e = expert_groups(cfg, 128)
    scfg = SparseConfig(group_size=G, hot_groups=MOE_HOT_EXPERTS * ng_e)
    rows = moe_rows_layout(model.params["layers"], cfg)
    tp, fs = init_tiered(cfg, scfg, rows, scfg.hot_groups)
    cold = MoEColdStore(cfg, scfg, {k: v for k, v in rows.items() if k.endswith("_rows")})
    lay, hot = tiered_layer_params(rows, tp)
    for name in ("w_up_exps", "w_gate_exps", "w_down_exps"):
        lay.pop(name)
    params = {**model.params, "layers": lay, "sparse_flat": hot}
    del model, rows
    gc.collect()
    torch.cuda.empty_cache()
    built_s = time.perf_counter() - t0
    resident_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    fwd = make_forward(cfg, ffn_fn=make_tiered_moe_ffn(cfg, scfg, cold, mode="drop"),
                       stateful_ffn=True)
    bal = Balancer(cold=cold, scfg=scfg)
    cache = init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")

    def one(tokens, positions):
        logits = fwd(params, tokens, positions, cache, fs)[:, -1]
        return logits, logits.argmax(-1)

    step = StepGraph(one, 1, torch.device("cuda"), capture=True, label="MoE tiered step",
                     restore=(fs.dfr, fs.miss, fs.steps))
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    misses, walls, swapped = [], [], 0
    prompt = greedy_prompt
    with torch.inference_mode():
        logits = fwd(params, torch.tensor([prompt], device="cuda"),
                     torch.arange(len(prompt), device="cuda")[None], cache, fs)
        tok = int(logits[0, -1].argmax())
        bal.rebalance(tp, fs.dfr)
        for i in range(n_new - 1):
            m0, s0 = float(fs.miss.sum()), bal.total_swaps
            t1 = time.perf_counter()
            step.tokens.fill_(tok)
            step.positions.fill_(len(prompt) + i)
            logits, nxt = step.run()
            tok = int(nxt[0])
            t2 = time.perf_counter()
            bal.rebalance(tp, fs.dfr)
            walls.append((t2 - t1, time.perf_counter() - t2))
            check(bool(torch.isfinite(logits).all()), "5k tiered: non-finite logits")
            misses.append(float(fs.miss.sum()) - m0)
            swapped += bal.total_swaps > s0
    got = {k: w.launches for k, w in wrappers.items()}
    check(not any(got.values()), f"5k tiered: the plain tiered FFN launched {got}")
    steps = n_new - 1
    row = {"path": "Qwen3-30B-A3B tiered drop, 12 layers", "steps": steps, "graph": True,
           "hot_experts": MOE_HOT_EXPERTS, "build_s": built_s,
           "wall_ms_per_step": 1e3 * sum(w[0] for w in walls) / steps,
           "tok_s": steps / sum(w[0] for w in walls),
           "wall_ms_per_step_with_rebalance": 1e3 * sum(a + b for a, b in walls) / steps,
           "ms_per_rebalance": 1e3 * bal.t_total_s / bal.rebalances,
           "rebalances": bal.rebalances, "rebalances_that_swapped": swapped,
           "swaps": bal.total_swaps, "h2d_bytes": bal.bytes_h2d, "window": bal.window,
           "overruns": bal.overruns, **miss_trend(misses),
           "hot_store_bytes": tp.nbytes, "cold_store_bytes": cold.nbytes,
           "resident_gib": resident_gib}
    check(row["misses_per_token_last16"] < row["misses_per_token_first16"],
          f"5k tiered: drop misses a token did not fall: {row['misses_per_token_first16']} "
          f"-> {row['misses_per_token_last16']}")

    def replay():
        with torch.inference_mode():
            step.run()

    rows_p, _ = profile_steps("MoE tiered steps (graph)", replay, 4)
    row["device_ms_per_step"] = sum(r[1] for r in rows_p) / 4
    row.update(replay_times(step))
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    row.update(base_gib=base)
    print("phase 5k, expert tiering:", json.dumps(row))
    del step, params, cold, tp, fs, cache, bal
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_moe(greedy, L: int = 48) -> dict:
    """Phase 5k: the f32 gates, then Qwen3-30B-A3B at full width and depth
    L (48; the full run's child takes FULL_RUN_MOE_L) in bf16 (v1 at the MoE
    shapes, the pallas and dense Engines, the Scheduler), then expert
    tiering at 12 layers. Returns its summary, with v1's launches on the
    main paths."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5k: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    prompt = torch.randint(151936, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    gates = moe_f32_gates(prompt)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen3moe_config(L)
    t1 = time.perf_counter()
    model = random_moe_model(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    weights = sum(t.numel() for t in [model.params["tok_embd"], model.params["output"],
                                      *model.params["layers"].values()])
    print(f"model: Qwen3-30B-A3B widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"Hkv={cfg.n_head_kv} D={cfg.head_dim} X={cfg.n_expert} k={cfg.n_expert_used} "
          f"Fe={cfg.n_ff_exp} V={cfg.n_vocab}, bf16, {weights} weights built in "
          f"{time.perf_counter() - t1:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated")
    v1_rows = moe_v1_rows(model)
    engines = [moe_engine(f"Qwen3-30B-A3B bf16 {mode}", model, greedy, prompt, 64, mode)
               for mode in ("pallas", "dense")]
    gc.collect()
    torch.cuda.empty_cache()
    sched = moe_scheduler(model, greedy)
    del model
    tiered = moe_tiered_drop(prompt)
    summary = {"f32_gates": gates, "v1_moe": v1_rows, "engines": engines, "scheduler": sched,
               "tiered": tiered, "v1_launches": engines[0]["launches"], "weights": weights,
               "seconds": time.perf_counter() - t0}
    return summary


def moe_summary(moe) -> dict:
    """Phase 5k's numbers in brief, for the end of the full run's output."""
    keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "v1_share_of_device",
            "replay_span_ms", "prefill_ms", "peak_gib", "launches")
    return {"f32_gate_worst": moe["f32_gates"]["worst_rel_err"],
            "host_mode_worst": moe["f32_gates"]["host_mode"]["worst_rel_err"],
            "v1_moe": [{k: r[k] for k in ("N", "ms", "bound_ms", "plain_ms", "x_bound")}
                       for r in moe["v1_moe"]],
            "engines": [{"path": r["path"], **{k: r[k] for k in keys}} for r in moe["engines"]],
            "scheduler": {k: moe["scheduler"][k] for k in ("decode_tok_s", "ms_per_tick",
                                                           "peak_gib")},
            "tiered": {k: moe["tiered"][k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "ms_per_rebalance", "swaps",
                "misses_per_token_first16", "misses_per_token_last16", "peak_gib",
                "resident_gib", "hot_store_bytes", "cold_store_bytes")},
            "seconds": moe["seconds"]}


# --- phase 5l: the single-sequence runtime and the CLI ------------------------


def stream_with_logits(eng, prompt, n_new, **kw):
    """(tokens, each token's (1, V) logits, cloned) of a streamed generate."""
    import torch

    toks, logits = [], []
    for tok in eng.generate(prompt, n_new, stream=True, **kw):
        toks.append(tok)
        logits.append(eng.last_logits.clone())
    check(all(bool(torch.isfinite(lg).all()) for lg in logits), "non-finite logits")
    return toks, logits


def graph_eager_pair(label, graph_eng, eager_eng, prompt, n_new, **kw) -> dict:
    """A graph engine's stream against an eager engine's over the same
    params: tokens equal, every token's logits bit-equal, and no graph
    captured in the compared run (the graph engine's step is captured by a
    short generate first, so its decode tok/s leaves the capture out)."""
    import torch

    graph_eng.generate(prompt, 2)
    captures = graph_eng.graphs.captures
    graph_eng.perf.__init__()
    eager_eng.perf.__init__()
    g_toks, g_logits = stream_with_logits(graph_eng, prompt, n_new, **kw)
    e_toks, e_logits = stream_with_logits(eager_eng, prompt, n_new, **kw)
    bad = [i for i, (a, b) in enumerate(zip(g_logits, e_logits)) if not torch.equal(a, b)]
    check(g_toks == e_toks, f"phase 5l, {label}: graph and eager streams differ: "
                            f"{g_toks} vs {e_toks}")
    check(not bad, f"phase 5l, {label}: logits of steps {bad[:8]} differ between graph "
                   f"and eager")
    new = graph_eng.graphs.captures - captures
    check(captures == 1 and new == 0, f"phase 5l, {label}: {captures} captures before, "
                                      f"{new} in the compared generate")
    return {"tokens": len(g_toks), "graph_decode_tok_s": graph_eng.perf.decode_tps,
            "eager_decode_tok_s": eager_eng.perf.decode_tps, "captures": new}


def drafter_run(label, drafter, target, prompt, n_new) -> dict:
    """One drafter's generate with v6's count set to 0 before and read
    after: accept rate, wall ms a round, v6 launches a round (verify
    forwards only: the drafts run on a dense engine). A short generate
    first captures the verify and draft graphs, out of the measured run."""
    from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v6 as v6

    drafter.generate(prompt, 8)
    drafter.stats = type(drafter.stats)()
    v6.launches = 0
    d0, t_dec0 = target.perf.n_decode, target.perf.t_decode_s
    t0 = time.perf_counter()
    toks = drafter.generate(prompt, n_new)
    wall = time.perf_counter() - t0
    st = drafter.stats
    steps = target.perf.n_decode - d0  # plain steps taken where nothing was drafted
    row = {"drafter": label, "tokens": len(toks), "rounds": st.n_rounds,
           "drafted": st.n_drafted, "accepted": st.n_accepted,
           "accept_rate": st.accept_rate, "plain_steps": steps,
           "ms_per_token": 1e3 * wall / max(len(toks), 1),
           # the plain steps' time taken out (where nothing was proposed)
           "ms_per_round": (1e3 * (wall - (target.perf.t_decode_s - t_dec0)) / st.n_rounds
                            if st.n_rounds else None),
           "v6_launches": v6.launches}
    return row, toks


def echo_params(tok_embd) -> dict:
    """The embedding scaled by 5000 and the head tied to the unscaled one:
    the residual stream is the input token's embedding up to a few percent,
    so every logit but the input token's is about 64 |e| cos, below 6, and
    the input token's 64 |e|, about 82: greedy decoding repeats its last
    token. A measurement device: drafts of a repeating sequence are accepted."""
    return {"tok_embd": tok_embd * 5000.0, "output": tok_embd.T}


def f32_gates(scfg, tmp, n_new: int = 32) -> dict:
    """7B widths cut to 4 layers, f32: the speculative (dense draft on the
    same weights), lookup and lookahead greedy streams of the sparse target
    against its plain greedy decode (a position where they differ must be a
    tie: the plain logits' top-2 gap there below 1e-4 of their scale); and
    the LoRA re-merge against a plain merge (`lora_f32_gate`)."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.runtime.speculative import SpeculativeEngine

    cfg = prosparse_config(4, 4096, 32, 11008, 32000, 1024)
    model = random_model(cfg, torch.float32, "cuda", SEED + 17)
    greedy = SamplerConfig(temp=0.0)
    kw = dict(max_seq=256, sampler=greedy, kv_dtype=torch.float32, device="cuda")
    target = Engine(model, sparse=scfg, **kw)
    draft = Engine(model, **kw)
    # echo weights: greedy decoding repeats, so lookup and lookahead draft
    # and accept (phase_runtime says why)
    tied = Engine(LoadedModel(config=cfg, params={**target.params,
                                                  **echo_params(model.params["tok_embd"])}),
                  sparse=scfg, sparse_preprepared=True, **kw)
    prompt = [int(t) for t in torch.randint(cfg.n_vocab, (8,), generator=torch.Generator()
                                            .manual_seed(SEED + 18))] * 3
    rows = {}
    for name, eng, make in (
            ("speculative", target, lambda e: SpeculativeEngine(e, draft, n_draft=5)),
            ("lookup", tied, lambda e: LookupEngine(e, n_draft=5)),
            ("lookahead", tied, lambda e: LookaheadEngine(e, n_draft=5))):
        want, logits = stream_with_logits(eng, prompt, n_new)
        dr = make(eng)
        got = dr.generate(prompt, n_new)
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        gap = None
        if diff is not None:
            top2 = torch.topk(logits[diff][0], 2).values
            gap = float(top2[0] - top2[1]) / float(logits[diff].abs().max())
            check(gap < 1e-4, f"phase 5l, f32 gate, {name}: token {diff} differs from plain "
                              f"greedy decode with a top-2 gap of {gap:.3e} of the scale")
        else:
            check(len(got) == len(want), f"phase 5l, f32 gate, {name}: {len(got)} tokens")
        check(dr.stats.n_rounds > 0, f"phase 5l, f32 gate, {name}: no round drafted")
        rows[name] = {"equal": diff is None, "first_difference": diff, "top2_gap": gap,
                      "rounds": dr.stats.n_rounds, "accept_rate": dr.stats.accept_rate}
    del target, draft, tied
    path = tmp / "lora-4l.gguf"
    rows["lora"] = lora_f32_gate(model, scfg, prompt, path, *lora_adapter(path, cfg))
    del model
    torch.cuda.empty_cache()
    print("phase 5l, f32 gates (7B widths, 4 layers: drafters against plain greedy, LoRA "
          "re-merge against a plain merge):", json.dumps(rows))
    return rows


def lora_adapter(path, cfg, rank: int = 8, seed: int = SEED + 31):
    """A rank-8 adapter over attn_q, ffn_up and ffn_down of every layer,
    written by the port's GGUF writer; returns its (A, B) by (layer, key)."""
    import numpy as np

    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    E, F = cfg.n_embd, cfg.n_ff
    w = GGUFWriter(str(path), "llama")
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", np.float32(2.0 * rank))
    ab = {}
    for il in range(cfg.n_layer):
        for name, key, (out_d, in_d) in (("attn_q", "wq", (E, E)), ("ffn_up", "w_up", (F, E)),
                                         ("ffn_down", "w_down", (E, F))):
            A = (rng.standard_normal((rank, in_d)) * 0.02).astype(np.float32)
            B = (rng.standard_normal((out_d, rank)) * 0.02).astype(np.float32)
            w.add_tensor(f"blk.{il}.{name}.lora_a", A, GGMLType.F32)
            w.add_tensor(f"blk.{il}.{name}.lora_b", B, GGMLType.F32)
            ab[(il, key)] = (A, B)
    w.write()
    return ab, 2.0  # alpha / rank


def first_logits(eng, prompt):
    """(prefill logits, first decode step's logits) of a greedy engine: the
    masked-dense prefill reads the dense weights, the decode step (a graph
    replay) the sparse stores."""
    cache, st = eng.own_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    pre = eng.last_logits.float().clone()
    eng.decode_step(tok, n, cache, st)
    return pre, eng.last_logits.float().clone()


def lora_round_trip(model, eng, path, prompt) -> tuple:
    """LoraMerger over the model's weights and `eng`'s stores, in place:
    scale 1, then 0 (the base logits back bit for bit), then 1 again (the
    merged logits back bit for bit). Returns (base, merged) first logits."""
    import torch

    from sparkinfer_tpu_torch.models.lora import LoraMerger

    base = first_logits(eng, prompt)
    merger = LoraMerger([model.params, eng.params], model.config, [str(path)])
    merger.merge([1.0])
    merged = first_logits(eng, prompt)
    merger.merge([0.0])
    again = first_logits(eng, prompt)
    check(all(torch.equal(a, b) for a, b in zip(again, base)),
          "phase 5l, LoRA: scale 0 did not restore the base logits")
    merger.merge([1.0])
    again = first_logits(eng, prompt)
    check(all(torch.equal(a, b) for a, b in zip(again, merged)),
          "phase 5l, LoRA: a second merge at scale 1 gave other logits")
    for a, b in zip(merged, base):
        moved = float((a - b).abs().max())
        check(moved > 1e-2 * float(b.abs().max()),
              f"phase 5l, LoRA: the adapter moved the logits by {moved:.3e}")
    return base, merged, merger


def lora_targets(model) -> dict:
    """Clones of the dense weights the adapter of `lora_adapter` touches,
    taken before any merge: the references merge into these themselves."""
    return {k: model.params["layers"][k].clone() for k in ("wq", "w_up", "w_down")}


def merged_engine_logits(model, layers, prompt, **kw):
    """First logits of an engine built afresh (its own sparse stores) on the
    model with `layers`' weights in place of its own."""
    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.engine import Engine

    params = {**model.params, "layers": {**model.params["layers"], **layers}}
    return first_logits(Engine(LoadedModel(config=model.config, params=params), **kw), prompt)


def lora_f32_gate(model, scfg, prompt, path, ab, s) -> dict:
    """f32: the sparse engine re-merged in place (dense weights and v6 flat
    stores) against an engine built on a plain torch merge (W + s (B A)^T)
    of the base weights cloned before any merge, prefill and first decode
    logits within 1e-3 of their scale."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    kw = dict(max_seq=128, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
              sparse=scfg, device="cuda")
    layers = lora_targets(model)
    _, merged, merger = lora_round_trip(model, Engine(model, **kw), path, prompt)
    merger.merge([0.0])
    del merger
    for (il, key), (A, B) in ab.items():
        layers[key][il] += s * (torch.tensor(B, device="cuda") @ torch.tensor(A, device="cuda")).T
    ref = merged_engine_logits(model, layers, prompt, **kw)
    errs = []
    for got, want in zip(merged, ref):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-3 * scale, f"phase 5l, LoRA f32: merged logits differ from the plain "
                                   f"merge by {err:.3e} (scale {scale:.3e})")
        errs.append(err / scale)
    return {"prefill_rel_err": errs[0], "decode_rel_err": errs[1]}


def phase_lora(model, scfg, sparse_eng, prompt, tmp) -> dict:
    """LoRA on the 7B bf16 model: the in-place re-merge (`LoraMerger`) into
    the model's weights and the sparse engine's flat stores moves the first
    logits, scale 0 gives the base logits back bit for bit and scale 1 the
    merged ones, and the merged logits equal bit for bit those of an engine
    built afresh on a copy merged in the same rounding order (the gate
    against a plain f32 merge is `f32_gates`: at bf16 and 32 random layers
    a last-bit difference in a weight grows through the layers); then
    SparkServer with the adapter: /lora-adapters at scale 0
    serves the base stream, at 1 the merged one, each time the same."""
    import torch

    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.server.app import ServerConfig, SparkServer
    from sparkinfer_tpu_torch.tokenizer import build_tokenizer

    path = tmp / "lora-7b.gguf"
    ab, s = lora_adapter(path, model.config)
    layers = lora_targets(model)
    base, merged, merger = lora_round_trip(model, sparse_eng, path, prompt)
    merger.merge([0.0])
    moved = [float((a - b).abs().max()) for a, b in zip(merged, base)]
    del merger
    # the reference: the adapter merged into the clones in the merger's
    # rounding order (the f32 product cast to bf16, times s, added in bf16),
    # an engine built afresh on them; bit-equal first logits check every
    # dense and v6 flat-store write of the in-place merge at full width
    for (il, key), (A, B) in ab.items():
        delta = (torch.tensor(B, device="cuda") @ torch.tensor(A, device="cuda")).T
        layers[key][il] = layers[key][il] + delta.to(layers[key].dtype) * s
    ref = merged_engine_logits(model, layers, prompt, max_seq=sparse_eng.max_seq,
                               sampler=sparse_eng.sampler_cfg, kv_dtype=sparse_eng.kv_dtype,
                               sparse=scfg, device="cuda")
    bits = [torch.equal(a, b) for a, b in zip(merged, ref)]
    check(all(bits), "phase 5l, LoRA: the in-place merge's (prefill, decode) logits are "
                     f"not bit-equal to a fresh engine's on a merged copy: {bits}, off by "
                     f"{[float((a - b).abs().max()) for a, b in zip(merged, ref)]}")
    del layers, ref
    torch.cuda.empty_cache()

    model.vocab = spm_vocab(model.config.n_vocab, SEED)
    srv = SparkServer(model, ServerConfig(port=0, n_slots=1, max_seq=256, sparse=scfg,
                                          lora=[(str(path), 0.0)], device="cuda",
                                          slot_prompt_similarity=0.0),
                      sampler=SamplerConfig(temp=0.0))
    srv.serve(block=False)
    try:
        ids = build_tokenizer(model.vocab).encode("hello world", add_special=True)
        body = {"prompt": ids + prompt[:16], "max_tokens": 16, "temperature": 0.0}

        def stream():
            fresh_slots(srv.sched)
            return http(srv.port, "/v1/completions", body)["body"]["choices"][0]["text"]

        base_text = stream()
        http(srv.port, "/lora-adapters", [{"id": 0, "scale": 1.0}])
        merged_text = stream()
        http(srv.port, "/lora-adapters", [{"id": 0, "scale": 0.0}])
        base_again = stream()
        http(srv.port, "/lora-adapters", [{"id": 0, "scale": 1.0}])
        merged_again = stream()
        http(srv.port, "/lora-adapters", [{"id": 0, "scale": 0.0}])
        captures = srv.sched.graphs.captures
    finally:
        srv.shutdown()
        model.vocab = None
    check(base_again == base_text and merged_again == merged_text,
          "phase 5l, LoRA over HTTP: a re-merge did not give back its stream")
    check(merged_text != base_text, "phase 5l, LoRA over HTTP: the adapter changed nothing")
    check(captures == 1, f"phase 5l, LoRA over HTTP: {captures} tick captures")
    del srv
    torch.cuda.empty_cache()
    row = {"moved_prefill_and_decode_logits": moved, "bit_equal_to_a_fresh_merge": True,
           "http": {"base": base_text, "merged": merged_text}}
    print("phase 5l, LoRA:", json.dumps(row))
    return row


def phase_slots(sched, tmp) -> dict:
    """The 4-slot v1 Scheduler: a request of 16 new tokens, its slot saved;
    the continuation (its prompt and tokens and 2 more) served over the
    slot's rows is the reference; then the slot is zeroed, the file
    restored into slot 2 in place, and the same continuation must stream
    the same tokens, with no new capture."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    gen = torch.Generator().manual_seed(SEED + 41)
    prompt = torch.randint(sched.cfg.n_vocab, (32,), generator=gen).tolist()
    fresh_slots(sched)
    sched.slot_similarity = 0.5
    try:
        a = sched.submit(Request(prompt_tokens=prompt, max_new_tokens=16))
        sched.run_until_idle()
        first = a.tokens()
        s_i = next(i for i, sl in enumerate(sched.slots) if sl.cached_tokens)
        f = tmp / "slot.state"
        t0 = time.perf_counter()
        n_bytes = sched.save_slot(s_i, str(f))
        save_ms = 1e3 * (time.perf_counter() - t0)
        cont = prompt + first + [5, 6]
        r = sched.submit(Request(prompt_tokens=cont, max_new_tokens=16))
        sched.run_until_idle()
        want = r.tokens()
        captures = sched.graphs.captures
        fresh_slots(sched)
        sched.cache.k[:, s_i].zero_()
        sched.cache.v[:, s_i].zero_()
        other = (s_i + 2) % sched.n_slots
        t0 = time.perf_counter()
        info = sched.restore_slot(other, str(f))
        restore_ms = 1e3 * (time.perf_counter() - t0)
        b = sched.submit(Request(prompt_tokens=cont, max_new_tokens=16))
        sched.run_until_idle()
        got = b.tokens()
    finally:
        sched.slot_similarity = 0.0
    check(got == want, f"phase 5l, slots: the restored slot streamed {got}, the saved {want}")
    check(sched.graphs.captures == captures,
          f"phase 5l, slots: the restore led to {sched.graphs.captures - captures} captures")
    row = {"slot": s_i, "restored_into": other, "n_past": info["n_past"], "file_bytes": n_bytes,
           "save_ms": save_ms, "restore_ms": restore_ms, "tokens": len(got)}
    print("phase 5l, slot save/restore:", json.dumps(row))
    return row


def cli_children(runs: dict, timeout: float = 300.0) -> dict:
    """`python -m sparkinfer_tpu_torch.tools.cli ARGV` on the card for every
    run at once (the children's start-up and loads overlap): {name:
    (stdout, stderr, seconds)}; fails the run on a non-zero exit, and stops
    every child whatever happens."""
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "sparkinfer_tpu_torch.tools.cli", *argv], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name, argv in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            check(proc.returncode == 0, f"phase 5l, CLI {name} exited {proc.returncode}: "
                                        f"{stderr[-3000:]}")
            out[name] = (stdout, stderr, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return out


def phase_cli(tmp) -> dict:
    """The CLI as child processes, started together, on a GGUF at 7B widths
    cut to 2 layers (F16 weights at bench.py's scales, predictors, the
    32000-piece SPM vocabulary), written by the port's writer: plain sparse
    decode, lookup drafting, self-extend (each printed stream equal to the
    in-process engine's, built by the CLI's own make_engine from the same
    flags on the same file) and bench mode (-nps 2 --json)."""
    import torch

    from sparkinfer_tpu_torch.models.loader import load_model
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.tokenizer import build_tokenizer
    from sparkinfer_tpu_torch.tools.cli import build_parser, make_engine

    gguf = tmp / "prosparse-7b-widths-2l.gguf"
    t0 = time.perf_counter()
    write_prosparse_gguf(gguf, SEED + 51, L=2, E=4096, H=32, F=11008, R=1024, n_vocab=32000,
                         f16=True)
    write_s = time.perf_counter() - t0
    prompt = "hello world " * 8
    pf = tmp / "prompts.txt"
    pf.write_text("hello world\nthe quick brown fox\n")
    sparse = ["--temp", "0", "--sparse", "--group-size", "128", "--capacity-groups", "12",
              "-c", "512"]
    common = ["-m", str(gguf), "-p", prompt, "-n", "32"] + sparse
    runs = {"plain": common + ["--verbose"],
            "lookup": common + ["--draft-mode", "lookup", "--verbose"],
            "self_extend": common + ["-gan", "4", "-gaw", "64"],
            "bench": ["-m", str(gguf), "-f", str(pf), "-nps", "2", "--json", "-n", "16"] + sparse}
    done = cli_children(runs)
    rows = {"gguf_write_s": write_s}
    model = load_model(str(gguf), device="cuda")
    tk = build_tokenizer(model.vocab)
    ids = tk.encode(prompt, add_special=True)
    stop = {model.vocab.eos_id}
    for name in ("plain", "lookup", "self_extend"):
        out, err, child_s = done[name]
        eng = make_engine(build_parser().parse_args(runs[name] + ["--device", "cuda"]), model)
        toks = (LookupEngine(eng, n_draft=5).generate(ids, 32, stop_ids=stop)
                if name == "lookup" else eng.generate(ids, 32, stop_ids=stop))
        want = prompt + "".join(tk.decode([t]) for t in toks) + "\n"
        check(out == want, f"phase 5l, CLI {name}: printed {out!r}, the engine {want!r}")
        rows[name] = {"child_s": child_s, "tokens": len(toks),
                      "stderr_json": [json.loads(ln) for ln in err.splitlines()
                                      if ln.startswith("{")]}
        del eng
    bench = json.loads(done["bench"][0].strip().splitlines()[-1])
    check(len(bench) == 2 and all(r["decode_tokens"] >= 1 for r in bench),
          f"phase 5l, CLI bench mode: {bench}")
    rows["bench"] = {"child_s": done["bench"][2], "rows": bench}
    del model
    torch.cuda.empty_cache()
    print("phase 5l, CLI:", json.dumps(rows))
    return rows


def phase_runtime(model, scfg, sparse_eng, sched, prompt, n_new: int = 64) -> dict:
    """Phase 5l over the 7B bf16 model (full width and depth): the sampler
    chain, context shift, self-extend, sparse prefill, the drafters, slot
    files, LoRA and the CLI; the f32 drafter gate at 4 layers. Returns its
    summary with the v6 launches its main-path runs counted."""
    import tempfile
    import pathlib

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v6 as v6
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.runtime.speculative import SpeculativeEngine

    t_start = time.perf_counter()
    L = model.config.n_layer
    stores = LoadedModel(config=model.config, params=sparse_eng.params)

    def engines(sampler, **kw):
        """A graph engine and an eager engine over the sparse engine's stores."""
        kw = dict(sampler=sampler, sparse=scfg, sparse_preprepared=True, device="cuda", **kw)
        return Engine(stores, **kw), Engine(stores, cuda_graph=False, **kw)

    out, v6_main = {}, 0
    # the sampler chain: repetition penalty over the last 64 tokens, graph and eager
    pen = SamplerConfig(temp=0.0, penalty_repeat=1.1, penalty_last_n=64)
    g, e = engines(pen, max_seq=1024)
    v6.launches = 0
    out["penalties"] = graph_eager_pair("penalty 1.1, last 64", g, e, prompt, n_new)
    v6_main += v6.launches
    miro = SamplerConfig(temp=0.8, mirostat=2, seed=SEED)
    g = Engine(stores, max_seq=1024, sampler=miro, sparse=scfg, sparse_preprepared=True,
               device="cuda")
    v6.launches = 0
    toks, _ = stream_with_logits(g, prompt, n_new, seed=SEED)
    v6_main += v6.launches
    mu = float(g.sstate.mirostat_mu)
    check(len(toks) == n_new and mu != 2.0 * miro.mirostat_tau,
          f"phase 5l, mirostat: {len(toks)} tokens, mu {mu} (starts at {2 * miro.mirostat_tau})")
    out["mirostat"] = {"tokens": len(toks), "mu": mu, "distinct": len(set(toks))}
    del g, e
    # context shift: max_seq 128, a 32-token prompt, 160 tokens
    g, e = engines(SamplerConfig(temp=0.0), max_seq=128)
    v6.launches = 0
    out["context_shift"] = graph_eager_pair("context shift", g, e, prompt, 160)
    v6_main += v6.launches
    # self-extend (4, 64): max_seq 256, 200 tokens
    g, e = engines(SamplerConfig(temp=0.0), max_seq=256, self_extend=(4, 64))
    v6.launches = 0
    out["self_extend"] = graph_eager_pair("self-extend (4, 64)", g, e, prompt, 200)
    v6_main += v6.launches
    out["self_extend"]["gamma"] = g.self_extend.gamma
    check(g.self_extend.gamma > 0, "phase 5l, self-extend never fired")
    del g, e
    torch.cuda.empty_cache()
    print(f"phase 5l: sampler chain, context shift, self-extend at "
          f"{time.perf_counter() - t_start:.1f} s:", json.dumps(out))

    # sparse prefill: v6 at N = 32, n_layer times, against masked-dense prefill
    sp = Engine(stores, max_seq=1024, sampler=SamplerConfig(temp=0.0), sparse=scfg,
                sparse_preprepared=True, sparse_prefill="sparse", device="cuda")
    rows = {}
    for label, eng, want in (("sparse (v6 at N=32)", sp, L), ("masked-dense", sparse_eng, 0)):
        cache, st = eng.own_cache() if eng is sp else eng.new_cache(), eng.new_sampler_state()
        v6.launches = 0
        eng.prefill(prompt, cache, st)  # warm
        warm = v6.launches
        v6.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.prefill(prompt, cache, st)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 5
        rows[label] = {"ms": ms, "v6_launches": v6.launches / 5, "warm_v6_launches": warm}
        check(warm == want and v6.launches == 5 * want,
              f"phase 5l, {label} prefill: v6 launched {warm} times warm and {v6.launches} in "
              f"5 timed prefills, want {want} a prefill")
        check(bool(torch.isfinite(eng.last_logits).all()), f"phase 5l, {label} prefill")
        v6_main += warm + v6.launches
    out["sparse_prefill"] = rows
    print("phase 5l, 32-token prefill:", json.dumps(rows))
    del sp

    # the drafters: the sparse target, a dense draft on the same weights. Random
    # weights give no recurring n-grams in 64 greedy tokens (no lookup round),
    # so every drafter also runs on `echo_params`, under which greedy decoding
    # repeats its last token: the other extreme of acceptance
    def drafter_engines(tied):
        head = echo_params(model.params["tok_embd"]) if tied else {}
        t = Engine(LoadedModel(config=model.config, params={**sparse_eng.params, **head}),
                   max_seq=1024, sampler=SamplerConfig(temp=0.0), sparse=scfg,
                   sparse_preprepared=True, device="cuda")
        d = Engine(LoadedModel(config=model.config, params={**model.params, **head}),
                   max_seq=1024, sampler=SamplerConfig(temp=0.0), device="cuda")
        return t, d

    repetitive = prompt[:8] * 4
    drafts = []
    for tied, runs in ((False, (("speculative", 0),)),
                       (True, (("speculative", 0), ("lookup", 1), ("lookahead", 1)))):
        target, draft = drafter_engines(tied)
        plain = {}
        for k, pr in enumerate((prompt, repetitive)):  # plain greedy decode, logits kept
            v6.launches = 0
            target.perf.__init__()
            plain[k] = stream_with_logits(target, pr, n_new)
            v6_main += v6.launches
        step_ms = 1e3 * target.perf.t_decode_s / max(target.perf.n_decode, 1)
        for name, k in runs:
            dr = {"speculative": lambda: SpeculativeEngine(target, draft, n_draft=5),
                  "lookup": lambda: LookupEngine(target, n_draft=5),
                  "lookahead": lambda: LookaheadEngine(target, n_draft=5)}[name]()
            row, toks = drafter_run(name, dr, target, (prompt, repetitive)[k], n_new)
            row["weights"] = "echo" if tied else "random"
            v6_main += row["v6_launches"]
            row["plain_step_ms"] = step_ms
            ref, ref_logits = plain[k]
            diff = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b), None)
            row["agrees_with_plain_for"] = len(toks) if diff is None else diff
            if diff is not None:  # bf16: a verify's sums round otherwise than a step's
                top2 = torch.topk(ref_logits[diff][0].float(), 2).values
                row["plain_top2_gap_there"] = float(top2[0] - top2[1]) / float(
                    ref_logits[diff].abs().max())
            rounds = row["rounds"]
            check((rounds > 0 or not tied) and row["v6_launches"] >= rounds * L,
                  f"phase 5l, {name}: {rounds} rounds, v6 launched {row['v6_launches']}")
            row["v6_per_round"] = ((row["v6_launches"] - L * row["plain_steps"]) / rounds
                                   if rounds else None)
            drafts.append(row)
            print("phase 5l, drafter:", json.dumps(row))
        del target, draft
    out["drafters"] = drafts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        out["slots"] = phase_slots(sched, tmp)
        out["lora"] = phase_lora(model, scfg, sparse_eng, prompt, tmp)
        out["f32_gate"] = f32_gates(scfg, tmp)
        out["cli"] = phase_cli(tmp)
    out["v6_launches"] = v6_main
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 5l done in {out['seconds']:.1f} s")
    return out


def runtime_phase_only(greedy) -> int:
    """`chip_smoke.py --runtime`: phase 5l alone (after phases 1 and 2), on
    the 7B bf16 model, its sparse engine and the 4-slot v1 Scheduler, as the
    full run builds them; prints its summary and no result."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    cfg = prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    scfg = SparseConfig(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    sparse_eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, device="cuda")
    run_generate(sparse_eng, prompt, 8)
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_batch_max=4, device="cuda")
    print("phase 5l summary:", json.dumps(runtime_summary(
        phase_runtime(model, scfg, sparse_eng, sched, prompt))))
    return 0


def runtime_summary(rt) -> dict:
    """Phase 5l's numbers for PERF.md: tok/s, ms, accept rates, v6 counts."""
    return {
        "seconds": rt["seconds"], "v6_launches": rt["v6_launches"],
        "penalties_decode_tok_s": [rt["penalties"][k] for k in ("graph_decode_tok_s",
                                                                 "eager_decode_tok_s")],
        "mirostat_mu": rt["mirostat"]["mu"],
        "context_shift_decode_tok_s": [rt["context_shift"][k] for k in (
            "graph_decode_tok_s", "eager_decode_tok_s")],
        "self_extend_gamma": rt["self_extend"]["gamma"],
        "prefill_ms": {k: v["ms"] for k, v in rt["sparse_prefill"].items()},
        "drafters": [{k: d[k] for k in ("drafter", "weights", "accept_rate", "ms_per_round",
                                        "ms_per_token", "plain_step_ms", "v6_per_round",
                                        "agrees_with_plain_for")} for d in rt["drafters"]],
        "f32_gate": rt["f32_gate"], "slots": rt["slots"],
        "lora_bf16_moved": rt["lora"]["moved_prefill_and_decode_logits"],
        "cli_child_s": {k: v["child_s"] for k, v in rt["cli"].items()
                        if isinstance(v, dict)},
    }


# --- phase 5m: row-wise W8A8 (the JAX bench's 13B headline row), a K-quant
# GGUF, and embeddings / rerank over HTTP --------------------------------------

W8A8_GEMM = ("gemm", "imma", "xmma", "cutlass", "sm90", "sm80")  # library int8 product kernels
# w8a8_linear against the f32 product of the bf16 weights it was quantized
# from, ||error|| / ||product|| over 8 random rows: int8 weights a row and
# int8 activations a token each round to about amax/127/sqrt(12), 0.9% of
# the RMS at a 4-sigma amax, 1.3% together; a transposed stack is off by
# about 140%, a scale off by 2 by 100%
W8A8_PRODUCT_TOL = 0.03
# the W8A8 engine's prefill logits may lie this many times farther from the
# bf16 engine's (the same draws unquantized) than the Q8_0 engine's do: its
# products round 2-3 times coarser than Q8_0's 32-element blocks, and a
# different rounding can flip a selected neuron group, which moves the
# logits by far more than the rounding does
W8A8_GAP_FACTOR = 3.0


def w8a8_products(attn, pred, weights) -> dict:
    """The gate on the int8 product: torch._int_mm bit-equal to the exact f64
    product, and w8a8_linear to its plain composition, at the path's shapes
    (an attention projection, the predictor's up and down) and N = 1 and 32,
    on layer 0's weights; then every stack at every layer against the f32
    product of its bf16 draw (within W8A8_PRODUCT_TOL), which a stack
    quantized from a transposed or mis-scaled weight fails."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    out = {}
    n0 = qm.int8_matmul.launches
    for key, draw in weights.w8a8_draws().items():
        stack = attn[key] if key in attn else pred[key]
        worst = 0.0
        for il in range(weights.cfg.n_layer):
            w = draw(il).float()
            x = torch.randn((8, w.shape[0]), generator=gen, device="cuda").to(torch.bfloat16)
            ref = x.float() @ w
            err = (qm.w8a8_linear(x, stack[il]).float() - ref).norm() / ref.norm()
            worst = max(worst, err.item())
        check(worst <= W8A8_PRODUCT_TOL, f"5m: w8a8_linear of {key} lies {worst:.4f} from "
                                         f"the bf16 product, over {W8A8_PRODUCT_TOL}")
        out[f"{key} all layers, N=8: worst relative error against bf16"] = worst
    for name, w in (("wq", attn["wq"][0]), ("pred_up", pred["pred_up_w8"][0]),
                    ("pred_down", pred["pred_down_w8"][0])):
        for N in (1, 32):
            x = torch.randn((N, w.shape[0]), generator=gen, device="cuda").to(torch.bfloat16)
            xq, sx = qm.w8a8_quantize(x)
            y, ref = qm.int8_matmul(xq, w.q), qm.int8_matmul_plain(xq, w.q)
            check(torch.equal(y, ref), f"5m: the int8 product of {name} at N={N} differs "
                                       f"from the f64 product by {(y - ref).abs().max().item()}")
            plain = (ref.float() * sx * w.s).to(x.dtype)
            check(torch.equal(qm.w8a8_linear(x, w), plain),
                  f"5m: w8a8_linear of {name} at N={N} differs from its plain version")
            out[f"{name} {tuple(w.shape)} N={N}"] = "bit-equal"
    qm.int8_matmul.launches = n0  # checks, not the path
    return out


def attn_product_times(weights, attn) -> dict:
    """One attention projection at 13B, N = 1 (5120 x 5120): w8a8_linear
    (activation quantization, the int8 product, the scale epilogue), the
    int8 product alone, the Q8_0 decode kernel (qmm_decode) and the bf16
    torch.matmul, each over the model's L layers' weights (more bytes than
    L2 holds at 20 or 40 layers) in one CUDA graph, with each one's bytes bound."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    cfg = weights.cfg
    L, E = cfg.n_layer, cfg.n_embd
    HD = cfg.n_head * cfg.head_dim
    w8 = attn["wq"]
    q8 = weights.packed_stack("wq", HD, E)
    bf = weights.dense_stack("wq", HD, E)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    x = torch.randn((1, E), generator=gen, device="cuda").to(torch.bfloat16)
    xq, _ = qm.w8a8_quantize(x)
    counts = (qm.int8_matmul.launches, qm.quant_matmul_2d.launches)
    reps = 2 * L
    io = E * 2 + HD * 2  # x in, y out (bf16)
    rows = {
        "w8a8_linear": (graph_ms(lambda i: qm.w8a8_linear(x, w8[i % L]), reps),
                        w8.q[0].numel() + w8.s[0].numel() * 4 + io),
        "int8_product": (graph_ms(lambda i: qm.int8_matmul(xq, w8.q[i % L]), reps),
                         w8.q[0].numel() + E + HD * 4),
        "qmm_decode (Q8_0)": (graph_ms(lambda i: qm.quant_matmul_2d(
            x, q8.q[i % L], q8.s[i % L], kind="q8_0"), reps),
            q8.q[0].numel() + q8.s[0].numel() * 4 + E * 2 + HD * 4),
        "torch.matmul (bf16)": (graph_ms(lambda i: torch.matmul(x, bf[i % L]), reps),
                                bf[0].numel() * 2 + io),
    }
    qm.int8_matmul.launches, qm.quant_matmul_2d.launches = counts
    del q8, bf
    torch.cuda.empty_cache()
    return {k: {"ms": ms, "bytes": nb, "bound_ms": bound(nb, 2 * E * HD, PEAK_BF16_FLOP_S)[0]}
            for k, (ms, nb) in rows.items()}


def w8a8_added_kernels(rows, steps, q8_rows, q8_steps) -> dict:
    """The kernels the W8A8 step launches beyond the Q8_0 step (same FFN,
    same head), by name, per step: device ms and launches, the library's
    int8 product kernels apart from the rest (activation quantization and
    the scale epilogue)."""
    q8 = {k: (ms / q8_steps, n // q8_steps) for k, ms, n in q8_rows}
    added = {}
    for k, ms, n in rows:
        ms0, n0 = q8.get(k, (0.0, 0))
        if n // steps > n0:
            added[k[:80]] = [ms / steps - ms0, n // steps - n0]
    gemm = {k: v for k, v in added.items() if any(g in k.lower() for g in W8A8_GEMM)}
    rest = {k: v for k, v in added.items() if k not in gemm}
    qmm = sum(ms / q8_steps for k, ms, n in q8_rows if "qmm_decode" in k)
    return {"int8_product": {"ms": sum(v[0] for v in gemm.values()),
                             "launches": sum(v[1] for v in gemm.values()), "kernels": gemm},
            "quantize_and_epilogue": {"ms": sum(v[0] for v in rest.values()),
                                      "launches": sum(v[1] for v in rest.values()),
                                      "kernels": rest},
            "q8_step_qmm_decode_ms": qmm}


def prefill_logits(eng, prompt):
    """The engine's prefill logits of `prompt` on a cache of its own (f32)."""
    cache, st = eng.new_cache(), eng.new_sampler_state()
    eng.prefill(prompt, cache, st)
    return eng.last_logits.float().reshape(-1).clone()


def bf16_prefill_logits(weights, scfg, greedy, prompt):
    """Prefill logits of the bf16 sparse Engine over the draws of `weights`
    unquantized (v6's bf16 flat stores, the dense FFN dropped), built and
    freed here."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.sparse.ffn import prepare_pipelined_params

    params = prepare_pipelined_params(weights.bf16_params(), weights.cfg, scfg,
                                      drop_dense=True, layout="v6")
    eng = Engine(LoadedModel(config=weights.cfg, params=params), max_seq=64, sampler=greedy,
                 sparse=scfg, sparse_preprepared=True, device="cuda")
    del params
    logits = prefill_logits(eng, prompt)
    del eng
    torch.cuda.empty_cache()
    return logits


def logits_gap(got, ref) -> dict:
    """max |got - ref| over max |ref|, and the share of ref's 10 largest
    logits among got's."""
    top = set(got.topk(10).indices.tolist()) & set(ref.topk(10).indices.tolist())
    return {"rel_max_abs": ((got - ref).abs().max() / ref.abs().max()).item(),
            "top10_overlap": len(top) / 10}


def phase_w8a8_13b(cfg, scfg, weights, model, greedy, prompt, n_new, q8_rows, q8_steps,
                   q8_logits):
    """Phase 5m(a): the JAX bench's headline configuration at ProSparse-
    Llama-2-13B widths and the depth of `cfg`: W8A8 attention and predictor stacks,
    quantized a layer at a time from the seeded bf16 draws of `weights`,
    over the Q8_0 flat FFN stores (v6q) and Q8_0 head of `model` (phase 5c's,
    the same draws). The int8 product gates, the main path as a graph (exact
    launch counts, int8 products too), graph against eager, the profiled
    step against the Q8_0 step's, the attention product's times, and the
    prefill logits' distance from those of the bf16 engine over the same
    draws, held to W8A8_GAP_FACTOR times the Q8_0 engine's (q8_logits).
    Returns the W8A8 parts (for the tiered run), the summary and the
    launches."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.runtime.engine import Engine

    L = cfg.n_layer
    t0 = time.perf_counter()
    attn, pred = weights.w8a8_parts()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    flat = {k: v for k, v in model.params["sparse_flat"].items() if not k.endswith("_qt")}
    params = {**model.params, "layers": {**model.params["layers"], **attn},
              "sparse_flat": {**flat, **pred}}
    w8 = LoadedModel(config=cfg, params=params)
    products = w8a8_products(attn, pred, weights)
    eng = Engine(w8, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
                 device="cuda")

    def want(steps):  # the head only: attention and predictors are int8 products
        return {"sparse_ffn_block_v6q": L * steps, "quant_matmul_2d": steps + 1}

    i0 = qm.int8_matmul.launches
    launches = main_path("13B W8A8 sparse", eng, prompt, n_new, want)
    int8 = qm.int8_matmul.launches - i0
    # a step: wq wk wv wo a layer, the next layer's predictor (up, down) a
    # layer and layer 0's own; the prefill: attention and each layer's own
    want_int8 = (4 * L + 2 * (L + 1)) * n_new + 6 * L
    check(int8 == want_int8, f"5m: {int8} int8 products in the W8A8 main path, want {want_int8}")
    q8_toks, w8_toks = STREAMS["13B Q8_0 sparse"], STREAMS["13B W8A8 sparse"]
    same = sum(a == b for a, b in zip(q8_toks, w8_toks)) / len(q8_toks)
    h5 = graph_vs_eager("13B W8A8 sparse", eng, Engine(
        w8, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
        device="cuda", cuda_graph=False), prompt, n_new)
    rows, steps = PROFILES["13B W8A8 sparse"]
    added = w8a8_added_kernels(rows, steps, q8_rows, q8_steps)
    w8_logits = prefill_logits(eng, prompt)
    del eng
    torch.cuda.empty_cache()
    times = attn_product_times(weights, attn)
    bf_logits = bf16_prefill_logits(weights, scfg, greedy, prompt)
    gaps = {"w8a8_vs_bf16": logits_gap(w8_logits, bf_logits),
            "q8_0_vs_bf16": logits_gap(q8_logits, bf_logits),
            "w8a8_vs_q8_0": logits_gap(w8_logits, q8_logits)}
    check(gaps["w8a8_vs_bf16"]["rel_max_abs"]
          <= W8A8_GAP_FACTOR * gaps["q8_0_vs_bf16"]["rel_max_abs"],
          f"5m: the W8A8 prefill logits lie farther from the bf16 engine's than "
          f"{W8A8_GAP_FACTOR} times the Q8_0 engine's: {gaps}")

    def nbytes(*ts):
        return sum(t.q.numel() * t.q.element_size() + t.s.numel() * t.s.element_size()
                   for t in ts)

    lay, fl = model.params["layers"], model.params["sparse_flat"]
    weight_bytes = {"w8a8_attention": nbytes(*attn.values()),
                    "q8_0_attention": nbytes(*(lay[k] for k in attn)),
                    "w8a8_predictors": nbytes(*pred.values()),
                    "q8_0_predictors": nbytes(fl["pred_up_qt"], fl["pred_down_qt"])}
    out = {"build_s": build_s, "int8_products_gate": products, "weight_bytes": weight_bytes,
           "int8_products_per_step": 4 * L + 2 * (L + 1),
           "tok_s": h5["graph"]["tok_s"], "wall_ms_per_step": h5["graph"]["wall_ms_per_step"],
           "device_ms_per_step": h5["graph"]["device_ms_per_step"],
           "busy_share": h5["graph"]["busy_share"], "eager": h5["eager"],
           "peak_gib": PEAKS["13B W8A8 sparse"], "greedy_share_equal_q8_0": same,
           "prefill_logits_gap": gaps,
           "added_to_the_q8_0_step": added, "attention_product_5120x5120_n1": times}
    print("phase 5m(a), 13B W8A8:", json.dumps(out))
    return attn, pred, out, launches


def kquant_blocks(t: str, n_elems: int, rng):
    """Blocks of ggml type t (Q4_K or Q6_K) for n_elems weights: random
    quants and sub-scales, f16 super-block scales chosen so that the values
    lie within about +-0.05 (random bytes there would give NaN or Inf)."""
    import numpy as np

    from sparkinfer_tpu_torch.gguf.constants import GGML_TYPE_TRAITS, GGMLType

    bs, tsz = GGML_TYPE_TRAITS[getattr(GGMLType, t)]
    nb = n_elems // bs
    raw = np.frombuffer(rng.bytes(nb * tsz), np.uint8).reshape(nb, tsz).copy()

    def f16(lo, hi):
        return rng.uniform(lo, hi, nb).astype(np.float16).view(np.uint8).reshape(nb, 2)

    if t == "Q4_K":  # d * sc * q - dmin * m, q < 16, sc and m < 64
        raw[:, 0:2], raw[:, 2:4] = f16(2e-5, 5e-5), f16(2e-5, 5e-5)
    else:  # Q6_K: d * sc * (q - 32), int8 sc kept within +-8
        raw[:, 192:208] = rng.integers(-8, 9, (nb, 16)).astype(np.int8).view(np.uint8)
        raw[:, 208:210] = f16(1e-4, 2e-4)
    return raw.reshape(-1)


KQ_LAYERS = 2  # host decoding at load bounds the depth


def write_kquant_gguf(path, seed: int, L, E, H, F, R, V):
    """A ProSparse GGUF at ProSparse-Llama-2-7B widths in llama.cpp's Q4_K_M
    mix: Q4_K, with Q6_K for attn_v, ffn_down and output, f16 predictor
    tensors, f32 norms and biases; the blocks written directly. Returns
    {name: (type, numpy shape)} of the block-quantized tensors."""
    import numpy as np

    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    arch = "prosparse_llama"
    wr = GGUFWriter(str(path), arch)
    for key, v in (("block_count", L), ("embedding_length", E), ("attention.head_count", H),
                   ("attention.head_count_kv", H), ("feed_forward_length", F),
                   ("vocab_size", V), ("context_length", 4096),
                   ("rope.dimension_count", E // H)):
        wr.add_kv(f"{arch}.{key}", np.uint32(v))
    wr.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    wr.add_kv(f"{arch}.rope.freq_base", np.float32(10000.0))
    wr.add_array(f"{arch}.pred_lora", np.full(L, R, np.uint32))
    quant = {}

    def blocks(name, shape, t):
        quant[name] = (t, shape)
        wr.add_tensor(name, kquant_blocks(t, int(np.prod(shape)), rng), getattr(GGMLType, t),
                      raw=True, ne=tuple(reversed(shape)))

    def f16(name, shape, scale, shift=0.0):
        wr.add_tensor(name, (rng.standard_normal(shape) * scale + shift).astype(np.float16))

    blocks("token_embd.weight", (V, E), "Q4_K")
    wr.add_tensor("output_norm.weight", np.ones(E, np.float32))
    blocks("output.weight", (V, E), "Q6_K")
    for i in range(L):
        p = f"blk.{i}."
        for name in ("attn_norm.weight", "ffn_norm.weight"):
            wr.add_tensor(p + name, np.ones(E, np.float32))
        for name, shape, t in (("attn_q", (E, E), "Q4_K"), ("attn_k", (E, E), "Q4_K"),
                               ("attn_v", (E, E), "Q6_K"), ("attn_output", (E, E), "Q4_K"),
                               ("ffn_up", (F, E), "Q4_K"), ("ffn_gate", (F, E), "Q4_K"),
                               ("ffn_down", (E, F), "Q6_K")):
            blocks(p + name + ".weight", shape, t)
        f16(p + "ffn_pred_up.weight", (R, E), 0.05)
        f16(p + "ffn_pred_down.weight", (F, R), 0.6)
        wr.add_tensor(p + "ffn_pred_up.bias", np.zeros(R, np.float32))
        wr.add_tensor(p + "ffn_pred_down.bias",
                      (rng.standard_normal(F) * 0.5 - 1.2).astype(np.float32))
    wr.write()
    return quant


def write_decoded_bf16(src, dst) -> dict:
    """The GGUF `src` again with every block-quantized tensor decoded on the
    host (gguf.quants.dequantize) and stored as BF16, the rest as it was.
    Returns each format's decode rate, M elements/s on one host thread."""
    import numpy as np

    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.quants import dequantize
    from sparkinfer_tpu_torch.gguf.reader import GGUFReader
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    r = GGUFReader(str(src))
    wr = GGUFWriter(str(dst), r.arch())
    for k, v in r.kv.items():
        if k != "general.architecture":
            try:
                wr.add_kv(k, v)
            except Exception:
                wr.add_array(k, v)
    rates = {}
    for name, t in r.tensors.items():
        if t.ggml_type in (GGMLType.Q4_K, GGMLType.Q6_K):
            t0 = time.perf_counter()
            dec = dequantize(t.raw(), t.ggml_type, t.n_elems).reshape(t.shape)
            n, secs = rates.get(t.ggml_type.name, (0, 0.0))
            rates[t.ggml_type.name] = (n + t.n_elems, secs + time.perf_counter() - t0)
            wr.add_tensor(name, dec, GGMLType.BF16)
        else:
            wr.add_tensor(name, np.array(t.raw()), t.ggml_type, raw=True,
                          ne=tuple(reversed(t.shape)))
    wr.write()
    r.close()
    return {k: n / secs / 1e6 for k, (n, secs) in rates.items()}


def phase_kquant(greedy, prompt, n_new: int = 32) -> dict:
    """Phase 5m(b): a K-quant GGUF (Q4_K_M mix) at ProSparse-Llama-2-7B
    widths cut to KQ_LAYERS layers, loaded by load_model (every tensor
    decoded on the host, bf16 on the card) and run by the sparse Engine
    through v6; the same model written as a BF16 GGUF of the decoded values
    must give bit-equal prefill logits and the same greedy stream."""
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        return kquant_runs(greedy, prompt, n_new, pathlib.Path(d))


def kquant_runs(greedy, prompt, n_new, tmp) -> dict:
    """phase_kquant's body, its GGUFs in `tmp`."""
    import torch

    from sparkinfer_tpu_torch.models.loader import load_model
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    L, E, H, F, R, V = KQ_LAYERS, 4096, 32, 11008, 1024, 32000
    kq, bf = tmp / "kquant-7b.gguf", tmp / "kquant-7b-decoded-bf16.gguf"
    t0 = time.perf_counter()
    formats = write_kquant_gguf(kq, SEED + 51, L, E, H, F, R, V)
    write_s = time.perf_counter() - t0
    rates = write_decoded_bf16(kq, bf)
    scfg = SparseConfig(group_size=128, capacity_groups=12)
    runs = {}
    for label, path in (("Q4_K_M", kq), ("BF16", bf)):
        t0 = time.perf_counter()
        model = load_model(str(path), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        eng = Engine(model, max_seq=256, sampler=greedy, sparse=scfg, device="cuda")
        logits = prefill_logits(eng, prompt)
        if label == "Q4_K_M":  # the main path: v6 once a layer a step
            v6 = main_path("7B-width Q4_K_M sparse", eng, prompt, n_new,
                           lambda steps: {"sparse_ffn_block_v6": L * steps})
            toks = STREAMS["7B-width Q4_K_M sparse"]
        else:
            toks = run_generate(eng, prompt, n_new)
        runs[label] = {"load_s": load_s, "logits": logits, "tokens": toks,
                       "file_bytes": path.stat().st_size}
        del eng, model
        torch.cuda.empty_cache()
    a, b = runs["Q4_K_M"], runs["BF16"]
    check(torch.equal(a["logits"], b["logits"]),
          f"5m(b): Q4_K_M prefill logits differ from the BF16 GGUF's by "
          f"{(a['logits'] - b['logits']).abs().max().item():.3e}")
    check(a["tokens"] == b["tokens"], "5m(b): the Q4_K_M stream differs from the BF16 GGUF's")
    check(bool(torch.isfinite(a["logits"]).all()), "5m(b): non-finite logits")
    out = {"layers": L, "formats": sorted({t for t, _ in formats.values()}),
           "write_s": write_s, "decode_m_elems_per_s": rates,
           **{f"{k}_load_s": r["load_s"] for k, r in runs.items()},
           **{f"{k}_file_bytes": r["file_bytes"] for k, r in runs.items()},
           "prefill_logits_bit_equal": True, "streams_equal": True,
           "v6_launches": v6["sparse_ffn_block_v6"]}
    print("phase 5m(b), K-quant GGUF:", json.dumps(out))
    return out


EMBED_LENGTHS = (16, 32, 64, 128, 192, 256, 384, 512)


def embed_texts(vocab, gen):
    """Texts that tokenize to about EMBED_LENGTHS tokens: word pieces of the
    vocabulary, joined by spaces."""
    import torch

    words = [t[1:] for t in vocab.tokens if t.startswith("▁") and len(t) > 1]
    return [" ".join(words[i] for i in torch.randint(len(words), (n - 1,), generator=gen))
            for n in EMBED_LENGTHS]


def phase_embeddings(model) -> dict:
    """Phase 5m(c): /v1/embeddings and /v1/rerank of SparkServer over the 7B
    bf16 model of the main path (full width and depth, a seeded cls_out_w
    (1, E) as its reranking head): the HTTP vectors bit-equal to the
    Embedder called directly on each input alone, and each rank score
    within an f32 dot product's rounding bound of the head applied in f64
    on the host to the first token's hidden state from a forward of its
    own (make_forward(with_hidden=True), outside the Embedder)."""
    import numpy as np
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.embeddings import Embedder
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    cfg = model.config
    gen = torch.Generator().manual_seed(SEED + 61)
    model.vocab = spm_vocab(cfg.n_vocab, SEED)
    model.params["cls_out_w"] = (torch.randn((1, cfg.n_embd), generator=gen) * 0.05).to("cuda")
    srv = SparkServer(model, ServerConfig(port=0, n_slots=1, max_seq=1024),
                      sampler=SamplerConfig(temp=0.0))
    try:
        srv.serve(block=False)
        texts = embed_texts(model.vocab, gen)
        toks = [srv.tokenizer.encode(t, add_special=True) for t in texts]
        r = http(srv.port, "/v1/embeddings", {"input": texts})
        vecs = [np.asarray(d["embedding"], np.float32) for d in r["body"]["data"]]
        emb = Embedder(model, max_seq=1024, device="cuda")
        for i, ids in enumerate(toks):
            alone = emb.embed_tokens([ids])[0]
            check(np.array_equal(vecs[i], alone),
                  f"5m(c): HTTP embedding {i} ({len(ids)} tokens) differs from the direct one")
        one = http(srv.port, "/v1/embeddings", {"input": texts[3]})["body"]["data"][0]
        check(np.array_equal(np.asarray(one["embedding"], np.float32), vecs[3]),
              "5m(c): an input's vector alone differs from its vector among 8")
        query, docs = texts[0], texts[:8]
        rr = http(srv.port, "/v1/rerank", {"query": query, "documents": docs})
        v = model.vocab
        q_ids = srv.tokenizer.encode(query, add_special=False)
        check(not (v.add_eos or v.add_sep), "5m(c): the pairs below assume no eos or sep")
        fwd = make_forward(cfg, with_hidden=True, fresh_prefill=True)
        w = model.params["cls_out_w"].double().cpu().numpy()[0]
        worst = 0.0
        for res in rr["body"]["results"]:
            ids = ([v.bos_id] if v.add_bos else []) + q_ids + srv.tokenizer.encode(
                docs[res["index"]], add_special=False)
            with torch.inference_mode():
                cache = init_cache(cfg, 1, max(len(ids), 8), torch.float32, "cuda")
                _, hid = fwd(model.params, torch.tensor([ids], device="cuda"),
                             torch.arange(len(ids), device="cuda")[None], cache)
            h = hid[0, 0].double().cpu().numpy()
            want, size = float(w @ h), float(np.abs(w) @ np.abs(h))
            # an f32 dot product of E terms, summed in any order, lies within
            # E * 2^-24 of the sum of its terms' sizes from the exact one
            err = abs(res["relevance_score"] - want) / size
            check(err <= len(w) * 2.0**-24,
                  f"5m(c): rerank score {res['relevance_score']} lies {err:.3e} of the head's "
                  f"terms from the f64 head's {want}")
            worst = max(worst, err)
        ids512 = toks[-1]
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb.embed_tokens([ids512])
            times.append(1e3 * (time.perf_counter() - t0))
        out = {"inputs": len(texts), "tokens": [len(t) for t in toks],
               "http_equal_direct": True, "alone_equal_among_8": True,
               "rerank_vs_f64_head_worst": worst, "documents": len(docs),
               "embed_ms_512_tokens": sorted(times)[2], "embed_ms_512_tokens_all": times,
               "http_embeddings_e2e_ms": r["e2e_ms"], "http_rerank_e2e_ms": rr["e2e_ms"]}
    finally:
        srv.shutdown()
        model.vocab = None
        model.params.pop("cls_out_w")
    print("phase 5m(c), embeddings and rerank:", json.dumps(out))
    return out


def quant_phases(greedy) -> int:
    """`chip_smoke.py --quant`: phase 5m alone (after phases 1 and 2), for
    working on it; the 13B Q8_0 engine first (its stream and profiled step
    are what 5m(a) compares with), the tiered run with W8A8 only. Prints
    the phase's summary and no result."""
    import torch

    t_start = time.perf_counter()
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    cfg = prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    emb = phase_embeddings(model)
    del model
    torch.cuda.empty_cache()
    print(f"phase 5m(c) done at {time.perf_counter() - t_start:.1f} s")
    kq = phase_kquant(greedy, prompt)
    print(f"phase 5m(b) done at {time.perf_counter() - t_start:.1f} s")
    cfg, scfg, weights, model, eng = q8_13b_engine(greedy)
    L = cfg.n_layer
    main_path("13B Q8_0 sparse", eng, prompt, 64, lambda steps: {
        "sparse_ffn_block_v6q": L * steps, "quant_matmul_2d": (4 * L + 1) * (steps + 1),
        "quant_matmul_flat": 2 * (L + 1) * steps + 2 * L})
    rows13, steps13, _ = profile_decode(eng, prompt)
    q8_logits = prefill_logits(eng, prompt)
    del eng
    attn, pred, w8, _ = phase_w8a8_13b(cfg, scfg, weights, model, greedy, prompt, 64,
                                       rows13, steps13, q8_logits)
    for k in [k for k in model.params["sparse_flat"] if not k.startswith("pred_")]:
        del model.params["sparse_flat"][k]
    torch.cuda.empty_cache()
    print(f"phase 5m(a) untiered done at {time.perf_counter() - t_start:.1f} s")
    tiered, _ = phase_tiered_13b(cfg, scfg, weights, model, prompt, 64, w8a8=(attn, pred),
                                 q8_0=False)
    print(f"phase 5m(a) tiered done at {time.perf_counter() - t_start:.1f} s")
    print("phase 5m summary:", json.dumps(quant_summary(w8, tiered, kq, emb)))
    return 0


def quant_summary(w8, tiered, kq, emb) -> dict:
    keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "peak_gib", "swaps",
            "misses_per_token_first16", "misses_per_token_last16", "int8_products")
    return {"13B W8A8 sparse": {k: w8[k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "busy_share", "peak_gib",
                "greedy_share_equal_q8_0", "prefill_logits_gap", "int8_products_per_step",
                "weight_bytes")},
            "13B W8A8 added kernels": {k: {f: v[f] for f in ("ms", "launches")}
                                       for k, v in w8["added_to_the_q8_0_step"].items()
                                       if isinstance(v, dict)},
            "attention_product_5120x5120_n1": w8["attention_product_5120x5120_n1"],
            "tiered": [{"path": r["path"], **{k: r[k] for k in keys}} for r in tiered],
            "kquant": kq, "embeddings": emb}


# --- phase 5n: the paper's other sparse families -----------------------------
# SparseLLM/ReluFalcon-40B, Falcon-40B's published config.json (new decoder
# architecture): 60 layers, hidden 8192, 128 heads, 8 KV heads of 64, ffn
# 32768, vocab 65024, ln_attn and ln_mlp (attn_norm, attn_norm_2), parallel
# attention and FFN, rope theta 1e4, LayerNorm eps 1e-5, 2048 positions.
# facebook/opt-6.7b: 32 layers, hidden 4096, 32 heads, ffn 16384, vocab
# 50272, 2048 learned positions (+2), LayerNorm eps 1e-5. Qwen/Qwen2-7B
# (SparseQwen2-7B's base): 28 layers, hidden 3584, 28 heads, 4 KV heads of
# 128, ffn 18944, vocab 152064, rope theta 1e6, RMS eps 1e-6. Predictor rank
# 1024, groups of 128, about 14% of them selected (the 7B phases' 12 of 86).
# Random weights from SEED, drawn on the card; the depths are cuts.

FAMILY_R = 1024
FAMILY_C = {"falcon40b": 36, "opt6.7b": 18, "qwen2-7b": 21}  # of 256, 128, 148 groups
FAMILY_CUT_L = 4  # OPT-6.7B and Qwen2-7B run at this depth
FAMILY_HEADROOM = 6 * 2**30  # device bytes left for activations, caches, graph pools
FAMILY_Q8_LIMIT = 76 * 2**30  # the most a Q8_0 ReluFalcon-40B may take


def family_config(kind, L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    common = dict(n_layer=L, pred_lora=(FAMILY_R,) * L)
    if kind == "falcon40b":
        return ModelConfig(arch="falcon", n_embd=8192, n_head=128, n_head_kv=8, n_ff=32768,
                           n_vocab=65024, head_dim=64, n_ctx_train=2048, norm_eps=1e-5,
                           **common)
    if kind == "opt6.7b":
        return ModelConfig(arch="opt", n_embd=4096, n_head=32, n_head_kv=32, n_ff=16384,
                           n_vocab=50272, head_dim=128, n_ctx_train=2048, norm_eps=1e-5,
                           **common)
    return ModelConfig(arch="qwen2", n_embd=3584, n_head=28, n_head_kv=4, n_ff=18944,
                       n_vocab=152064, head_dim=128, n_ctx_train=32768, norm_eps=1e-6,
                       rope_freq_base=1e6, **common)


class LazyStack:
    """An (L, in, out) stack whose layer il is drawn on the device when
    indexed, for the functions that fill a store a layer at a time
    (prepare_pipelined_params, flat_quantize): no whole bf16 copy exists."""

    def __init__(self, draw, L, shape, dtype, device):
        self.draw, self.shape = draw, (L,) + tuple(shape)
        self.dtype, self.device = dtype, device

    def __getitem__(self, il):
        return self.draw(il)


class FamilyWeights:
    """Random weights of one family model with the loader's keys and
    orientations, each tensor of each layer drawn from its own seeded
    generator, so that a layer can be drawn again, equal, for another
    store (the dense counterpart, a Q8_0 store, the 1-layer gate)."""

    NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "w_up", "b_up", "w_gate",
             "w_down", "b_down", "pred_up", "pred_down", "pred_down_b", "output", "tok_embd",
             "pos_embd")

    def __init__(self, cfg, dtype, device, seed):
        self.cfg, self.dtype, self.device, self.seed = cfg, dtype, device, seed
        tr = cfg.traits
        E, F, R = cfg.n_embd, cfg.n_ff, cfg.max_pred_rank
        HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        self.lin = {"wq": (E, HD), "wk": (E, KD), "wv": (E, KD), "wo": (HD, E),
                    "w_up": (E, F), "w_down": (F, E)}
        if tr.sparse_act in ("drelu", "fatrelu"):
            self.lin["w_gate"] = (E, F)
        self.bias = {}
        if tr.qkv_bias:
            self.bias.update(bq=HD, bk=KD, bv=KD)
        if tr.attn_out_bias:
            self.bias["bo"] = E
        if tr.ffn_bias:
            self.bias.update(b_up=F, b_down=E)

    def draw(self, name, il, shape, scale=0.02, shift=0.0, dtype=None):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * len(self.NAMES) + self.NAMES.index(name)) * 4096 + il)
        t = torch.randn(shape, generator=gen, device=self.device, dtype=dtype or self.dtype)
        return t.mul_(scale).add_(shift)

    def shape(self, name):
        """(in, out) of a linear or of a predictor stack's layer."""
        return {"pred_up": (self.cfg.n_embd, FAMILY_R),
                "pred_down": (FAMILY_R, self.cfg.n_ff)}.get(name) or self.lin[name]

    def layer(self, name, il):
        """Layer il of a linear or of a predictor stack."""
        scale = {"pred_up": 0.05, "pred_down": 0.6}.get(name, 0.02)
        return self.draw(name, il, self.shape(name), scale=scale)

    def stack(self, name):
        import torch

        L = self.cfg.n_layer
        st = torch.empty((L,) + self.shape(name), dtype=self.dtype, device=self.device)
        for il in range(L):
            st[il].copy_(self.layer(name, il))
        return st

    def lazy(self, name):
        return LazyStack(lambda il: self.layer(name, il), self.cfg.n_layer, self.shape(name),
                         self.dtype, self.device)

    def small(self, dense_linears=("wq", "wk", "wv", "wo")):
        """Every tensor but the FFN and predictor stacks: norms (LayerNorm
        weights ones and biases zeros where the arch has them), biases in
        f32, the attention stacks in the model's dtype, embeddings, the
        learned positions and the head."""
        import torch

        cfg, dev = self.cfg, self.device
        L, E, V = cfg.n_layer, cfg.n_embd, cfg.n_vocab
        tr = cfg.traits
        f32 = dict(dtype=torch.float32, device=dev)
        layers = {}

        def norm(key):  # weight ones, a LayerNorm's bias zeros
            layers[key + "_w"] = torch.ones((L, E), **f32)
            if tr.norm == "ln":
                layers[key + "_b"] = torch.zeros((L, E), **f32)

        norm("attn_norm")
        if tr.parallel_blocks and cfg.n_head_kv > 1:  # Falcon-40B's ln_mlp
            norm("attn_norm2")
        elif not tr.parallel_blocks:
            norm("ffn_norm")
        for k in dense_linears:
            layers[k] = self.stack(k)
        for k, n in self.bias.items():
            layers[k] = torch.stack([self.draw(k, il, (n,), dtype=torch.float32)
                                     for il in range(L)])
        layers["pred_up_b"] = torch.zeros((L, FAMILY_R), dtype=self.dtype, device=dev)
        layers["pred_down_b"] = torch.stack([
            self.draw("pred_down_b", il, (cfg.n_ff,), scale=0.5, shift=-1.2)
            for il in range(L)])
        params = {"tok_embd": self.draw("tok_embd", 0, (V, E)),
                  "output_norm_w": torch.ones((E,), **f32), "layers": layers}
        if tr.norm == "ln":
            params["output_norm_b"] = torch.zeros((E,), **f32)
        if tr.pos_embd:
            params["pos_embd"] = self.draw("pos_embd", 0, (cfg.n_ctx_train + tr.pos_embd_offset,
                                                           E))
        return params

    def head(self):
        return self.draw("output", 0, (self.cfg.n_vocab, self.cfg.n_embd)).T.contiguous()

    def model(self):
        """The dense model in the model's dtype, as load_model lays it out."""
        from sparkinfer_tpu_torch.models.loader import LoadedModel

        params = self.small()
        params["layers"].update({k: self.stack(k) for k in self.lin if k.startswith("w_")})
        params["layers"].update(pred_up=self.stack("pred_up"), pred_down=self.stack("pred_down"))
        params["output"] = self.head()
        return LoadedModel(config=self.cfg, params=params)

    def q8_head(self):
        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor, flat_quantize

        ft = flat_quantize(self.head()[None])
        return QuantTensor(ft.q, ft.s, "q8_0")

    def q8_sparse_model(self, scfg):
        """bf16 attention (a fused QKV loads dequantized), Q8_0 flat FFN
        stores (prepare_pipelined_params(quant="q8_0"), each layer drawn and
        quantized on the card), Q8_0 predictor stacks and a Q8_0 head."""
        from sparkinfer_tpu_torch.models.loader import LoadedModel
        from sparkinfer_tpu_torch.ops.quant_matmul import flat_quantize
        from sparkinfer_tpu_torch.sparse.ffn import prepare_pipelined_params

        params = self.small()
        layers = params["layers"]
        layers.update({k: self.lazy(k) for k in self.lin if k.startswith("w_")})
        params["output"] = self.q8_head()
        params = prepare_pipelined_params(params, self.cfg, scfg, drop_dense=True,
                                          layout="v6", quant="q8_0")
        flat = params["sparse_flat"]
        flat["pred_up_qt"] = flat_quantize(self.lazy("pred_up"))
        flat["pred_down_qt"] = flat_quantize(self.lazy("pred_down"))
        layers = params["layers"]  # the stacks replace the per-layer predictor
        flat["pred_up_b_all"], flat["pred_down_b_all"] = layers.pop("pred_up_b"), layers.pop(
            "pred_down_b")
        for k in ("pred_up_b_nx", "pred_down_b_nx"):
            layers.pop(k)
        return LoadedModel(config=self.cfg, params=params)

    def q8_dense_ffn(self):
        """The same FFN draws as Q8_0 QuantTensors (L, in, out), each layer
        quantized on the card (the ggml Q8_0 blocks a GGUF holds)."""
        import torch

        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor, flat_quantize

        L, out = self.cfg.n_layer, {}
        for k in (k for k in self.lin if k.startswith("w_")):
            IN, OUT = self.lin[k]
            qt = QuantTensor(torch.empty((L, IN, OUT), dtype=torch.int8, device=self.device),
                             torch.empty((L, IN // 32, OUT), dtype=torch.float32,
                                         device=self.device), "q8_0")
            for il in range(L):
                ft = flat_quantize(self.layer(k, il)[None])
                qt.q[il].copy_(ft.q)
                qt.s[il].copy_(ft.s)
            out[k] = qt
        return out


def bf16_layer_bytes(cfg) -> int:
    """Device bytes a layer of the bf16 sparse engine adds beside the dense
    one: the dense weights, the flat up (and gate) stores' copy and the
    predictor's rolled copy (prepare_pipelined_params)."""
    E, F, R = cfg.n_embd, cfg.n_ff, FAMILY_R
    HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
    proj = 3 if cfg.traits.sparse_act in ("drelu", "fatrelu") else 2
    attn, ffn, pred = 2 * E * HD + 2 * E * KD, proj * E * F, E * R + R * F
    return 2 * (attn + ffn + pred) + 2 * (proj - 1) * E * F + 2 * pred


def family_v6_row(label, flat, L, ng, C, act, with_bias, per_call):
    """v6 against its plain version at a family's decode shape (N = 1),
    over the model's flat stores; ungated relu reads no gate store."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6,
        sparse_ffn_block_v6_plain,
        v6_plan,
    )

    R, E, G = flat["w_upT_flat"].shape
    gated = act != "relu"
    names = [k for k, _ in per_call[:-1]]
    check(len(names) == 1 and "v6_ffn" in names[0], f"v6 {label}: one call launched {names}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    idx = rows_sets(gen, N_SETS, 1, C, ng, L)
    x = torch.randn((1, E), generator=gen, device="cuda").to(torch.bfloat16)
    gp = torch.rand((1, C, G), generator=gen, device="cuda")
    bu = torch.randn((1, C, G), generator=gen, device="cuda") * 0.1 if with_bias else None
    wg = flat["w_gateT_flat"] if gated else None
    kw = dict(act=act, bu_sel=bu)
    args = lambda i: (x, idx[i % N_SETS], gp, flat["w_upT_flat"], wg, flat["w_down_flat"])
    got = sparse_ffn_block_v6(*args(0), **kw)
    torch.cuda.synchronize()
    err, tol = compare(f"v6 {label}", got, sparse_ffn_block_v6_plain(*args(0), **kw))
    ms = graph_ms(lambda i: sparse_ffn_block_v6(*args(i), **kw), N_SETS)
    plain_ms = graph_ms(lambda i: sparse_ffn_block_v6_plain(*args(i), **kw), 8)
    proj = 3 if gated else 2
    rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
    nbytes = (proj * rows_read * G * E * 2 + E * 2 + (2 if with_bias else 1) * C * G * 4
              + C * 4 + E * 4)
    bound_ms, by = bound(nbytes, 2 * proj * C * G * E, PEAK_F32_FLOP_S)
    row = dict(kernel="sparse_ffn_block_v6", shape=label, N=1, C=C, G=G, E=E, act=act,
               up_bias=with_bias, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
               launches_per_call=len(names), span_us=per_call,
               plan=v6_plan(x.device, 1, C, E, G, gated=gated))
    print("kernel check:", json.dumps(row))
    return row


def family_v6q_row(label, flat, L, ng, C, per_call):
    """v6q against its plain version at ReluFalcon-40B's decode shape
    (N = 1, ungated relu, no gate store) over the model's Q8_0 stores."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6q,
        sparse_ffn_block_v6q_plain,
        v6q_plan,
    )

    R, E, G = flat["qw_upT_flat"].shape
    names = [k for k, _ in per_call[:-1]]
    check(len(names) == 2 and "v6q_up" in names[0] and "v6q_down" in names[1],
          f"v6q {label}: one call launched {names}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    stores = [flat["qw_upT_flat"], flat["s_upT_flat"], None, None, flat["qw_down_flat"],
              flat["s_down_flat"]]
    idx = rows_sets(gen, N_SETS, 1, C, ng, L)
    x = torch.randn((1, E), generator=gen, device="cuda").to(torch.bfloat16)
    gp = torch.rand((1, C, G), generator=gen, device="cuda")
    kw = dict(act="relu")
    args = lambda i: (x, idx[i % N_SETS], gp, *stores)
    got = sparse_ffn_block_v6q(*args(0), **kw)
    torch.cuda.synchronize()
    err, tol = compare(f"v6q {label}", got, sparse_ffn_block_v6q_plain(*args(0), **kw))
    ms = graph_ms(lambda i: sparse_ffn_block_v6q(*args(i), **kw), N_SETS)
    plain_ms = graph_ms(lambda i: sparse_ffn_block_v6q_plain(*args(i), **kw), 8)
    rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
    nbytes = 2 * rows_read * G * E * 1.125 + E * 2 + C * G * 4 + C * 4 + E * 4
    bound_ms, by = bound(nbytes, 2 * 2 * C * G * E, PEAK_F32_FLOP_S)
    row = dict(kernel="sparse_ffn_block_v6q", shape=label, N=1, C=C, G=G, E=E, act="relu",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=by, library_ms=None, x_bound=ms / bound_ms,
               launches_per_call=len(names), span_us=per_call,
               plan=v6q_plan(x.device, 1, C, E, G))
    print("kernel check:", json.dumps(row))
    return row


def family_v1_row(label, rows, C, per_call):
    """v1 against its plain version at ReluFalcon-40B's width (E = 8192, its
    V1_MAX_E), N = 1 and 4, ungated relu, over the Scheduler's row stores
    (L, ng, G, E), each call C groups of one random layer per token."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block,
        sparse_ffn_block_plain,
        v1_plan,
    )

    wu, wd = rows["w_up_rows"], rows["w_down_rows"]
    L, ng, G, E = wu.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    out = []
    for N in (1, 4):
        names = [k for k, _ in per_call[N][:-1]]
        check(len(names) == 1 and "v1_ffn" in names[0], f"v1 {label} N={N}: launched {names}")
        sets = [(int(torch.randint(L, (1,), generator=gen, device="cuda")),
                 torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                              for _ in range(N)]).to(torch.int32)) for _ in range(N_SETS)]
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")

        def call(f, i):
            il, idx = sets[i % N_SETS]
            return f(x, idx, gp, wu[il], None, wd[il], act="relu")

        got = call(sparse_ffn_block, 0)
        torch.cuda.synchronize()
        err, tol = compare(f"v1 {label} N={N}", got, call(sparse_ffn_block_plain, 0))
        ms = graph_ms(lambda i: call(sparse_ffn_block, i), N_SETS)
        plain_ms = graph_ms(lambda i: call(sparse_ffn_block_plain, i), 8)
        rows_read = sum(len(torch.unique(idx)) for _, idx in sets) / N_SETS
        nbytes = 2 * rows_read * G * E * 2 + N * E * 2 + N * C * G * 4 + N * C * 4 + N * E * 4
        bound_ms, by = bound(nbytes, 2 * 2 * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel="sparse_ffn_block", shape=f"{label} N={N}", N=N, C=C, G=G, E=E,
                   act="relu", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   launches_per_call=len(names), span_us=per_call[N],
                   plan=v1_plan(x.device, N, C, E, G))
        print("kernel check:", json.dumps(row))
        out.append(row)
    return out[0]


def falcon_qmm_rows(params):
    """quant_matmul_2d (the Q8_0 head, 8192 x 65024) and quant_matmul_flat
    (the Q8_0 predictor stacks, 8192 x 1024 and 1024 x 32768 at every
    layer) against their plain versions at N = 1, with the bf16 matmul of
    the dequantized weights."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    flat, head = params["sparse_flat"], params["output"]
    E, V = head.q.shape
    specs = [("q8_0", 1, E, V, 1, "bfloat16")] + [
        ("q8_0", 1, flat[k].shape[0], flat[k].out_dim, 3, "float32")
        for k in ("pred_up_qt", "pred_down_qt")]
    per_call = kernels_per_call(specs)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    x = torch.randn((1, E), generator=gen, device="cuda").to(torch.bfloat16)
    rows = {"head": qmm_row(f"quant_matmul_2d q8_0 head {E}x{V} N=1", qm.quant_matmul_2d,
                            qm.quant_matmul_2d_plain, [(head.q, head.s)], x, "q8_0",
                            per_call[0])}
    for key, pc in zip(("pred_up_qt", "pred_down_qt"), per_call[1:]):
        t = flat[key]
        IN, OUT = t.shape[0], t.out_dim
        xf = torch.randn((1, IN), generator=gen, device="cuda")
        rows[key] = qmm_row(f"quant_matmul_flat q8_0 {IN}x{OUT} N=1", qm.quant_matmul_flat,
                            qm.quant_matmul_flat_plain,
                            [(t.q, t.s, il) for il in range(t.q.shape[1] // OUT)], xf, "q8_0",
                            pc, flat_out=OUT)
    return rows


def falcon_layer_gate(scfg, prompt, steps: int = 8) -> dict:
    """ReluFalcon-40B's first two layers (the full model's draws) on the
    card in bf16 against the f32 plain path over the same draws: greedy
    decode through the f32 plain forward (the pipelined FFN in "gather"
    mode), whose FFN at every call also feeds its own input (rounded to
    bf16) and carried selection to the bf16 kernel FFN (v6). Layer 1 reads
    the selection layer 0 carried, the same on both sides, so its outputs
    differ by bf16 roundings alone: each within FAMILY_FFN_TOL of the plain
    one's scale. Layer 0 selects from its own bf16 input, so a near-tie can
    select another group: its gap and the least share of the groups it
    carries for layer 1 that both sides select are printed. Then the whole block (LayerNorms, bf16 attention, the parallel
    sum) through the dense forward: its prefill logits within
    FAMILY_LAYER_TOL of the f32 forward's scale."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse.ffn import (
        make_pipelined_sparse_ffn,
        prepare_pipelined_params,
    )

    cfg = family_config("falcon40b", 2)
    mb = FamilyWeights(cfg, torch.bfloat16, "cuda", SEED).model()
    pf = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
          for k, v in mb.params.items()}
    pb = prepare_pipelined_params(mb.params, cfg, scfg, layout="v6")
    pfs = prepare_pipelined_params(pf, cfg, scfg, layout="v6")
    plain, carry_init = make_pipelined_sparse_ffn(cfg, scfg, mode="gather")
    kernel, _ = make_pipelined_sparse_ffn(cfg, scfg, mode="kernel")
    lps = []
    for il in range(2):
        lp = {k: v[il] for k, v in pb["layers"].items()}
        lp.update(pb["sparse_flat"], flat_il=il)
        lps.append(lp)
    rows = []

    def both(lp, x, carry, il):
        y, nxt = plain(lp, x, carry, il)
        yk, nk = kernel(lps[il], x.to(torch.bfloat16), carry, il)
        a = nxt["idx"].reshape(-1, nxt["idx"].shape[-1]).tolist()
        b = nk["idx"].reshape(-1, nk["idx"].shape[-1]).tolist()
        same = sum(len(set(p) & set(q)) for p, q in zip(a, b)) / sum(len(p) for p in a)
        rows.append((il, ((yk.float() - y).abs().max() / y.abs().max()).item(), same,
                     x.shape[1]))
        return y, nxt

    fwd = make_forward(cfg, ffn_fn=both, ffn_carry_init=carry_init)
    T = len(prompt)
    toks, pos = torch.tensor([prompt], device="cuda"), torch.arange(T, device="cuda")[None]
    with torch.inference_mode():
        cache = init_cache(cfg, 1, 64, torch.float32, "cuda")
        logits = fwd(pfs, toks, pos, cache)
        for i in range(steps):
            logits = fwd(pfs, logits[:, -1:].argmax(-1), torch.tensor([[T + i]], device="cuda"),
                         cache)
        dense = make_forward(cfg, fresh_prefill=True)
        lb = dense(mb.params, toks, pos, init_cache(cfg, 1, 64, torch.bfloat16, "cuda"))
        lf = dense(pf, toks, pos, init_cache(cfg, 1, 64, torch.float32, "cuda"))
    layer_gap = ((lb - lf).abs().max() / lf.abs().max()).item()
    worst = max(e for il, e, _, _ in rows if il == 1)
    row = {"ffn_calls": len(rows), "layer1_ffn_worst_gap": worst, "ffn_tol": FAMILY_FFN_TOL,
           "layer0_ffn_worst_gap": max(e for il, e, _, _ in rows if il == 0),
           "layer0_carried_selection_overlap": min(eq for il, _, eq, _ in rows if il == 0),
           "block_prefill_logits_gap": layer_gap, "layer_tol": FAMILY_LAYER_TOL,
           "tokens_per_call": sorted({n for *_, n in rows})}
    print("phase 5n, ReluFalcon-40B layer gate (2 layers, bf16 card against f32 plain):",
          json.dumps(row))
    check(worst <= FAMILY_FFN_TOL, f"5n layer gate: a layer-1 FFN call differs by {worst:.3e}")
    check(layer_gap <= FAMILY_LAYER_TOL, f"5n layer gate: the block's logits differ by "
                                         f"{layer_gap:.3e}")
    del mb, pb, pf, pfs
    torch.cuda.empty_cache()
    return row


# bf16 stores and a bf16 input against f32: each weight and the input
# round by at most 2^-9 relative, random signs, sums over 8192 terms
FAMILY_FFN_TOL = 1e-2
FAMILY_LAYER_TOL = 3e-2


def family_crossover(cfg, scfg, row_params, batches=(1, 4, 8, 16), steps: int = 8,
                     trials: int = 2) -> tuple[int, list]:
    """The Scheduler's two ticks at ReluFalcon-40B width, each replayed as a
    CUDA graph of its forward as the Scheduler runs it: masked-dense (the
    dense FFN's weights at every B) against v1 (the rows its tokens select),
    B rows all live, each from its own dense prefill, best of `trials` runs
    of `steps` steps, exact launch counts per run; the device span of one
    replay. Returns the largest B at which v1 wins (0 where it never does)
    and the rows."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.graphs import StepGraph
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse import ffn as sffn

    L = cfg.n_layer
    modes = {"masked_dense": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "dense")),
                              None),
             "v1": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "kernel")),
                    "sparse_ffn_block")}
    prefill = make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "dense"),
                           fresh_prefill=True)
    wrappers = kernel_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    table = []
    for B in batches:
        prompt = torch.randint(cfg.n_vocab, (B, 32), generator=gen, device="cuda")
        pos = torch.arange(32, device="cuda")[None].expand(B, 32)
        toks, ticks = {}, {}
        for name, (fwd, _) in modes.items():
            cache = init_cache(cfg, B, 32 + 2 + trials * steps, torch.bfloat16, "cuda")
            toks[name] = prefill(row_params, prompt, pos, cache)[:, -1].argmax(-1, keepdim=True)
            ticks[name] = StepGraph(
                lambda t, p, fwd=fwd, cache=cache: fwd(row_params, t, p, cache)[:, -1],
                B, torch.device("cuda"), capture=True, label=f"5n {name} tick")
        n_past, best = 32, dict.fromkeys(modes, float("inf"))
        for trial in range(trials + 1):  # trial 0 warms up (and captures)
            n = 1 if trial == 0 else steps
            for name, (_, kname) in modes.items():
                tick = ticks[name]
                warm = int(tick.graph is None)
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s in range(n):
                    tick.tokens.copy_(toks[name])
                    tick.positions.fill_(n_past + s)
                    logits = tick.run()
                    toks[name] = logits.argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check(bool(torch.isfinite(logits).all()), f"5n {name} tick B={B}: non-finite")
                for wname, w in wrappers.items():
                    want = L * (n + warm) if wname == kname else 0
                    check(w.launches == want,
                          f"5n {name} tick B={B}: {wname} launched {w.launches}, want {want}")
                if trial > 0:
                    best[name] = min(best[name], dt / n)
            n_past += n
        row = {"B": B, **{name: B / t for name, t in best.items()},
               "ms_per_step": {name: 1e3 * t for name, t in best.items()},
               "graph_device_ms": {name: replay_times(tick)["replay_span_ms"]
                                   for name, tick in ticks.items()}}
        print("phase 5n, ReluFalcon-40B ticks (aggregate tok/s, best of "
              f"{trials} x {steps} steps):", json.dumps(row))
        table.append(row)
        del ticks
        torch.cuda.empty_cache()
    crossover = max([r["B"] for r in table if r["v1"] > r["masked_dense"]], default=0)
    print(f"phase 5n: at n_ff {cfg.n_ff} the graphed v1 tick beats the graphed masked-dense "
          f"tick up to B={crossover}")
    return crossover, table


def family_pair(label, model, scfg, greedy, prompt, n_new, want, preprepared=False):
    """A family model's sparse Engine: the main path (exact counts), then
    graph against eager (streams equal, first decode logits bit-equal)."""
    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.engine import Engine

    eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg,
                 sparse_preprepared=preprepared, device="cuda")
    launches = main_path(label, eng, prompt, n_new, want)
    h = graph_vs_eager(label, eng, Engine(
        LoadedModel(config=model.config, params=eng.params), max_seq=1024, sampler=greedy,
        sparse=scfg, sparse_preprepared=True, device="cuda", cuda_graph=False), prompt, n_new)
    return eng, launches, h


def dense_pair(label, model, greedy, prompt, n_new):
    from sparkinfer_tpu_torch.runtime.engine import Engine

    return graph_vs_eager(label, Engine(model, max_seq=1024, sampler=greedy, device="cuda"),
                          Engine(model, max_seq=1024, sampler=greedy, device="cuda",
                                 cuda_graph=False), prompt, n_new)


def family_summary(label, sparse, dense, L, peak) -> dict:
    """Sparse and dense graph steps of one model: device and wall ms a
    step, tok/s and their ratio."""
    g, d = sparse["graph"], dense["graph"]
    return {"path": label, "layers": L, "peak_gib": peak,
            "sparse": {k: g[k] for k in ("tok_s", "wall_ms_per_step", "device_ms_per_step",
                                         "busy_share")},
            "dense": {k: d[k] for k in ("tok_s", "wall_ms_per_step", "device_ms_per_step",
                                        "busy_share")},
            "sparse_dense_tok_s": g["tok_s"] / d["tok_s"],
            "sparse_dense_eager_tok_s": sparse["eager"]["tok_s"] / dense["eager"]["tok_s"]}


def phase_families(greedy, n_new: int = 32, layers: int = 60) -> dict:
    """Phase 5n, ReluFalcon-40B's bf16 and Q8_0 models at most `layers` deep
    (60, its full depth, or what fits; the full run takes
    FULL_RUN_FAMILY_L); returns its summary, the main paths' launches and
    the kernel rows at the new shapes."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    t0 = time.perf_counter()
    out = {"launches": dict.fromkeys(("sparse_ffn_block_v6", "sparse_ffn_block_v6q",
                                      "sparse_ffn_block", "quant_matmul_2d",
                                      "quant_matmul_flat"), 0), "rows": {}}

    def add(launches):
        for k in out["launches"]:
            out["launches"][k] += launches.get(k, 0)

    scfg = SparseConfig(group_size=128, capacity_groups=FAMILY_C["falcon40b"])
    gen = torch.Generator().manual_seed(SEED + 45)
    prompt = torch.randint(65024, (32,), generator=gen).tolist()
    per_call = kernels_per_call(
        [["v6", 1, 36, 8192, 128, "bfloat16", "relu"], ["v6", 1, 18, 4096, 128, "bfloat16",
                                                         "relu"],
         ["v6", 1, 21, 3584, 128, "bfloat16", "drelu"], ["v6q", 1, 36, 8192, 128, "bfloat16"],
         ["rows", 1, 36, 8192, 128, "bfloat16", "sparse_ffn_block"],
         ["rows", 4, 36, 8192, 128, "bfloat16", "sparse_ffn_block"]], spans=True)
    out["gate"] = falcon_layer_gate(scfg, prompt)
    mark("phase 5n, layer gate")

    # (a) ReluFalcon-40B bf16 beside its dense counterpart, at the depth that fits
    cfg60 = family_config("falcon40b", 60)
    free, _ = torch.cuda.mem_get_info()
    outside = 2 * 2 * cfg60.n_vocab * cfg60.n_embd  # embeddings and head, bf16
    L = min(layers, int((free - outside - FAMILY_HEADROOM) // bf16_layer_bytes(cfg60)))
    cfg = family_config("falcon40b", L)
    ng = scfg.n_groups(cfg.n_ff)
    fw = FamilyWeights(cfg, torch.bfloat16, "cuda", SEED)
    model = fw.model()
    print(f"phase 5n: ReluFalcon-40B bf16 at {L} of 60 layers ({free / 2**30:.2f} GiB free, "
          f"{bf16_layer_bytes(cfg) / 2**30:.3f} GiB a layer with its sparse stores); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng, l_a, h_sparse = family_pair("ReluFalcon-40B bf16 sparse", model, scfg, greedy, prompt,
                                     n_new, lambda s: {"sparse_ffn_block_v6": L * s})
    add(l_a)
    peak_b = PEAKS["ReluFalcon-40B bf16 sparse"]
    out["rows"]["v6 falcon40b"] = family_v6_row(
        "ReluFalcon-40B N=1 C=36 G=128 E=8192 relu", eng.params["sparse_flat"], L, ng,
        scfg.capacity(cfg.n_ff), "relu", True, per_call[0])
    del eng
    torch.cuda.empty_cache()
    h_dense = dense_pair("ReluFalcon-40B bf16 dense", model, greedy, prompt, n_new)
    out["bf16"] = family_summary("ReluFalcon-40B bf16", h_sparse, h_dense, L, peak_b)
    print("phase 5n, ReluFalcon-40B bf16:", json.dumps(out["bf16"]))
    torch.cuda.empty_cache()
    mark("phase 5n(a) bf16")

    # (b) the 4-slot Scheduler at the same depth (v1 at E = 8192, ungated),
    # graph against eager, then the crossover of its two ticks
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_batch_max=4, device="cuda")
    out["rows"]["v1 falcon40b"] = family_v1_row("ReluFalcon-40B C=36 G=128 E=8192 relu",
                                                sched.params["layers"], scfg.capacity(cfg.n_ff),
                                                {1: per_call[4], 4: per_call[5]})
    gen = torch.Generator().manual_seed(SEED + 46)
    prompts = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    out["launches"]["sparse_ffn_block"] += scheduler_path(sched, prompts, 16,
                                                          label="ReluFalcon-40B bf16")
    prompts_h = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    out["scheduler"] = scheduler_graph_vs_eager(sched, Scheduler(  # over the same row stores
        LoadedModel(config=cfg, params=sched.params), n_slots=4, max_seq=128, sampler=greedy,
        sparse=scfg, sparse_batch_max=4, sparse_preprepared=True, device="cuda",
        cuda_graph=False), prompts_h, 16, label="ReluFalcon-40B bf16")
    out["crossover"], out["ticks"] = family_crossover(cfg, scfg, sched.params)
    del sched, model, fw
    torch.cuda.empty_cache()
    mark("phase 5n(b)")

    # (a) ReluFalcon-40B Q8_0: `layers` if 8 layers' bytes scale to under the limit
    cfg8 = family_config("falcon40b", 8)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fw8 = FamilyWeights(cfg8, torch.bfloat16, "cuda", SEED)
    m8 = fw8.q8_sparse_model(scfg)
    built8 = torch.cuda.memory_allocated() - base
    outside_q8 = (2 * cfg8.n_vocab * cfg8.n_embd + m8.params["output"].q.numel()
                  + 4 * m8.params["output"].s.numel())
    per_layer = (built8 - outside_q8) / 8
    L = min(layers, int((FAMILY_Q8_LIMIT - outside_q8 - FAMILY_HEADROOM) // per_layer))
    print(f"phase 5n: ReluFalcon-40B Q8_0 at 8 layers took {built8 / 2**30:.2f} GiB "
          f"({per_layer / 2**30:.3f} a layer): {L} layers fit under "
          f"{FAMILY_Q8_LIMIT / 2**30:.0f} GiB")
    if L == 8:  # the measured model is the one to run (the same draws)
        cfg, fw, model = cfg8, fw8, m8
    else:
        del m8, fw8
        torch.cuda.empty_cache()
        cfg = family_config("falcon40b", L)
        fw = FamilyWeights(cfg, torch.bfloat16, "cuda", SEED)
        model = fw.q8_sparse_model(scfg)
    print(f"phase 5n: ReluFalcon-40B Q8_0 at {L} layers, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    def want_q8(steps):  # v6q and the predictor stacks a layer, the head a forward
        return {"sparse_ffn_block_v6q": L * steps, "quant_matmul_2d": steps + 1,
                "quant_matmul_flat": 2 * (L + 1) * steps + 2 * L}

    eng, l_q, h_sparse = family_pair("ReluFalcon-40B Q8_0 sparse", model, scfg, greedy, prompt,
                                     n_new, want_q8, preprepared=True)
    add(l_q)
    peak_q = PEAKS["ReluFalcon-40B Q8_0 sparse"]
    out["rows"]["v6q falcon40b"] = family_v6q_row(
        "ReluFalcon-40B N=1 C=36 G=128 E=8192 q8_0 relu", model.params["sparse_flat"], L,
        scfg.n_groups(cfg.n_ff), scfg.capacity(cfg.n_ff), per_call[3])
    out["rows"].update({f"qmm {k}": r for k, r in falcon_qmm_rows(model.params).items()})
    del eng
    dense_params = dict(model.params)
    dense_params.pop("sparse_flat")
    del model
    torch.cuda.empty_cache()
    dense_params["layers"] = dict(dense_params["layers"], **fw.q8_dense_ffn())
    h_dense = dense_pair("ReluFalcon-40B Q8_0 dense",
                         LoadedModel(config=cfg, params=dense_params), greedy, prompt, n_new)
    out["q8_0"] = family_summary("ReluFalcon-40B Q8_0", h_sparse, h_dense, L, peak_q)
    print("phase 5n, ReluFalcon-40B Q8_0:", json.dumps(out["q8_0"]))
    del dense_params, fw
    torch.cuda.empty_cache()
    mark("phase 5n(a) Q8_0")

    # (c) OPT-6.7B and Qwen2-7B widths, 4 layers, bf16: v6 on the ungated
    # branch with both biases and on the dReLU branch
    out["cut"] = {}
    for kind, pc, act, bias in (("opt6.7b", per_call[1], "relu", True),
                                ("qwen2-7b", per_call[2], "drelu", False)):
        cfg = family_config(kind, FAMILY_CUT_L)
        scfg_k = SparseConfig(group_size=128, capacity_groups=FAMILY_C[kind])
        model = FamilyWeights(cfg, torch.bfloat16, "cuda", SEED).model()
        p = torch.randint(cfg.n_vocab, (32,), generator=gen).tolist()
        label = f"{kind} bf16 sparse"
        eng, l_c, h = family_pair(label, model, scfg_k, greedy, p, n_new,
                                  lambda s: {"sparse_ffn_block_v6": FAMILY_CUT_L * s})
        add(l_c)
        E, C = cfg.n_embd, scfg_k.capacity(cfg.n_ff)
        out["rows"][f"v6 {kind}"] = family_v6_row(
            f"{kind} N=1 C={C} G=128 E={E} {act}" + (" + up bias" if bias else ""),
            eng.params["sparse_flat"], FAMILY_CUT_L, scfg_k.n_groups(cfg.n_ff), C, act, bias,
            pc)
        out["cut"][kind] = {"layers": FAMILY_CUT_L, "peak_gib": PEAKS[label],
                            **{k: h["graph"][k] for k in ("tok_s", "wall_ms_per_step",
                                                          "device_ms_per_step")}}
        del eng, model
        torch.cuda.empty_cache()
    mark("phase 5n(c)")
    out["seconds"] = time.perf_counter() - t0
    return out


def families_summary(fam) -> dict:
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    return {"gate": fam["gate"], "bf16": fam["bf16"], "q8_0": fam["q8_0"],
            "scheduler": {k: fam["scheduler"][k] for k in ("graph", "eager")},
            "crossover": fam["crossover"],
            "ticks": [{"B": r["B"], "v1_tok_s": r["v1"], "masked_dense_tok_s": r["masked_dense"],
                       "device_ms": r["graph_device_ms"]} for r in fam["ticks"]],
            "cut": fam["cut"], "launches": fam["launches"],
            "rows": {k: {f: r[f] for f in keys} for k, r in fam["rows"].items()},
            "seconds": fam["seconds"]}


def families_only(greedy) -> int:
    """`chip_smoke.py --families`: phase 5n alone (after phases 1 and 2),
    for working on it; prints its summary and no result."""
    print("phase 5n summary:", json.dumps(families_summary(phase_families(greedy))))
    return 0


# --- phase 5o: sliding-window attention: gpt-oss-20b and a gemma3 cut -------
# openai/gpt-oss-20b config.json: 24 layers, hidden 2880, 64 heads, 8 KV heads,
# head_dim 64, 32 experts of width 2880, 4 used (softmax over the 4 selected
# logits, router bias, no renormalization), sliding_window 128 on alternate
# layers (the first sliding), vocab 201088, rope theta 150000 with yarn factor
# 32 over 4096 original positions, rms eps 1e-5, q/k/v and output biases,
# attention sinks, untied head; its experts' width 2880 is no multiple of 128,
# so the fused FFN's groups are 64 rows (45 an expert, C = 180 a token).
# google/gemma-3-4b-pt config.json (text): hidden 2560, 8 heads, 4 KV heads,
# head_dim 256, ffn 10240, sliding window 1024 on 5 of every 6 layers, rope
# bases 10000 (sliding, unscaled) and 1e6 (global, linear factor 8), query
# scale 256^-0.5, rms eps 1e-6, vocab 262208, tied head, per-head q/k norms,
# sandwich norms; cut to 6 layers (one pattern block). Random weights from
# SEED, drawn on the card.

SWA_GATE_TOL = 1e-4  # f32: fused FFN against dense, iSWA logits against the full cache
# bf16, teacher-forced: the ring and the full cache attend over the same keys
# in products of another width (1152 against 2048 slots), so f32 sums differ
# in their last bits, and the bf16 roundings that follow flip some values by
# one bf16 ulp (2^-8 of the value), which 24 layers carry to the logits; a
# wrong ring slot or window hides or adds whole keys and errs by a sizeable
# part of the logits' scale. With random weights such a flip also moves a
# token's top-4 experts where its router logits nearly tie, and one other
# expert changes the logits by a large part of their scale, so this
# check runs on the model with a decisive router (SWA_ROUTE_BIAS), and the
# gap of the model as drawn is printed beside that of two full caches of
# another width, which differ only by such roundings.
SWA_ISWA_TOL = 5e-2
SWA_ROUTE_BIAS = 30.0  # added to k random experts' router logits a layer: 28 times their spread
# bf16 Scheduler (on the decisive router) against single-sequence Engine
# streams: a tick computes 4 rows in products of another shape than a 1-row
# step, so the logits drift apart as the ring's and the full cache's do
# (within SWA_ISWA_TOL); where two streams part, the Engine's logit of the
# Scheduler's token must lie within that share of the logits' scale of its
# best (a near-tie: a token need not be the Engine's second, where several
# lie within roundings of the best)
SWA_TIE_TOL = SWA_ISWA_TOL
SWA_PROMPT_LONG = 1400  # past the 1152-slot ring of window 128 + chunk 1024


def gpt_oss_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="gpt-oss", n_layer=L, n_embd=2880, n_head=64, n_head_kv=8,
                       head_dim=64, n_ff=2880, n_ff_exp=2880, n_vocab=201088, n_expert=32,
                       n_expert_used=4, expert_gating="softmax_topk", norm_topk_prob=False,
                       norm_eps=1e-5, rope_freq_base=150000.0, rope_scale=1.0 / 32,
                       rope_scaling_type="yarn", rope_orig_ctx=4096, sliding_window=128,
                       n_ctx_train=131072)


def random_gpt_oss(cfg, dtype, seed):
    """A LoadedModel with the loader's keys and dtypes for gpt-oss, drawn on
    the card: N(0, 0.02) projections, router and experts (one resident copy,
    (L, X, Fe, E) stacks), N(0, 0.02) biases (q/k/v/output in f32, the
    router's and the experts' in the model's dtype), N(0, 1) sinks in f32,
    ones for the norms."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32

    def normal(shape, std=0.02, dt=dtype):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(0.0, std, generator=gen)

    L, E, H, Hkv, D = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim
    X, Fe, V = cfg.n_expert, cfg.n_ff_exp, cfg.n_vocab
    ones = dict(dtype=f32, device="cuda")
    layers = {"attn_norm_w": torch.ones((L, E), **ones), "ffn_norm_w": torch.ones((L, E), **ones),
              "wq": normal((L, E, H * D)), "wk": normal((L, E, Hkv * D)),
              "wv": normal((L, E, Hkv * D)), "wo": normal((L, H * D, E)),
              "bq": normal((L, H * D), dt=f32), "bk": normal((L, Hkv * D), dt=f32),
              "bv": normal((L, Hkv * D), dt=f32), "bo": normal((L, E), dt=f32),
              "attn_sinks": normal((L, H), 1.0, f32),
              "w_router": normal((L, E, X)), "w_router_b": normal((L, X))}
    for name in ("up", "gate", "down"):
        layers[f"w_{name}_exps"] = normal((L, X, Fe, E))
        layers[f"w_{name}_exps_b"] = normal((L, X, E if name == "down" else Fe))
    params = {"tok_embd": normal((V, E)), "output_norm_w": torch.ones((E,), **ones),
              "output": normal((E, V)), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def decisive_router(model, seed):
    """The model with SWA_ROUTE_BIAS added to the router bias of k random
    experts a layer (k = n_expert_used; a new bias stack, every other
    tensor shared): every token takes those k experts, weighted by its own
    router logits, so a last-bit difference in the stream moves no token
    to another expert."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    layers = model.params["layers"]
    bias = layers["w_router_b"].clone()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for il in range(bias.shape[0]):
        pick = torch.randperm(bias.shape[1], generator=gen,
                              device="cuda")[:model.config.n_expert_used]
        bias[il, pick] += SWA_ROUTE_BIAS
    return LoadedModel(config=model.config,
                       params={**model.params, "layers": {**layers, "w_router_b": bias}})


def gemma3_4b_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="gemma3", n_layer=L, n_embd=2560, n_head=8, n_head_kv=4,
                       head_dim=256, n_ff=10240, n_vocab=262208, norm_eps=1e-6,
                       rope_freq_base=1e6, rope_freq_base_swa=1e4, rope_scale=1.0 / 8,
                       rope_scaling_type="linear", sliding_window=1024, attn_scale=256 ** -0.5,
                       tie_embeddings=True)


def random_gemma3(cfg, seed):
    """A bf16 gemma3 LoadedModel drawn on the card: N(0, 0.02) projections,
    1 + N(0, 0.1) block, sandwich and q/k norms in f32, the head the
    embeddings' transpose (the loader's tied head)."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32, bf = torch.float32, torch.bfloat16

    def normal(shape, std=0.02, dt=bf):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(0.0, std, generator=gen)

    L, E, H, Hkv, D, F = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim,
                          cfg.n_ff)
    layers = {k: 1.0 + normal((L, E), 0.1, f32) for k in (
        "attn_norm_w", "attn_post_norm_w", "ffn_norm_w", "ffn_post_norm_w")}
    layers.update(wq=normal((L, E, H * D)), wk=normal((L, E, Hkv * D)),
                  wv=normal((L, E, Hkv * D)), wo=normal((L, H * D, E)),
                  attn_q_norm_w=1.0 + normal((L, D), 0.1, f32),
                  attn_k_norm_w=1.0 + normal((L, D), 0.1, f32),
                  w_up=normal((L, E, F)), w_gate=normal((L, E, F)), w_down=normal((L, F, E)))
    tok = normal((cfg.n_vocab, E))
    params = {"tok_embd": tok, "output": tok.T.contiguous(), "layers": layers,
              "output_norm_w": 1.0 + normal((E,), 0.1, f32)}
    return LoadedModel(config=cfg, params=params)


def rel_gap(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def teacher_forced(engines, prompt, tokens) -> dict:
    """Each engine prefills `prompt` (in its prefill_chunk chunks) and then
    decodes `tokens`, one a step, whatever it samples: the largest gap of
    each engine's logits to the first's, over the prefill's last row and
    every step, relative to the first's scale."""
    import torch

    runs = []
    for eng in engines:
        cache, st = eng.new_cache(), eng.new_sampler_state()
        _, cache, st, n = eng.prefill(prompt, cache, st)
        rows = [eng.last_logits.clone()]
        for i, tok in enumerate(tokens):
            eng.decode_step(tok, n + i, cache, st)
            rows.append(eng.last_logits.clone())
        check(all(bool(torch.isfinite(r).all()) for r in rows), "5o: non-finite logits")
        runs.append(rows)
        del cache
    return [max(rel_gap(g, w) for g, w in zip(rows, runs[0])) for rows in runs[1:]]


def swa_f32_gates(prompt, long_prompt, steps: int = 8) -> dict:
    """gpt-oss-20b widths cut to 4 layers, f32. (1) The fused mode (v1 with
    the bias rows and swiglu_oai) against dense mode layer by layer: the
    dense forward feeds each layer's FFN input to the fused FFN too, whose
    output must lie within SWA_GATE_TOL of the dense one's scale at every
    layer of a 32-token prompt and `steps` decode steps, and the two
    forwards' greedy tokens must be equal. (2) The iSWA cache against the
    full cache, teacher-forced through Engines in pallas mode: the
    1400-token prompt in chunks of 1024 into 1152-slot rings and 32 decode
    steps, every step's logits within SWA_GATE_TOL. (3) The 4-slot
    Scheduler against the Engine (swa_scheduler, f32, the decisive router):
    streams equal, or parted within SWA_GATE_TOL of a tie."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.sparse.moe import make_moe_ffn, moe_layout

    t0 = time.perf_counter()
    cfg = gpt_oss_config(4)
    model = random_gpt_oss(cfg, torch.float32, SEED + 51)
    params = {**model.params, "layers": moe_layout(model.params["layers"], cfg)}
    dense, fused = make_moe_ffn(cfg, mode="dense"), make_moe_ffn(cfg, mode="pallas")
    errs = []

    def gate(lp, x):
        want = dense(lp, x)
        got = fused(lp, x)
        errs.append(((got - want).abs().max() / want.abs().max()).item())
        return want

    n0 = sf.sparse_ffn_block.launches
    toks = {name: greedy_tokens(make_forward(cfg, ffn_fn=f), params, cfg, prompt, steps)
            for name, f in (("dense", gate), ("pallas", fused))}
    n_fwd = 4 * (steps + 1)
    check(sf.sparse_ffn_block.launches - n0 == 2 * n_fwd and len(errs) == n_fwd,
          f"5o gate: {sf.sparse_ffn_block.launches - n0} v1 launches, {len(errs)} layers")
    worst = max(errs)
    check(worst <= SWA_GATE_TOL, f"5o gate: a layer's fused FFN is {worst:.3e} of its scale off")
    check(toks["dense"] == toks["pallas"], f"5o gate: greedy tokens differ {toks}")
    del params
    greedy = SamplerConfig(temp=0.0)
    kw = dict(max_seq=2048, sampler=greedy, kv_dtype=torch.float32, device="cuda",
              moe_mode="pallas")
    forced = torch.randint(cfg.n_vocab, (32,), generator=torch.Generator().manual_seed(SEED + 52))
    gap = teacher_forced([Engine(model, **kw), Engine(model, kv_iswa=True, **kw)],
                         long_prompt, forced.tolist())[0]
    check(gap <= SWA_GATE_TOL, f"5o gate: iSWA logits {gap:.3e} of their scale off the full "
                               f"cache's")
    sched = swa_scheduler(decisive_router(model, SEED + 57), greedy, tie_tol=SWA_GATE_TOL)
    row = {"layers": 4, "steps": steps, "layer_outputs": n_fwd, "worst_rel_err": worst,
           "tokens": toks["dense"], "iswa_rel_gap": gap, "iswa_prompt": len(long_prompt),
           "iswa_steps": 32, "scheduler_streams_equal": sched["streams_equal"],
           "scheduler_parted_gap": sched["parted_gap"], "seconds": time.perf_counter() - t0}
    print("phase 5o, f32 gates (gpt-oss-20b widths, 4 layers):", json.dumps(row))
    return row


def kv_bytes(cache) -> int:
    return sum(b.numel() * b.element_size() for b in cache.buffers())


def swa_long_context(model, greedy, prompt) -> list:
    """Engine(moe_mode="pallas") at max_seq 32768 with the full cache and
    with the iSWA cache: KV bytes, and the device ms of a decode step (one
    replay's span) after 16 greedy tokens; attention reads every slot of a
    layer's cache, masked or not, so the full cache's step grows with
    max_seq and a ring's does not."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    out = []
    for iswa in (False, True):
        eng = Engine(model, max_seq=32768, sampler=greedy, device="cuda", moe_mode="pallas",
                     kv_iswa=iswa)
        toks = run_generate(eng, prompt, 16)
        step = eng.graphs.get(eng.cache, 1, "decode", None)
        row = {"kv_iswa": iswa, "max_seq": 32768, "kv_bytes": kv_bytes(eng.cache),
               "ring_slots": ([a.shape[2] for a in eng.cache.k] if iswa else None),
               "tok_s": eng.perf.decode_tps, **replay_times(step), "tokens_first8": toks[:8]}
        print("phase 5o, long context:", json.dumps(row))
        out.append(row)
        del eng, step
        torch.cuda.empty_cache()
    return out


def swa_scheduler(model, greedy, n_new: int = 128, tie_tol: float = SWA_TIE_TOL,
                  phase: str = "5o", label: str = "gpt-oss-20b Scheduler, dense MoE, "
                                                    "window as a mask") -> dict:
    """The 4-slot Scheduler over gpt-oss (a full cache a slot, the window as
    its mask, dense MoE, the tick a CUDA graph; the decisive router), its
    KV cache in the model's dtype: 4 greedy requests of 32-token prompts
    and 128 new tokens, past the window, against the single-sequence
    Engine(moe_mode="dense") streams of the same prompts: equal, or parted
    at a near-tie of the Engine's (within tie_tol of the logits' scale),
    after which the rest of the stream is not compared."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler

    dtype = model.params["tok_embd"].dtype
    sched = Scheduler(model, n_slots=4, max_seq=1024, sampler=greedy, kv_dtype=dtype,
                      device="cuda")
    gen = torch.Generator().manual_seed(SEED + 53)
    prompts = [torch.randint(model.config.n_vocab, (32,), generator=gen).tolist()
               for _ in range(4)]
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    while sched.step():
        check(bool(torch.isfinite(sched.last_logits).all()),
              f"{phase} Scheduler: non-finite logits")
    launches = {k: w.launches for k, w in wrappers.items()}
    check(not any(launches.values()), f"{phase} Scheduler: dense MoE launched {launches}")
    check(sched.graphs.captures == 1, f"{phase} Scheduler: {sched.graphs.captures} captures")
    m = sched.metrics_snapshot()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del sched
    torch.cuda.empty_cache()
    eng = Engine(model, max_seq=1024, sampler=greedy, kv_dtype=dtype, device="cuda",
                 moe_mode="dense")
    parted, gaps = [], []
    for p, r in zip(prompts, reqs):
        got = r.tokens()
        check(len(got) == n_new, f"{phase} Scheduler: a short stream")
        i = gap = want = None
        for j, tok in enumerate(eng.generate(p, n_new, stream=True)):
            if tok != got[j]:  # where they part: how far the Scheduler's token lies below
                row = eng.last_logits[0].float()
                i, want, gap = j, tok, ((row[tok] - row[got[j]]) / row.abs().max()).item()
                break
        if gap is not None:
            check(gap <= tie_tol, f"{phase} Scheduler: stream parts from the Engine's at token "
                                      f"{i} ({got[i]} vs the Engine's {want}), {gap} of the "
                                      f"logits' scale below its best")
        parted.append(i)
        gaps.append(gap)
    ticks = m["n_decode_steps"]
    row = {"path": f"{label}, {dtype}",
           "slots": 4, "requests": 4, "new_tokens": n_new, "ticks": ticks,
           "decode_tok_s": (m["n_tokens_generated"] - m["n_requests"]) / m["t_decode_s"],
           "ms_per_tick": 1e3 * m["t_decode_s"] / ticks, "prefill_tps": m["prefill_tps"],
           "peak_gib": peak, "streams_equal": sum(i is None for i in parted),
           "parted_at": parted, "parted_gap": gaps}
    print(f"phase {phase}, Scheduler:", json.dumps(row))
    return row


def swa_gemma3(greedy) -> dict:
    """gemma3 at Gemma-3-4B width cut to 6 layers, bf16, Engine(kv_iswa=True)
    with prefill_chunk 256 (rings of 1280 slots): a 1400-token prompt and
    64 greedy tokens, the graph's stream and first decode logits against an
    eager engine's over the same model (bit-equal), past ring wraps."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    cfg = gemma3_4b_config(6)
    model = random_gemma3(cfg, SEED + 54)
    kw = dict(max_seq=2048, sampler=greedy, device="cuda", kv_iswa=True)
    engines = [Engine(model, **kw), Engine(model, cuda_graph=False, **kw)]
    for eng in engines:
        eng.prefill_chunk = 256
    prompt = torch.randint(cfg.n_vocab, (SWA_PROMPT_LONG,),
                           generator=torch.Generator().manual_seed(SEED + 55)).tolist()
    row = graph_vs_eager("gemma-3-4b 6 layers iSWA", *engines, prompt, 64)
    rings = [a.shape[2] for a in engines[0].cache.k]
    check(rings == [1280, 2048], f"5o gemma3: rings {rings}")
    out = {"path": row["path"], "graph_tok_s": row["graph"]["tok_s"],
           "eager_tok_s": row["eager"]["tok_s"],
           "graph_device_ms_per_step": row["graph"]["device_ms_per_step"],
           "cache_slots": rings, "prompt": len(prompt), "seconds": time.perf_counter() - t0}
    print("phase 5o, gemma3:", json.dumps(out))
    del engines, model
    torch.cuda.empty_cache()
    return out


def phase_swa(greedy, L: int = 24) -> dict:
    """Phase 5o: the f32 gates, then gpt-oss-20b at full width and depth L
    (24; the full run's child takes FULL_RUN_SWA_L) in bf16 (v1 at its
    shape, the pallas Engine with and without the iSWA cache and the dense
    Engine, iSWA against the full cache teacher-forced past a ring wrap,
    both caches at max_seq 32768, the Scheduler), then the gemma3 cut.
    Returns its summary, with v1's main-path launches."""
    import gc

    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5o: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 50)
    prompt = torch.randint(201088, (32,), generator=gen).tolist()
    long_prompt = torch.randint(201088, (SWA_PROMPT_LONG,), generator=gen).tolist()
    gates = swa_f32_gates(prompt, long_prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5o, f32 gates")
    cfg = gpt_oss_config(L)
    t1 = time.perf_counter()
    model = random_gpt_oss(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    weights = sum(t.numel() for t in [model.params["tok_embd"], model.params["output"],
                                      *model.params["layers"].values()])
    print(f"model: gpt-oss-20b widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"Hkv={cfg.n_head_kv} D={cfg.head_dim} X={cfg.n_expert} k={cfg.n_expert_used} "
          f"Fe={cfg.n_ff_exp} V={cfg.n_vocab} window={cfg.sliding_window}, bf16, {weights} "
          f"weights built in {time.perf_counter() - t1:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    v1_rows = moe_v1_rows(model, path="gpt-oss", Ns=(1, 32))
    mark("phase 5o, v1 at the gpt-oss shape")
    engines = [moe_engine(f"gpt-oss-20b bf16 {mode}{' iSWA' if iswa else ''}", model, greedy,
                          prompt, 128, mode, phase="5o", eager_stream=True, max_seq=2048,
                          kv_iswa=iswa)
               for mode, iswa in (("pallas", True), ("pallas", False), ("dense", False))]
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5o, engines")
    kw = dict(sampler=greedy, device="cuda", moe_mode="pallas")
    forced = torch.randint(cfg.n_vocab, (32,), generator=gen).tolist()
    fixed = decisive_router(model, SEED + 56)
    gap = teacher_forced([Engine(fixed, max_seq=2048, **kw),
                          Engine(fixed, max_seq=2048, kv_iswa=True, **kw)],
                         long_prompt, forced)[0]
    check(gap <= SWA_ISWA_TOL, f"5o: bf16 iSWA logits {gap:.3e} of their scale off the full "
                               f"cache's")
    drawn = teacher_forced([Engine(model, max_seq=2048, **kw),
                            Engine(model, max_seq=2048, kv_iswa=True, **kw),
                            Engine(model, max_seq=1536, **kw)], long_prompt, forced)
    iswa_row = {"prompt": len(long_prompt), "steps": len(forced), "ring_slots": 1152,
                "rel_gap_decisive_router": gap, "tol": SWA_ISWA_TOL,
                "rel_gap_as_drawn": drawn[0], "rel_gap_as_drawn_full_1536_vs_2048": drawn[1]}
    print("phase 5o, iSWA against the full cache (bf16, teacher-forced):",
          json.dumps(iswa_row))
    gc.collect()
    torch.cuda.empty_cache()
    long_ctx = swa_long_context(model, greedy, prompt)
    sched = swa_scheduler(fixed, greedy)
    del model, fixed
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5o, gpt-oss-20b")
    gemma = swa_gemma3(greedy)
    return {"f32_gates": gates, "v1_gpt_oss": v1_rows, "engines": engines,
            "iswa": iswa_row, "long_context": long_ctx, "scheduler": sched,
            "gemma3": gemma, "v1_launches": sum(r["launches"] for r in engines),
            "weights": weights, "seconds": time.perf_counter() - t0}


def swa_summary(swa) -> dict:
    """Phase 5o's numbers in brief, for the end of the full run's output."""
    keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "v1_share_of_device",
            "replay_span_ms", "prefill_ms", "peak_gib", "launches")
    return {"f32_gate_worst": swa["f32_gates"]["worst_rel_err"],
            "f32_iswa_gap": swa["f32_gates"]["iswa_rel_gap"],
            "f32_scheduler_streams_equal": swa["f32_gates"]["scheduler_streams_equal"],
            "bf16_iswa": swa["iswa"],
            "v1_gpt_oss": [{k: r[k] for k in ("N", "ms", "bound_ms", "plain_ms", "x_bound")}
                           for r in swa["v1_gpt_oss"]],
            "engines": [{"path": r["path"], **{k: r[k] for k in keys}} for r in swa["engines"]],
            "long_context": [{k: r[k] for k in ("kv_iswa", "kv_bytes", "replay_span_ms",
                                                "tok_s")} for r in swa["long_context"]],
            "scheduler": {k: swa["scheduler"][k] for k in (
                "decode_tok_s", "ms_per_tick", "peak_gib", "streams_equal", "parted_at")},
            "gemma3": swa["gemma3"], "seconds": swa["seconds"]}


# --- phase 5p: deepseek2, DeepSeek-V2-Lite at full width and depth -----------
# deepseek-ai/DeepSeek-V2-Lite config.json: 27 layers, hidden 2048, 16 heads,
# no q-lora (a direct q projection), kv_lora_rank 512, qk_nope_head_dim 128,
# qk_rope_head_dim 64, v_head_dim 128, first_k_dense_replace 1 (its dense FFN
# intermediate_size 10944), 64 routed experts of moe_intermediate_size 1408,
# 6 a token, softmax scoring, norm_topk_prob false, routed_scaling_factor
# 1.0, 2 shared experts, vocab 102400, rope theta 10000 with yarn (factor
# 40, original context 4096), rms eps 1e-6. Random weights from SEED, drawn
# on the card; the cache is the latent cache (512 + 64 a token a layer).

MLA_GATE_TOL = MOE_TOL  # f32: the fused FFN against dense mode, of the output's scale
MLA_ROUTE_BIAS = 30.0  # a selection bias on k random experts a layer, for the Scheduler check


def deepseek_v2_lite_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    # n_head_kv = n_head: the JAX config's quirk under MLA; the latent cache ignores it
    return ModelConfig(arch="deepseek2", n_layer=L, n_embd=2048, n_head=16, n_head_kv=16,
                       head_dim=192, rope_dim=64, kv_lora_rank=512, v_head_dim=128,
                       n_ff=10944, n_ff_exp=1408, n_vocab=102400, n_expert=64,
                       n_expert_used=6, n_expert_shared=2, expert_weights_scale=1.0,
                       norm_topk_prob=False, norm_eps=1e-6, rope_freq_base=10000.0,
                       rope_scale=1.0 / 40, rope_scaling_type="yarn", rope_orig_ctx=4096,
                       n_dense_lead=1, n_ctx_train=163840)


def random_deepseek2(cfg, dtype, seed):
    """A deepseek2 LoadedModel with the loader's keys, dtypes and layer
    segments (the leading dense layer, then the MoE layers), drawn on the
    card: N(0, 0.02) projections, router, experts (one resident copy, (n,
    X, Fe, E) stacks) and the shared experts (one expert of twice the
    width), ones for the norms."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32

    def normal(shape, std=0.02):
        return torch.empty(shape, dtype=dtype, device="cuda").normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=f32, device="cuda")

    E, H, Dk, Dr, R = cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
    Dn, Dv, X, Fe, V = Dk - Dr, cfg.v_head_dim, cfg.n_expert, cfg.n_ff_exp, cfg.n_vocab
    Fs = cfg.n_expert_shared * Fe

    def attention(n):
        return {"attn_norm_w": ones(n, E), "ffn_norm_w": ones(n, E), "kv_a_norm_w": ones(n, R),
                "wq": normal((n, E, H * Dk)), "wkv_a": normal((n, E, R + Dr)),
                "wk_b": normal((n, R, H, Dn)), "wv_b": normal((n, R, H, Dv)),
                "wo": normal((n, H * Dv, E))}

    lead, n_moe = cfg.n_dense_lead, cfg.n_layer - cfg.n_dense_lead
    dense = {**attention(lead), "w_up": normal((lead, E, cfg.n_ff)),
             "w_gate": normal((lead, E, cfg.n_ff)), "w_down": normal((lead, cfg.n_ff, E))}
    moe = {**attention(n_moe), "w_router": normal((n_moe, E, X)),
           "w_up_shexp": normal((n_moe, E, Fs)), "w_gate_shexp": normal((n_moe, E, Fs)),
           "w_down_shexp": normal((n_moe, Fs, E))}
    for name in ("up", "gate", "down"):
        moe[f"w_{name}_exps"] = normal((n_moe, X, Fe, E))
    params = {"tok_embd": normal((V, E)), "output_norm_w": ones(E), "output": normal((E, V)),
              "layers": dense, "layer_segments": [dense, moe]}
    return LoadedModel(config=cfg, params=params)


def decisive_deepseek2(model, seed):
    """The model with a selection-only router bias (router_bias, deepseek's
    exp_probs_b) of MLA_ROUTE_BIAS on k random experts of each MoE layer (a
    new MoE stack dict, every tensor shared): every token takes those k
    experts, weighted by its own softmax, so a last-bit difference in the
    stream moves no token to another expert."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    dense, moe = model.params["layer_segments"]
    n, X = moe["w_router"].shape[0], model.config.n_expert
    bias = torch.zeros((n, X), dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for il in range(n):
        pick = torch.randperm(X, generator=gen, device="cuda")[:model.config.n_expert_used]
        bias[il, pick] = MLA_ROUTE_BIAS
    segs = [dense, {**moe, "router_bias": bias}]
    return LoadedModel(config=model.config,
                       params={**model.params, "layers": segs[0], "layer_segments": segs})


def mla_f32_gate(prompt, steps: int = 8) -> dict:
    """DeepSeek-V2-Lite widths cut to 4 layers (the dense one and 3 MoE), f32:
    the fused mode (v1) against dense mode layer by layer (the dense
    forward feeds each MoE layer's FFN input to the fused FFN too, whose
    output must lie within MLA_GATE_TOL of the dense one's scale at every
    MoE layer of the prompt and `steps` decode steps), and the two
    forwards' greedy tokens equal."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import dense_ffn, make_forward
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.sparse.moe import make_moe_ffn, moe_layout

    t0 = time.perf_counter()
    cfg = deepseek_v2_lite_config(4)
    model = random_deepseek2(cfg, torch.float32, SEED + 61)
    dense, moe = model.params["layer_segments"]
    segs = [dense, moe_layout(moe, cfg)]  # the row stores as views beside the stacks
    params = {**model.params, "layers": segs[0], "layer_segments": segs}
    plain = dense_ffn(cfg)
    moe_dense, fused = make_moe_ffn(cfg, mode="dense"), make_moe_ffn(cfg, mode="pallas")
    errs = []

    def gate(lp, x):
        if "w_router" not in lp:
            return plain(lp, x)
        want = moe_dense(lp, x)
        errs.append(rel_gap(fused(lp, x), want))
        return want

    def kernel(lp, x):
        return fused(lp, x) if "w_router" in lp else plain(lp, x)

    n0 = sf.sparse_ffn_block.launches
    toks = {name: greedy_tokens(make_forward(cfg, ffn_fn=f), params, cfg, prompt, steps)
            for name, f in (("dense", gate), ("pallas", kernel))}
    n_fwd = 3 * (steps + 1)
    check(sf.sparse_ffn_block.launches - n0 == 2 * n_fwd and len(errs) == n_fwd,
          f"5p gate: {sf.sparse_ffn_block.launches - n0} v1 launches, {len(errs)} layers")
    worst = max(errs)
    check(worst <= MLA_GATE_TOL, f"5p gate: a layer's fused FFN is {worst:.3e} of its scale off")
    check(toks["dense"] == toks["pallas"], f"5p gate: greedy tokens differ {toks}")
    row = {"layers": 4, "moe_layers": 3, "steps": steps, "layer_outputs": n_fwd,
           "worst_rel_err": worst, "tol": MLA_GATE_TOL, "tokens": toks["dense"],
           "seconds": time.perf_counter() - t0}
    print("phase 5p, f32 gate (DeepSeek-V2-Lite widths, 4 layers):", json.dumps(row))
    return row


def mla_cache_rows(model, greedy, prompt) -> list:
    """Engine(moe_mode="pallas") at max_seq 2048 and 32768: the latent
    cache's bytes against those a per-head K/V cache of the same model
    would take (n_head heads of k (qk_nope + qk_rope) and v (v_head) a
    layer, in the cache's dtype), and the device ms of a decode step (one
    replay's span) after 16 greedy tokens; MLA reads every slot of the
    cache, masked or not, so the step grows with max_seq."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    cfg, out = model.config, []
    for max_seq in (2048, 32768):
        eng = Engine(model, max_seq=max_seq, sampler=greedy, device="cuda", moe_mode="pallas")
        toks = run_generate(eng, prompt, 16)
        cache = eng.cache
        check(cache.k.shape[-2:] == (1, cfg.kv_lora_rank + cfg.rope_dim)
              and cache.v.shape[-1] == 0, f"5p: cache shapes {cache.k.shape} {cache.v.shape}")
        per_head = (cfg.n_layer * max_seq * cfg.n_head * (cfg.head_dim + cfg.v_head_dim)
                    * cache.k.element_size())
        step = eng.graphs.get(cache, 1, "decode", None)
        row = {"max_seq": max_seq, "kv_bytes": kv_bytes(cache), "per_head_kv_bytes": per_head,
               "bytes_per_token": kv_bytes(cache) // max_seq, "tok_s": eng.perf.decode_tps,
               **replay_times(step), "tokens_first8": toks[:8]}
        print("phase 5p, latent cache:", json.dumps(row))
        out.append(row)
        del eng, step, cache
        torch.cuda.empty_cache()
    return out


def phase_mla(greedy, L: int = 27) -> dict:
    """Phase 5p: the f32 gate, then DeepSeek-V2-Lite at full width and depth
    L (27; the full run's child takes FULL_RUN_MLA_L) in bf16: v1 at its
    shape against the plain version, the pallas and the
    dense Engines (graph against eager, bit-equal), the latent cache at
    max_seq 2048 and 32768, and the 4-slot Scheduler. Returns its summary,
    with v1's main-path launches."""
    import gc

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5p: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 60)
    prompt = torch.randint(102400, (32,), generator=gen).tolist()
    gate = mla_f32_gate(prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5p, f32 gate")
    cfg = deepseek_v2_lite_config(L)
    t1 = time.perf_counter()
    model = random_deepseek2(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    segs = model.params["layer_segments"]
    weights = sum(t.numel() for t in [model.params["tok_embd"], model.params["output"],
                                      *segs[0].values(), *segs[1].values()])
    print(f"model: DeepSeek-V2-Lite widths, L={cfg.n_layer} (1 dense + {cfg.n_layer - 1} MoE) "
          f"E={cfg.n_embd} H={cfg.n_head} R={cfg.kv_lora_rank} Dr={cfg.rope_dim} "
          f"Dk={cfg.head_dim} Dv={cfg.v_head_dim} X={cfg.n_expert} k={cfg.n_expert_used} "
          f"Fe={cfg.n_ff_exp} shared={cfg.n_expert_shared} V={cfg.n_vocab}, bf16, {weights} "
          f"weights built in {time.perf_counter() - t1:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    v1_rows = moe_v1_rows(LoadedModel(config=cfg, params={"layers": segs[1]}),
                          path="DeepSeek-V2-Lite", Ns=(1, 32))
    mark("phase 5p, v1 at the DeepSeek-V2-Lite shape")
    engines = [moe_engine(f"DeepSeek-V2-Lite bf16 {mode}", model, greedy, prompt, 128, mode,
                          phase="5p", eager_stream=True, max_seq=2048)
               for mode in ("pallas", "dense")]
    ratio = engines[0]["tok_s"] / engines[1]["tok_s"]
    print("phase 5p, fused against dense decode:", json.dumps(
        {"pallas_tok_s": engines[0]["tok_s"], "dense_tok_s": engines[1]["tok_s"],
         "ratio": ratio}))
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5p, engines")
    cache_rows = mla_cache_rows(model, greedy, prompt)
    sched = swa_scheduler(decisive_deepseek2(model, SEED + 62), greedy, n_new=64, phase="5p",
                          label="DeepSeek-V2-Lite Scheduler, dense MoE, latent cache")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5p, DeepSeek-V2-Lite")
    return {"f32_gate": gate, "v1_deepseek_v2_lite": v1_rows, "engines": engines,
            "pallas_over_dense": ratio, "latent_cache": cache_rows, "scheduler": sched,
            "v1_launches": sum(r["launches"] for r in engines), "weights": weights,
            "seconds": time.perf_counter() - t0}


def mla_summary(mla) -> dict:
    """Phase 5p's numbers in brief, for the end of the full run's output."""
    keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "v1_share_of_device",
            "replay_span_ms", "prefill_ms", "peak_gib", "launches")
    return {"f32_gate_worst": mla["f32_gate"]["worst_rel_err"],
            "v1_deepseek_v2_lite": [{k: r[k] for k in ("N", "ms", "bound_ms", "plain_ms",
                                                       "x_bound", "max_abs_err")}
                                    for r in mla["v1_deepseek_v2_lite"]],
            "engines": [{"path": r["path"], **{k: r[k] for k in keys}} for r in mla["engines"]],
            "pallas_over_dense": mla["pallas_over_dense"],
            "latent_cache": [{k: r[k] for k in ("max_seq", "kv_bytes", "per_head_kv_bytes",
                                                "replay_span_ms", "tok_s")}
                             for r in mla["latent_cache"]],
            "scheduler": {k: mla["scheduler"][k] for k in (
                "decode_tok_s", "ms_per_tick", "peak_gib", "streams_equal", "parted_at")},
            "weights": mla["weights"], "seconds": mla["seconds"]}


# --- phase 5q: the llama-shaped and MoE archs at full width ------------------

ARCH_GATE_TOL = 1e-4  # f32: a packed product, or a fused MoE FFN, of its plain counterpart's scale
ARCH_TIE_TOL = 1e-2  # f32 greedy streams may part only where the top two logits lie this close


def qwen3_8b_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen3", n_layer=L, n_embd=4096, n_head=32, n_head_kv=8,
                       head_dim=128, n_ff=12288, n_vocab=151936, norm_eps=1e-6,
                       rope_freq_base=1e6, n_ctx_train=40960)


def qwen15_moe_config(L):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="qwen2moe", n_layer=L, n_embd=2048, n_head=16, n_head_kv=16,
                       head_dim=128, n_ff=5632, n_ff_exp=1408, n_vocab=151936, n_expert=60,
                       n_expert_used=4, n_expert_shared=1, norm_topk_prob=False,
                       norm_eps=1e-6, rope_freq_base=1e6, n_ctx_train=8192)


def q8_qwen3(cfg, dtype, seed):
    """Qwen3 as its Q8_0 GGUF loads with keep_quantized: Q8_0 wq, wk, wv, wo,
    up, gate, down and head (Q8Weights' draws, packed as the loader packs
    them), the embeddings in `dtype`, per-head q/k RMS norms 1 + N(0, 0.1)
    and ones for the block norms, in f32."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    w = Q8Weights(cfg, dtype, "cuda", seed)
    L, E, V, D = cfg.n_layer, cfg.n_embd, cfg.n_vocab, cfg.head_dim
    HD, KD = cfg.n_head * D, cfg.n_head_kv * D
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    f32 = dict(dtype=torch.float32, device="cuda")
    layers = {"attn_norm_w": torch.ones((L, E), **f32), "ffn_norm_w": torch.ones((L, E), **f32),
              "wq": w.packed_stack("wq", HD, E), "wk": w.packed_stack("wk", KD, E),
              "wv": w.packed_stack("wv", KD, E), "wo": w.packed_stack("wo", E, HD),
              "attn_q_norm_w": torch.randn((L, D), generator=gen, **f32).mul_(0.1).add_(1.0),
              "attn_k_norm_w": torch.randn((L, D), generator=gen, **f32).mul_(0.1).add_(1.0),
              **w.dense_ffn()}
    q, s = w.pack(w.draw("output", 0, (V, E)))
    params = {"tok_embd": w.draw("tok_embd", 0, (V, E)), "output_norm_w": torch.ones((E,), **f32),
              "output": QuantTensor(q.contiguous(), s.contiguous(), "q8_0"), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def random_qwen2moe(cfg, dtype, seed):
    """Qwen1.5-MoE with the loader's keys, drawn on the card: N(0, 0.02)
    projections, router, experts (the port's (L, X, Fe, E) stacks), shared
    expert and its gate (ffn_gate_inp_shexp); q/k/v biases N(0, 0.1) and
    ones for the norms in f32."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, std=0.02, dt=dtype):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(0.0, std, generator=gen)

    L, E, H, Hkv, D = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim
    X, Fe, Fs, V, f32 = cfg.n_expert, cfg.n_ff_exp, cfg.n_ff, cfg.n_vocab, torch.float32
    ones = dict(dtype=f32, device="cuda")
    layers = {"attn_norm_w": torch.ones((L, E), **ones), "ffn_norm_w": torch.ones((L, E), **ones),
              "wq": normal((L, E, H * D)), "wk": normal((L, E, Hkv * D)),
              "wv": normal((L, E, Hkv * D)), "wo": normal((L, H * D, E)),
              "bq": normal((L, H * D), 0.1, f32), "bk": normal((L, Hkv * D), 0.1, f32),
              "bv": normal((L, Hkv * D), 0.1, f32), "w_router": normal((L, E, X)),
              "w_up_shexp": normal((L, E, Fs)), "w_gate_shexp": normal((L, E, Fs)),
              "w_down_shexp": normal((L, Fs, E)), "w_gate_inp_shexp": normal((L, E))}
    for name in ("up", "gate", "down"):
        layers[f"w_{name}_exps"] = normal((L, X, Fe, E))
    params = {"tok_embd": normal((V, E)), "output_norm_w": torch.ones((E,), **ones),
              "output": normal((E, V)), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def random_cut(cfg, seed, extra):
    """A 4-layer cut drawn on the card in bf16 with the loader's keys: N(0,
    0.02) projections and FFN, 1 + N(0, 0.1) norms (biases N(0, 0.1)) in f32,
    and `extra(normal)`'s tensors."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, std=0.02, dt=torch.bfloat16, mean=0.0):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(mean, std, generator=gen)

    L, E, H, Hkv, D, F, V = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim,
                             cfg.n_ff, cfg.n_vocab)
    f32 = torch.float32
    layers = {"attn_norm_w": normal((L, E), 0.1, f32, 1.0),
              "ffn_norm_w": normal((L, E), 0.1, f32, 1.0),
              "wq": normal((L, E, H * D)), "wk": normal((L, E, Hkv * D)),
              "wv": normal((L, E, Hkv * D)), "wo": normal((L, H * D, E)),
              "w_up": normal((L, E, F)), "w_gate": normal((L, E, F)), "w_down": normal((L, F, E)),
              **extra(normal)}
    params = {"tok_embd": normal((V, E)), "output_norm_w": normal((E,), 0.1, f32, 1.0),
              "output": normal((E, V)), "layers": layers}
    if cfg.traits.norm == "ln":
        params["output_norm_b"] = normal((E,), 0.1, f32)
    return LoadedModel(config=cfg, params=params)


def parted_at_a_tie(label, toks, ref_toks, ref_logits) -> dict:
    """Two greedy streams, equal or parted where the reference's top two
    logits lie within ARCH_TIE_TOL of its scale; fails otherwise."""
    import torch

    part = next((i for i, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), None)
    gap = None
    if part is not None:
        top2 = torch.topk(ref_logits[part].float(), 2).values
        gap = ((top2[0] - top2[1]) / ref_logits[part].float().abs().max()).item()
        check(gap <= ARCH_TIE_TOL, f"5q {label}: the streams part at step {part}, where the "
                                   f"top two logits are {gap:.3e} of the scale apart")
    return {"parted_at": part, "parted_gap": gap}


def packed_per_forward(model) -> int:
    """The packed (QuantTensor) products of one forward: each layer's packed
    projections and a packed head, one quant_matmul_2d call each."""
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    p = model.params
    per_layer = sum(isinstance(t, QuantTensor) for t in p["layers"].values())
    return per_layer * model.config.n_layer + isinstance(p["output"], QuantTensor)


def q8_f32_gate(label, phase, model, prompt, steps: int = 8) -> dict:
    """An f32 Q8_0 model (a cut of a few layers): the plain path (every
    packed product through quant_matmul_2d_plain, on the card) decodes
    `steps` greedy tokens and feeds each product's input to the kernel too
    (qmm_prefill at N = 32, qmm_decode at N = 1), whose output must lie
    within ARCH_GATE_TOL of the plain one's scale; then the kernel path's
    own greedy stream, equal to the plain path's or parted at a near-tie
    (the products round their inputs to bf16, so a last-bit difference of
    the f32 stream can move a rounding and cascade)."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    t0 = time.perf_counter()
    cfg = model.config
    kernel, plain = qm.quant_matmul_2d, qm.quant_matmul_2d_plain
    errs = []

    def gate(x, qw, scales, *, kind):
        want = plain(x, qw, scales, kind=kind)
        errs.append(rel_gap(kernel(x, qw, scales, kind=kind), want))
        return want

    def run():
        cache = init_cache(cfg, 1, len(prompt) + steps + 1, torch.float32, "cuda")
        fwd, toks, rows = make_forward(cfg), [], []
        with torch.inference_mode():
            logits = fwd(model.params, torch.tensor([prompt], device="cuda"),
                         torch.arange(len(prompt), device="cuda")[None], cache)
            for i in range(steps + 1):
                check(bool(torch.isfinite(logits).all()), f"{phase} gate: non-finite logits")
                rows.append(logits[0, -1].clone())
                toks.append(int(logits[0, -1].argmax()))
                if i < steps:
                    logits = fwd(model.params, torch.tensor([[toks[-1]]], device="cuda"),
                                 torch.tensor([[len(prompt) + i]], device="cuda"), cache)
        return toks, rows

    # the kernel counts its launches on the module's quant_matmul_2d: the
    # gate's own counter while the gate stands in for it
    gate.launches = 0
    qm.quant_matmul_2d = gate
    try:
        plain_toks, plain_rows = run()
    finally:
        qm.quant_matmul_2d = kernel
    n0 = kernel.launches
    kernel_toks, kernel_rows = run()
    n = packed_per_forward(model) * (steps + 1)
    check(gate.launches == n and kernel.launches - n0 == n and len(errs) == n,
          f"{phase} gate: {gate.launches} and {kernel.launches - n0} quant_matmul_2d launches, "
          f"{len(errs)} products, want {n} each")
    worst = max(errs)
    check(worst <= ARCH_GATE_TOL, f"{phase} gate: a packed product is {worst:.3e} of its "
                                  f"scale off")
    row = {"layers": cfg.n_layer, "steps": steps, "products": len(errs), "worst_rel_err": worst,
           "tol": ARCH_GATE_TOL, "first_logits_rel_gap": rel_gap(kernel_rows[0], plain_rows[0]),
           **parted_at_a_tie(f"{label} gate", kernel_toks, plain_toks, plain_rows),
           "tokens": plain_toks, "seconds": time.perf_counter() - t0}
    print(f"phase {phase}, f32 gate ({label}):", json.dumps(row))
    return row


def qwen3_f32_gate(prompt, steps: int = 8) -> dict:
    """Qwen3-8B widths cut to 4 layers, f32, Q8_0: q8_f32_gate."""
    import torch

    model = q8_qwen3(qwen3_8b_config(4), torch.float32, SEED + 71)
    return q8_f32_gate("Qwen3-8B widths, 4 layers, Q8_0", "5q", model, prompt, steps)


def q8_qmm_rows(model, keys, seed, per_call: int, Ns=(1, 32)) -> list:
    """quant_matmul_2d against its plain version at the shapes of the
    model's packed stacks `keys` ("head": its packed head), at each N of Ns
    (1: qmm_decode; 32, 512: qmm_prefill), over the model's own stores (every
    layer's, so the L2 stays cold). per_call: the kernels one call launches
    at these shapes, which the profiled decode step and prefill count (one
    a product)."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    lay, head = model.params["layers"], model.params["output"]
    stores = {k: ([(head.q, head.s)] if k == "head" else
                  [(lay[k].q[il], lay[k].s[il]) for il in range(lay[k].q.shape[0])])
              for k in keys}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for k, st in stores.items():
        IN, OUT = st[0][0].shape
        for N in Ns:
            x = torch.randn((N, IN), generator=gen, device="cuda").to(torch.bfloat16)
            row = qmm_row(f"quant_matmul_2d q8_0 {k} {IN}x{OUT} N={N}", qm.quant_matmul_2d,
                          qm.quant_matmul_2d_plain, st, x, "q8_0", per_call)
            rows.append({**row, "matrix": k, "N": N})
    return rows


def q8_step_bound(model, positions: float) -> dict:
    """The least a Q8_0 decode step must move: every packed weight once
    (int8 values and f32 scales), the layers' other tensors (norms, MLA's
    bf16 key and value decompressors) once, one embedding row, and the K/V
    cache (MLA's latent cache) over `positions` slots, read at the card's
    memory rate."""
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    cfg, p = model.config, model.params
    tensors = [*p["layers"].values(), p["output"]]
    packed = [t for t in tensors if isinstance(t, QuantTensor)]
    w_bytes = sum(t.q.numel() * t.q.element_size() + t.s.numel() * t.s.element_size()
                  for t in packed)
    other = sum(t.numel() * t.element_size() for t in tensors if not isinstance(t, QuantTensor))
    if cfg.kv_lora_rank:
        kv = cfg.n_layer * (cfg.kv_lora_rank + cfg.rope_dim) * positions * 2
    else:
        kv = 2 * cfg.n_layer * cfg.n_head_kv * cfg.head_dim * positions * 2
    nbytes = w_bytes + other + kv + cfg.n_embd * 2
    return {"weight_bytes": w_bytes, "other_weight_bytes": other, "kv_bytes": kv,
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_S * 1e3}


def q8_dense_engine(label, phase, model, greedy, prompt, n_new, max_seq=1024) -> dict:
    """The dense Engine of a Q8_0 model (packed_per_forward quant_matmul_2d
    calls a forward) on its main path, its graph decode against an eager
    engine (graph_vs_eager: streams equal, first decode logits bit-equal)
    with its timings, the profiled decode steps (qmm_decode only, one a
    product) and 32-token prefill (qmm_prefill only), and the step's bound."""
    from sparkinfer_tpu_torch.runtime.engine import Engine

    per_fwd = packed_per_forward(model)
    bound = q8_step_bound(model, len(prompt) + n_new / 2)
    kw = dict(max_seq=max_seq, sampler=greedy, device="cuda")
    eng = Engine(model, **kw)
    launches = main_path(label, eng, prompt, n_new,
                         lambda runs: {"quant_matmul_2d": per_fwd * (runs + 1)})
    h = graph_vs_eager(label, eng, Engine(model, cuda_graph=False, **kw), prompt, n_new)
    prof, steps = PROFILES[label]
    qmm = [(k, ms, n) for k, ms, n in prof if "qmm_" in k]
    check(sum(n for _, _, n in qmm) == per_fwd * steps
          and all("qmm_decode" in k for k, _, _ in qmm),
          f"{phase} {label}: the profiled steps launched {qmm}, want {per_fwd} qmm_decode a step")
    pre = profile_prefill(eng, prompt)
    check(pre["qmm_launches"] == per_fwd and all("qmm_prefill" in k for k in pre["qmm_kernels"]),
          f"{phase} {label}: the profiled prefill launched {pre['qmm_kernels']}, want {per_fwd} "
          f"qmm_prefill")
    return {"path": label, "launches": launches["quant_matmul_2d"], **h["graph"],
            "eager": h["eager"], **{k: h[k] for k in (
                "replay_span_ms", "replay_launch_ms", "replay_sync_ms", "step_breakdown",
                "capture_s", "graph_pool_bytes", "wall_speedup")},
            "qmm_decode_per_step": sum(n for _, _, n in qmm) // steps,
            "qmm_device_ms_per_step": sum(ms for _, ms, _ in qmm) / steps,
            "qmm_prefill_per_prefill": pre["qmm_launches"], "prefill": pre,
            "step_bound": bound, "x_bound": h["replay_span_ms"] / bound["bound_ms"],
            "peak_gib": PEAKS[label]}


def qwen3_phase(greedy, prompt, n_new: int = 128, L: int = 36) -> dict:
    """Qwen3-8B at full width and depth L (36; the full run's child takes
    FULL_RUN_ARCHS_QWEN3_L) in Q8_0: q8_dense_engine (quant_matmul_2d 7L + 1
    times a forward: the L q, k, v, o, up, gate and down products and the
    head); then the packed linears at its shapes."""
    import torch

    cfg = qwen3_8b_config(L)
    t0 = time.perf_counter()
    model = q8_qwen3(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    print(f"model: Qwen3-8B widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"Hkv={cfg.n_head_kv} D={cfg.head_dim} F={cfg.n_ff} V={cfg.n_vocab}, Q8_0 "
          f"attention/FFN/head ({q8_step_bound(model, 0)['weight_bytes']} bytes packed), built "
          f"in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated")
    row = q8_dense_engine("Qwen3-8B Q8_0 dense", "5q", model, greedy, prompt, n_new)
    # one kernel a product at every shape: the profiles counted exactly one
    # qmm_decode (a step) and one qmm_prefill (a prefill) for each of them
    rows = q8_qmm_rows(model, ("wq", "wk", "w_up", "w_down", "head"), SEED + 72, per_call=1)
    mark("phase 5q, quant_matmul_2d at the Qwen3-8B shapes")
    print("phase 5q, Qwen3-8B (graph decode; streams equal, first decode logits bit-equal):",
          json.dumps(row))
    return {"rows": rows, "engine": row}


def qwen15_f32_gate(prompt, steps: int = 8) -> dict:
    """Qwen1.5-MoE-A2.7B widths cut to 4 layers, f32: the dense-mode forward
    feeds each layer's FFN input to the fused FFN (v1) too, whose output
    must lie within ARCH_GATE_TOL of the dense one's scale at every layer of
    the prompt and `steps` decode steps; the two modes' greedy tokens equal."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.sparse.moe import make_moe_ffn, moe_layout

    t0 = time.perf_counter()
    cfg = qwen15_moe_config(4)
    model = random_qwen2moe(cfg, torch.float32, SEED + 73)
    params = {**model.params, "layers": moe_layout(model.params["layers"], cfg)}
    dense, fused = make_moe_ffn(cfg, mode="dense"), make_moe_ffn(cfg, mode="pallas")
    errs = []

    def gate(lp, x):
        want = dense(lp, x)
        errs.append(rel_gap(fused(lp, x), want))
        return want

    n0 = sf.sparse_ffn_block.launches
    toks = {name: greedy_tokens(make_forward(cfg, ffn_fn=f), params, cfg, prompt, steps)
            for name, f in (("dense", gate), ("pallas", fused))}
    n_fwd = 4 * (steps + 1)
    check(sf.sparse_ffn_block.launches - n0 == 2 * n_fwd and len(errs) == n_fwd,
          f"5q gate: {sf.sparse_ffn_block.launches - n0} v1 launches, {len(errs)} layers")
    worst = max(errs)
    check(worst <= ARCH_GATE_TOL, f"5q gate: a layer's fused FFN is {worst:.3e} of its scale off")
    check(toks["dense"] == toks["pallas"], f"5q gate: greedy tokens differ {toks}")
    row = {"layers": 4, "steps": steps, "layer_outputs": n_fwd, "worst_rel_err": worst,
           "tol": ARCH_GATE_TOL, "tokens": toks["dense"], "seconds": time.perf_counter() - t0}
    print("phase 5q, f32 gate (Qwen1.5-MoE-A2.7B widths, 4 layers):", json.dumps(row))
    return row


def qwen15_phase(greedy, prompt, n_new: int = 128, L: int = 24) -> dict:
    """Qwen1.5-MoE-A2.7B at full width and depth L (24; the full run's
    child takes FULL_RUN_ARCHS_MOE_L) in bf16: v1 at its shape, then the
    fused and the dense Engines, each a graph against an eager engine
    (streams equal, first decode logits bit-equal)."""
    import gc

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    cfg = qwen15_moe_config(L)
    t0 = time.perf_counter()
    model = random_qwen2moe(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    weights = sum(t.numel() for t in [model.params["tok_embd"], model.params["output"],
                                      *model.params["layers"].values()])
    print(f"model: Qwen1.5-MoE-A2.7B widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"X={cfg.n_expert} k={cfg.n_expert_used} Fe={cfg.n_ff_exp} shared={cfg.n_ff} "
          f"V={cfg.n_vocab}, bf16, {weights} weights built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    v1_rows = moe_v1_rows(LoadedModel(config=cfg, params={"layers": model.params["layers"]}),
                          path="Qwen1.5-MoE-A2.7B", Ns=(1, 32))
    mark("phase 5q, v1 at the Qwen1.5-MoE-A2.7B shape")
    engines = [moe_engine(f"Qwen1.5-MoE-A2.7B bf16 {mode}", model, greedy, prompt, n_new, mode,
                          phase="5q", eager_stream=True)
               for mode in ("pallas", "dense")]
    ratio = engines[0]["tok_s"] / engines[1]["tok_s"]
    print("phase 5q, fused against dense decode:", json.dumps(
        {"pallas_tok_s": engines[0]["tok_s"], "dense_tok_s": engines[1]["tok_s"], "ratio": ratio}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"v1_rows": v1_rows, "engines": engines, "pallas_over_dense": ratio,
            "weights": weights, "v1_launches": engines[0]["launches"]}


def attention_order_cuts(greedy) -> list:
    """4-layer cuts at small widths, bf16, for the two new attention orders,
    each decode graph against an eager engine (streams equal, first decode
    logits bit-equal): hunyuan-dense (per-head q/k RMS norms after rope) and
    stablelm (LayerNorm blocks with biases, qkv biases, partial rope over 16
    of 64 lanes, per-head q/k LayerNorms with an (H, D) affine and biases)."""
    import dataclasses

    import torch

    from sparkinfer_tpu_torch.models.config import ModelConfig
    from sparkinfer_tpu_torch.runtime.engine import Engine

    f32 = torch.float32
    cuts = {
        "hunyuan-dense": (ModelConfig(arch="hunyuan-dense", n_layer=4, n_embd=2048, n_head=16,
                                      n_head_kv=4, head_dim=128, n_ff=6144, n_vocab=32000,
                                      norm_eps=1e-5, rope_freq_base=1e4),
                          lambda normal: {"attn_q_norm_w": normal((4, 128), 0.1, f32, 1.0),
                                          "attn_k_norm_w": normal((4, 128), 0.1, f32, 1.0)}),
        "stablelm": (ModelConfig(arch="stablelm", n_layer=4, n_embd=2048, n_head=32, n_head_kv=8,
                                 head_dim=64, rope_dim=16, n_ff=5632, n_vocab=32000,
                                 norm_eps=1e-5, rope_freq_base=1e4),
                     lambda normal: {"attn_norm_b": normal((4, 2048), 0.1, f32),
                                     "ffn_norm_b": normal((4, 2048), 0.1, f32),
                                     "bq": normal((4, 2048), 0.1, f32),
                                     "bk": normal((4, 512), 0.1, f32),
                                     "bv": normal((4, 512), 0.1, f32),
                                     "attn_q_norm_w": normal((4, 32, 64), 0.1, f32, 1.0),
                                     "attn_q_norm_b": normal((4, 32, 64), 0.1, f32),
                                     "attn_k_norm_w": normal((4, 8, 64), 0.1, f32, 1.0),
                                     "attn_k_norm_b": normal((4, 8, 64), 0.1, f32)}),
    }
    gen = torch.Generator().manual_seed(SEED + 74)
    prompt = torch.randint(32000, (32,), generator=gen).tolist()
    out = []
    for i, (name, (cfg, extra)) in enumerate(cuts.items()):
        model = random_cut(cfg, SEED + 75 + i, extra)
        kw = dict(max_seq=1024, sampler=greedy, device="cuda")
        row = graph_vs_eager(f"{name} cut bf16", Engine(model, **kw),
                             Engine(model, cuda_graph=False, **kw), prompt, 64)
        out.append({"arch": name, **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
                    "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]})
        del model
        torch.cuda.empty_cache()
    return out


def phase_archs(greedy, qwen3_L: int = 36, moe_L: int = 24) -> dict:
    """Phase 5q: Qwen3-8B in Q8_0 and Qwen1.5-MoE-A2.7B in bf16 at full width
    and depth (the full run's child cuts both: FULL_RUN_ARCHS_*), their f32
    gates at 4 layers, and the attention-order cuts. Returns its summary,
    with the main paths' launches."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5q: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 70)
    prompt = torch.randint(151936, (32,), generator=gen).tolist()
    gates = {"qwen3_8b": qwen3_f32_gate(prompt)}
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5q, Qwen3-8B f32 gate")
    qwen3 = qwen3_phase(greedy, prompt, L=qwen3_L)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5q, Qwen3-8B")
    gates["qwen15_moe"] = qwen15_f32_gate(prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5q, Qwen1.5-MoE-A2.7B f32 gate")
    moe = qwen15_phase(greedy, prompt, L=moe_L)
    mark("phase 5q, Qwen1.5-MoE-A2.7B")
    cuts = attention_order_cuts(greedy)
    mark("phase 5q, attention-order cuts")
    return {"f32_gates": gates, "qwen3_8b": qwen3, "qwen15_moe": moe, "cuts": cuts,
            "qmm_launches": qwen3["engine"]["launches"], "v1_launches": moe["v1_launches"],
            "seconds": time.perf_counter() - t0}


def archs_summary(a) -> dict:
    """Phase 5q's numbers in brief, for the end of the full run's output."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    moe_keys = ("tok_s", "wall_ms_per_step", "device_ms_per_step", "v1_share_of_device",
                "replay_span_ms", "prefill_ms", "peak_gib", "launches")
    q = a["qwen3_8b"]["engine"]
    return {"f32_gates": {k: g["worst_rel_err"] for k, g in a["f32_gates"].items()},
            "qwen3_8b_qmm": [{"shape": r["shape"], **{k: r[k] for k in keys}}
                             for r in a["qwen3_8b"]["rows"]],
            "qwen3_8b": {"bound_ms": q["step_bound"]["bound_ms"], **{k: q[k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "replay_span_ms",
                "qmm_decode_per_step", "qmm_prefill_per_prefill", "x_bound", "peak_gib",
                "launches")}},
            "qwen15_v1": [{"N": r["N"], **{k: r[k] for k in keys}}
                          for r in a["qwen15_moe"]["v1_rows"]],
            "qwen15_engines": [{"path": r["path"], **{k: r[k] for k in moe_keys}}
                               for r in a["qwen15_moe"]["engines"]],
            "qwen15_pallas_over_dense": a["qwen15_moe"]["pallas_over_dense"],
            "cuts": a["cuts"], "seconds": a["seconds"]}


# --- phase 5r: the int8 and split-dtype KV caches over the 7B sparse path ----

KVQ_TOL = 1e-4  # f32: the kernel path's first decode logits against the plain path's, of their scale


def kvq_f32_gate(greedy, prompt, steps: int = 16) -> dict:
    """ProSparse-Llama-2-7B widths cut to 2 layers, f32, each Engine over an
    int8 cache: the v6 kernel path against the plain "gather" path on the
    card: first decode logits within KVQ_TOL of their scale, greedy streams
    equal, and layer 0's int8 codes and scales bit-equal in the two caches
    (its K and V come before any FFN; a later layer's may differ at a
    rounding midpoint)."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    t0 = time.perf_counter()
    cfg, scfg = prosparse_config(2, 4096, 32, 11008, 32000, 1024), SparseConfig(128, 12)
    model = random_model(cfg, torch.float32, "cuda", SEED + 91)
    outs, caches = [], []
    for mode in ("kernel", "gather"):
        eng = Engine(model, max_seq=64, sampler=greedy, kv_dtype=torch.float32,
                     kv_quantized=True, sparse=scfg, sparse_decode_mode=mode, device="cuda")
        outs.append(first_decode_and_tokens(eng, prompt, steps))
        caches.append(eng.cache)
        del eng
    check_pair("5r, int8 KV, 7B widths 2 layers, card kernel vs card gather", outs)
    n = len(prompt) + steps - 1
    layer0 = all(torch.equal(a[0, :, :n], b[0, :, :n]) for a, b in zip(*caches))
    check(caches[0].quantized and layer0, "5r gate: layer 0's int8 codes or scales differ")
    later = [int((a[1:, :, :n] != b[1:, :, :n]).sum()) for a, b in zip(*caches)]
    row = {"layers": 2, "steps": steps, "first_logits_rel_gap": rel_gap(outs[0][0], outs[1][0]),
           "tol": KVQ_TOL, "tokens": outs[0][1], "layer0_bit_equal": layer0,
           "layer1_differing_k_v_kscale_vscale": later, "seconds": time.perf_counter() - t0}
    print("phase 5r, f32 gate (int8 KV, 7B widths, 2 layers):", json.dumps(row))
    del model, caches
    torch.cuda.empty_cache()
    return row


def kvq_engine(pre, scfg, greedy, prompt, n_new, ref_label) -> dict:
    """The 7B bf16 sparse Engine (v6) over an int8 cache, on the prepared
    stores `pre` of the bf16-cache engine `ref_label`: its main path (v6 L
    times a step), its graph against an eager engine (streams equal, first
    decode logits bit-equal) with v6's launches a profiled step, its first
    decode logits and stream against the bf16 cache's, and the dense
    engines' first decode logits over the two caches."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    label, L = "7B bf16 sparse int8 KV", pre.config.n_layer
    kw = dict(max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
              kv_quantized=True, device="cuda")
    eng = Engine(pre, **kw)
    launches = main_path(label, eng, prompt, n_new,
                         lambda steps: {"sparse_ffn_block_v6": L * steps})
    h = graph_vs_eager(label, eng, Engine(pre, cuda_graph=False, **kw), prompt, n_new)
    rows, steps = PROFILES[label]
    v6 = sum(n for k, _, n in rows if "v6_ffn" in k) // steps
    check(v6 == L, f"5r: the profiled int8 step launched {v6} v6 kernels, want {L}")
    check(eng.cache.quantized and eng.cache.k.dtype == torch.int8, "5r: not an int8 cache")
    bf16 = Engine(pre, **{**kw, "kv_quantized": False})
    gap = rel_gap(first_logits(eng, prompt)[1], first_logits(bf16, prompt)[1])
    # the dense engines over the same weights: no predictor group to flip
    dense = [first_logits(Engine(pre, max_seq=1024, sampler=greedy, kv_quantized=q,
                                 device="cuda"), prompt)[1] for q in (True, False)]
    ref = STREAMS[ref_label]
    part = next((i for i, (a, b) in enumerate(zip(STREAMS[label], ref)) if a != b), None)
    row = {"path": label, "launches": launches["sparse_ffn_block_v6"], "v6_per_step": v6,
           **h["graph"], "eager": h["eager"], **{k: h[k] for k in (
               "replay_span_ms", "replay_launch_ms", "replay_sync_ms", "capture_s",
               "wall_speedup")},
           "first_logits_rel_gap_vs_bf16_cache": gap, "streams_part_at_vs_bf16_cache": part,
           "dense_first_logits_rel_gap_vs_bf16_cache": rel_gap(*dense),
           "peak_gib": PEAKS[label]}
    print("phase 5r, 7B int8 KV engine (graph decode; streams equal, first decode logits "
          "bit-equal):", json.dumps(row))
    return row


def kvq_long_context(pre, scfg, greedy, prompt) -> list:
    """The 7B sparse Engine over bf16 and int8 caches at max_seq 2048 and
    32768: the caches' bytes (the int8 cache exactly (D + 4) / (2 D) of the
    bf16 one's, 132/256 at D = 128; at 4096 slots too), and the device ms of
    a decode step (one replay's span) after 16 greedy tokens. Attention
    reads every slot, and the int8 cache dequantizes every slot a step in
    plain torch, so its step grows faster with max_seq."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    cfg, out = pre.config, []
    D = cfg.head_dim
    meta = [kv_bytes(init_cache(cfg, 1, 4096, torch.bfloat16, "meta", quantized=q))
            for q in (True, False)]
    check(meta[0] * 2 * D == meta[1] * (D + 4), f"5r: 4096-slot caches of {meta} bytes")
    for max_seq in (2048, 32768):
        pair = {}
        for quant in (False, True):
            eng = Engine(pre, max_seq=max_seq, sampler=greedy, sparse=scfg,
                         sparse_preprepared=True, kv_quantized=quant, device="cuda")
            toks = run_generate(eng, prompt, 16)
            step = eng.graphs.get(eng.cache, 1, "decode", None)
            pair[quant] = row = {"max_seq": max_seq, "kv": "int8" if quant else "bf16",
                                 "kv_bytes": kv_bytes(eng.cache),
                                 "bytes_per_token": kv_bytes(eng.cache) // max_seq,
                                 "tok_s": eng.perf.decode_tps, **replay_times(step),
                                 "tokens_first8": toks[:8]}
            print("phase 5r, long context:", json.dumps(row))
            out.append(row)
            del eng, step
            torch.cuda.empty_cache()
        check(pair[True]["kv_bytes"] * 2 * D == pair[False]["kv_bytes"] * (D + 4),
              f"5r: int8 {pair[True]['kv_bytes']} against bf16 {pair[False]['kv_bytes']} bytes")
    return out


def shift_slots(sched, keep: int, discard: int):
    """A context shift of every slot of the Scheduler's cache, between
    ticks (the running slots share one n_past): rows [keep, keep + discard)
    dropped, the rest slid down and re-roped; the running slots' n_past and
    token histories moved with them."""
    from sparkinfer_tpu_torch.models.transformer import rope_params
    from sparkinfer_tpu_torch.runtime.kv_cache import shift_cache

    n_past = {s.n_past for s in sched.slots if s.running}
    check(len(n_past) == 1, f"5r: the running slots stand at {n_past}")
    shift_cache(sched.cache, rope_params(sched.cfg), keep, discard, n_past.pop())
    for s in sched.slots:
        if s.running:
            s.n_past -= discard
            s.cached_tokens = s.cached_tokens[:keep] + s.cached_tokens[keep + discard:]


def running_logits(sched):
    """The last tick's logits of the running slots (an idle slot steps over
    whatever rows earlier requests left in it, which differ between two
    Schedulers with other histories)."""
    return sched.last_logits[[i for i, s in enumerate(sched.slots) if s.running]].clone()


def kvq_rewrites(graph_sched, eager_sched, prompts, tmp) -> dict:
    """Cache rewrites between ticks over the int8 cache, on a graph and an
    eager Scheduler alike: 4 requests, a context shift of every slot after
    24 ticks (keep 4, drop 32), then a slot saved, its rows zeroed and the
    file restored into another slot, whose prefix a continuation reuses.
    The first tick after each rewrite has the eager tick's logits bit for
    bit in every running slot, the streams are equal, and the graph
    Scheduler captures nothing."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    out = {}
    for name, sched in (("graph", graph_sched), ("eager", eager_sched)):
        fresh_slots(sched)
        captures = sched.graphs.captures
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=48)) for p in prompts]
        for _ in range(24):
            sched.step()
        shift_slots(sched, 4, 32)
        sched.step()
        logits = [running_logits(sched)]
        sched.run_until_idle()
        toks = [r.tokens() for r in reqs]
        f = tmp / f"kvq_{name}.state"
        n_bytes = sched.save_slot(0, str(f))
        sched.slots[0].cached_tokens = []
        for buf in sched.cache.buffers():
            buf[:, 0].zero_()
        info = sched.restore_slot(2, str(f))
        sched.slot_similarity = 0.5  # to the restored slot, its prefix reused
        cont = sched.submit(Request(prompt_tokens=sched.slots[2].cached_tokens + [5, 6],
                                    max_new_tokens=16))
        sched.step()
        logits.append(running_logits(sched))
        sched.run_until_idle()
        sched.slot_similarity = 0.0
        out[name] = (toks + [cont.tokens()], logits, sched.graphs.captures - captures)
    (gt, gl, gc), (et, el, _) = out["graph"], out["eager"]
    check(gt == et and all(len(t) == 48 for t in gt[:-1]),
          "5r: the int8 Scheduler's graph streams differ from eager after a shift or restore")
    bad = [what for what, a, b in zip(("shift", "restore"), gl, el) if not torch.equal(a, b)]
    check(not bad and gc == 0, f"5r: the tick after the {bad} differs from eager's "
                               f"({gc} captures)")
    row = {"requests": len(prompts), "shift": {"keep": 4, "discard": 32},
           "slot_file_bytes": n_bytes, "restored_n_past": info["n_past"],
           "ticks_bit_equal": True, "streams_equal": True}
    print("phase 5r, int8 Scheduler after a shift and a restore:", json.dumps(row))
    return row


def kvq_scheduler(row_pre, scfg, greedy, prompts, prompts_h, tmp) -> dict:
    """The 4-slot v1 Scheduler (-ctk q8 -ctv q8) over the prepared row
    stores `row_pre`: its main path (v1 L times a tick), its graph ticks
    against eager ticks (streams equal, first tick's logits bit-equal), and
    the shift and restore of kvq_rewrites."""
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler

    kw = dict(n_slots=4, max_seq=128, sampler=greedy, sparse=scfg, sparse_batch_max=4,
              sparse_preprepared=True, kv_quantized=True, device="cuda")
    sched, eager = Scheduler(row_pre, **kw), Scheduler(row_pre, cuda_graph=False, **kw)
    launches = scheduler_path(sched, prompts, 32, label="7B bf16 int8 KV")
    h = scheduler_graph_vs_eager(sched, eager, prompts_h, 24, label="7B bf16 int8 KV")
    rewrites = kvq_rewrites(sched, eager, prompts_h[:4], tmp)
    return {"v1_launches": launches, "graph_vs_eager": {k: h[k] for k in (
        "graph", "eager", "replay_span_ms", "wall_speedup")}, "rewrites": rewrites}


def phase_kvq(model, sparse_eng, sched, scfg, greedy, prompt, tmp) -> dict:
    """Phase 5r: the f32 gate, then the int8 cache over the 7B sparse
    Engine (the bf16-cache engine's prepared stores) and its long-context
    bytes and steps, the 4-slot v1 Scheduler over the int8 cache (the
    bf16-cache Scheduler's row stores), and a split cache (-ctk bf16 -ctv
    f32): the Engine's graph stream against its eager step's. Returns its
    summary, with v6's and v1's main-path launches."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    cfg = model.config
    gate = kvq_f32_gate(greedy, list(range(3, 40, 3)))
    mark("phase 5r, f32 gate")
    pre = LoadedModel(config=cfg, params=sparse_eng.params)
    eng = kvq_engine(pre, scfg, greedy, prompt, 32, "7B bf16 sparse")
    torch.cuda.empty_cache()
    mark("phase 5r, 7B int8 engine")
    long = kvq_long_context(pre, scfg, greedy, prompt)
    mark("phase 5r, long context")
    gen = torch.Generator().manual_seed(SEED + 92)
    prompts = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    prompts_h = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    sch = kvq_scheduler(LoadedModel(config=cfg, params=sched.params), scfg, greedy, prompts,
                        prompts_h, tmp)
    torch.cuda.empty_cache()
    mark("phase 5r, int8 Scheduler")
    kw = dict(max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
              kv_dtype=torch.bfloat16, kv_dtype_v=torch.float32, device="cuda")
    split_g, split_e = Engine(pre, **kw), Engine(pre, cuda_graph=False, **kw)
    split = graph_eager_pair("split KV cache (bf16 K, f32 V)", split_g, split_e, prompt, 32)
    check((split_g.cache.k.dtype, split_g.cache.v.dtype) == (torch.bfloat16, torch.float32),
          "5r: the split cache's dtypes")
    del split_g, split_e
    torch.cuda.empty_cache()
    print("phase 5r, split cache (-ctk bf16 -ctv f32; streams equal, every step's logits "
          "bit-equal):", json.dumps(split))
    mark("phase 5r")
    return {"f32_gate": gate, "engine": eng, "long_context": long, "scheduler": sch,
            "split": split, "v6_launches": eng["launches"],
            "v1_launches": sch["v1_launches"], "seconds": time.perf_counter() - t0}


def kvq_only(greedy) -> int:
    """`chip_smoke.py --kvq`: phase 5r alone (after phases 1 and 2), on the
    7B bf16 model, its sparse engine (its main path's stream is the bf16
    cache's reference) and the 4-slot v1 Scheduler's row stores, as the full
    run builds them; prints its summary and no result."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    cfg = prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    scfg = SparseConfig(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    sparse_eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, device="cuda")
    main_path("7B bf16 sparse", sparse_eng, prompt, 64,
              lambda steps: {"sparse_ffn_block_v6": cfg.n_layer * steps})
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_batch_max=4, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        kvq = phase_kvq(model, sparse_eng, sched, scfg, greedy, prompt, pathlib.Path(tmp))
    print("phase 5r summary:", json.dumps(kvq_summary(kvq)))
    return 0


def kvq_summary(k) -> dict:
    """Phase 5r's numbers in brief, for the end of the full run's output."""
    e = k["engine"]
    return {"f32_gate_first_logits_rel_gap": k["f32_gate"]["first_logits_rel_gap"],
            "engine": {key: e[key] for key in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "replay_span_ms",
                "v6_per_step", "first_logits_rel_gap_vs_bf16_cache",
                "streams_part_at_vs_bf16_cache", "dense_first_logits_rel_gap_vs_bf16_cache",
                "launches", "peak_gib")},
            "long_context": [{key: r[key] for key in (
                "max_seq", "kv", "kv_bytes", "bytes_per_token", "replay_span_ms", "tok_s")}
                for r in k["long_context"]],
            "scheduler": {"graph_tok_s": k["scheduler"]["graph_vs_eager"]["graph"]["tok_s"],
                          "eager_tok_s": k["scheduler"]["graph_vs_eager"]["eager"]["tok_s"],
                          "v1_launches": k["v1_launches"]},
            "split": k["split"], "seconds": k["seconds"]}


# --- phase 5s: MiniCPM3-4B in Q8_0, the plm and nemotron cuts ----------------

MINICPM3_GGUF_PACKED = 4241742080  # its Q8_0 GGUF's linears: 34-byte blocks of 32 weights


def minicpm3_4b_config(L):
    """openbmb/MiniCPM3-4B's config.json: 62 layers, E=2560, 40 heads of
    q/k 96 (64 + rope 32) and v 64, q-lora 768, kv-lora 256, F=6400,
    V=73448; its multipliers as the GGUF keys the fault-7 port reads
    (scale_emb 12, scale_depth 1.4 / sqrt(62), dim_model_base 256 / 2560);
    its longrope rope_factors, which neither loader reads, left out."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    # n_head_kv = n_head: the JAX config's quirk under MLA; the latent cache ignores it
    return ModelConfig(arch="minicpm3", n_layer=L, n_embd=2560, n_head=40, n_head_kv=40,
                       head_dim=96, rope_dim=32, q_lora_rank=768, kv_lora_rank=256,
                       v_head_dim=64, n_ff=6400, n_vocab=73448, norm_eps=1e-5,
                       rope_freq_base=10000.0, n_ctx_train=32768, embd_scale=12.0,
                       residual_scale=1.4 / 62 ** 0.5, logit_scale=256 / 2560)


def q8_random(gen, shape):
    """A Q8_0 QuantTensor (codes (..., IN, OUT), scales (..., IN/32, OUT))
    drawn on the card: codes uniform in [-127, 127], scales 0.02/73.6 (1 +
    N(0, 0.1)), weights of about N(0, 0.02)'s spread."""
    import torch

    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    *lead, IN, OUT = shape
    q = torch.empty(shape, dtype=torch.int8, device="cuda").random_(-127, 128, generator=gen)
    s = torch.empty((*lead, IN // 32, OUT), device="cuda").normal_(1.0, 0.1, generator=gen)
    return QuantTensor(q, s.abs_().mul_(0.02 / 73.6), "q8_0")


def random_mla_q8(cfg, dtype, seed):
    """A minicpm3 (the q-lora) or plm (a direct q, an ungated FFN) model as
    its Q8_0 GGUF loads with keep_quantized: Q8_0 wq_a, wq_b (or wq),
    wkv_a, wo, the FFN and the head, the key and value decompressors wk_b
    and wv_b dense in `dtype` (the loader dequantizes them), the embeddings
    in `dtype`, 1 + N(0, 0.1) norms in f32."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    L, E, H, Dk, Dr, R = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.rope_dim,
                          cfg.kv_lora_rank)
    Dv, F, V, Qr = cfg.v_head_dim, cfg.n_ff, cfg.n_vocab, cfg.q_lora_rank

    def norm(*shape):
        return torch.empty(shape, device="cuda").normal_(1.0, 0.1, generator=gen)

    def normal(shape):
        return torch.empty(shape, dtype=dtype, device="cuda").normal_(0.0, 0.02, generator=gen)

    layers = {"attn_norm_w": norm(L, E), "ffn_norm_w": norm(L, E), "kv_a_norm_w": norm(L, R),
              "wkv_a": q8_random(gen, (L, E, R + Dr)), "wk_b": normal((L, R, H, Dk - Dr)),
              "wv_b": normal((L, R, H, Dv)), "wo": q8_random(gen, (L, H * Dv, E)),
              "w_up": q8_random(gen, (L, E, F)), "w_down": q8_random(gen, (L, F, E))}
    if Qr:
        layers.update(wq_a=q8_random(gen, (L, E, Qr)), q_a_norm_w=norm(L, Qr),
                      wq_b=q8_random(gen, (L, Qr, H * Dk)))
    else:
        layers["wq"] = q8_random(gen, (L, E, H * Dk))
    if cfg.traits.act != "relu2":
        layers["w_gate"] = q8_random(gen, (L, E, F))
    params = {"tok_embd": normal((V, E)), "output_norm_w": norm(E),
              "output": q8_random(gen, (E, V)), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def mla_arch_latent_cache(model, greedy, prompt) -> dict:
    """The dense Engine at max_seq 32768 over the latent cache: its bytes, L
    x (kv_lora_rank + rope_dim) x 2 a token (35,712 at MiniCPM3-4B's 62
    layers), and the device ms of a decode step (one replay's span) after
    16 greedy tokens."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    cfg = model.config
    eng = Engine(model, max_seq=32768, sampler=greedy, device="cuda")
    toks = run_generate(eng, prompt, 16)
    per_token = cfg.n_layer * (cfg.kv_lora_rank + cfg.rope_dim) * 2
    check(kv_bytes(eng.cache) == per_token * 32768,
          f"5s: a latent cache of {kv_bytes(eng.cache)} bytes, want {per_token} a token")
    step = eng.graphs.get(eng.cache, 1, "decode", None)
    row = {"max_seq": 32768, "kv_bytes": kv_bytes(eng.cache), "bytes_per_token": per_token,
           "tok_s": eng.perf.decode_tps, **replay_times(step), "tokens_first8": toks[:8]}
    print("phase 5s, latent cache:", json.dumps(row))
    del eng, step
    torch.cuda.empty_cache()
    return row


def mla_arch_cuts(greedy) -> list:
    """4-layer cuts, each decode graph against an eager engine (streams
    equal, first decode logits bit-equal): plm at MiniCPM3-4B's widths (a
    direct q, an ungated relu² FFN, Q8_0) and nemotron at E=2560, F=6400
    (32 heads over 8 KV heads of 80, LayerNorm with biases, rope over 40 of
    80 lanes, relu², bf16)."""
    import dataclasses

    import torch

    from sparkinfer_tpu_torch.models.config import ModelConfig
    from sparkinfer_tpu_torch.runtime.engine import Engine

    plm = dataclasses.replace(minicpm3_4b_config(4), arch="plm", q_lora_rank=0,
                              embd_scale=1.0, residual_scale=1.0, logit_scale=1.0)
    nemotron = ModelConfig(arch="nemotron", n_layer=4, n_embd=2560, n_head=32, n_head_kv=8,
                           head_dim=80, rope_dim=40, n_ff=6400, n_vocab=32000, norm_eps=1e-5,
                           rope_freq_base=10000.0)
    f32 = torch.float32

    def ln_biases(normal):
        return {"attn_norm_b": normal((4, 2560), 0.1, f32),
                "ffn_norm_b": normal((4, 2560), 0.1, f32)}

    gen = torch.Generator().manual_seed(SEED + 84)
    out = []
    for i, (name, make) in enumerate((
            ("plm", lambda: random_mla_q8(plm, torch.bfloat16, SEED + 85)),
            ("nemotron", lambda: random_cut(nemotron, SEED + 86, ln_biases)))):
        model = make()
        if name == "nemotron":  # relu² is ungated: no gate projection
            model.params["layers"].pop("w_gate")
        prompt = torch.randint(model.config.n_vocab, (32,), generator=gen).tolist()
        kw = dict(max_seq=1024, sampler=greedy, device="cuda")
        row = graph_vs_eager(f"{name} cut", Engine(model, **kw),
                             Engine(model, cuda_graph=False, **kw), prompt, 64)
        out.append({"arch": name, **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
                    "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]})
        del model
        torch.cuda.empty_cache()
    return out


def phase_mla_archs(greedy, L: int = 62) -> dict:
    """Phase 5s: the f32 gate at 4 layers, then MiniCPM3-4B at full width
    and depth L in Q8_0 (q8_dense_engine: 7L + 1 quant_matmul_2d calls a
    forward, wq_a, wq_b, wkv_a, wo, up, gate, down and the head), its
    latent cache at max_seq 32768, quant_matmul_2d at its seven shapes
    (the head's OUT of 73448 not 16-aligned), and the plm and nemotron
    cuts. Returns its summary, with quant_matmul_2d's main-path launches."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5s: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 80)
    prompt = torch.randint(73448, (32,), generator=gen).tolist()
    gate = q8_f32_gate("MiniCPM3-4B widths, 4 layers, Q8_0", "5s",
                       random_mla_q8(minicpm3_4b_config(4), torch.float32, SEED + 81), prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5s, f32 gate")
    cfg = minicpm3_4b_config(L)
    t1 = time.perf_counter()
    model = random_mla_q8(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    packed = q8_step_bound(model, 0)["weight_bytes"]
    print(f"model: MiniCPM3-4B widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"q_lora={cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} Dk={cfg.head_dim} "
          f"Dr={cfg.rope_dim} Dv={cfg.v_head_dim} F={cfg.n_ff} V={cfg.n_vocab}, Q8_0 "
          f"({packed} bytes packed with f32 scales; the GGUF's {MINICPM3_GGUF_PACKED} at 62 "
          f"layers), built in {time.perf_counter() - t1:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    row = q8_dense_engine("MiniCPM3-4B Q8_0 dense", "5s", model, greedy, prompt, 64)
    print("phase 5s, MiniCPM3-4B (graph decode; streams equal, first decode logits bit-equal):",
          json.dumps(row))
    mark("phase 5s, MiniCPM3-4B engine")
    cache = mla_arch_latent_cache(model, greedy, prompt)
    rows = q8_qmm_rows(model, ("wq_a", "wq_b", "wkv_a", "wo", "w_up", "w_down", "head"),
                       SEED + 82, per_call=1)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5s, quant_matmul_2d at the MiniCPM3-4B shapes")
    cuts = mla_arch_cuts(greedy)
    mark("phase 5s, plm and nemotron cuts")
    return {"f32_gate": gate, "engine": row, "latent_cache": cache, "rows": rows, "cuts": cuts,
            "packed_bytes": packed, "qmm_launches": row["launches"],
            "seconds": time.perf_counter() - t0}


def mla_archs_summary(m) -> dict:
    """Phase 5s's numbers in brief, for the end of the full run's output."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    e = m["engine"]
    return {"f32_gate_worst": m["f32_gate"]["worst_rel_err"],
            "minicpm3_4b_qmm": [{"shape": r["shape"], **{k: r[k] for k in keys}}
                                for r in m["rows"]],
            "minicpm3_4b": {"bound_ms": e["step_bound"]["bound_ms"], **{k: e[k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "replay_span_ms",
                "qmm_decode_per_step", "qmm_prefill_per_prefill", "x_bound", "peak_gib",
                "launches")}},
            "latent_cache": {k: m["latent_cache"][k] for k in (
                "kv_bytes", "bytes_per_token", "replay_span_ms", "tok_s")},
            "cuts": m["cuts"], "packed_bytes": m["packed_bytes"], "seconds": m["seconds"]}


# --- phase 5t: ALiBi and the GPT family: BLOOM-7b1 in Q8_0, three cuts -------

BLOOM_GGUF_PACKED = 6417285120  # its Q8_0 GGUF's linears at 30 layers: 34 bytes a 32 weights


def bloom_7b1_config(L):
    """bigscience/bloom-7b1's config.json: 30 layers, hidden 4096, 32 heads
    of 128, the FFN 4 x 4096, vocab 250880, LayerNorm eps 1e-5, ALiBi (the
    arch's trait), tied embeddings."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="bloom", n_layer=L, n_embd=4096, n_head=32, n_head_kv=32,
                       head_dim=128, n_ff=16384, n_vocab=250880, norm_eps=1e-5,
                       n_ctx_train=2048)


def random_bloom_q8(cfg, dtype, seed):
    """BLOOM as its Q8_0 GGUF loads with keep_quantized: Q8_0 wq, wk, wv, wo,
    up and down (q8_random), the embedding in `dtype` and the tied head its
    transpose (the loader's copy), 1 + N(0, 0.1) LayerNorm weights, the
    post-embedding LayerNorm's too, and N(0, 0.02) biases on every norm,
    q, k, v, o, up and down, in f32."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab

    def f32(*shape, mean=0.0, std=0.02):
        return torch.empty(shape, device="cuda").normal_(mean, std, generator=gen)

    layers = {"attn_norm_w": f32(L, E, mean=1.0, std=0.1), "attn_norm_b": f32(L, E),
              "ffn_norm_w": f32(L, E, mean=1.0, std=0.1), "ffn_norm_b": f32(L, E),
              **{k: q8_random(gen, (L, E, E)) for k in ("wq", "wk", "wv", "wo")},
              **{k: f32(L, E) for k in ("bq", "bk", "bv", "bo")},
              "w_up": q8_random(gen, (L, E, F)), "b_up": f32(L, F),
              "w_down": q8_random(gen, (L, F, E)), "b_down": f32(L, E)}
    tok = torch.empty((V, E), dtype=dtype, device="cuda").normal_(0.0, 0.02, generator=gen)
    params = {"tok_embd": tok, "tok_norm_w": f32(E, mean=1.0, std=0.1), "tok_norm_b": f32(E),
              "output_norm_w": f32(E, mean=1.0, std=0.1), "output_norm_b": f32(E),
              "output": tok.T.contiguous(), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def bloom_long_context(model, greedy, prompt) -> list:
    """The dense Engine at max_seq 2048 and 16384: its K/V bytes (L x 2 x E
    x 2 a token, 491,520 at 30 layers) and the device ms of a decode step
    (one replay's span over the whole cache: the plain attention and the
    ALiBi term read every slot) after 16 greedy tokens."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    cfg = model.config
    per_token = cfg.n_layer * 2 * cfg.n_head_kv * cfg.head_dim * 2
    out = []
    for max_seq in (2048, 16384):
        eng = Engine(model, max_seq=max_seq, sampler=greedy, device="cuda")
        toks = run_generate(eng, prompt, 16)
        check(kv_bytes(eng.cache) == per_token * max_seq,
              f"5t: a K/V cache of {kv_bytes(eng.cache)} bytes, want {per_token} a token")
        step = eng.graphs.get(eng.cache, 1, "decode", None)
        row = {"max_seq": max_seq, "kv_bytes": kv_bytes(eng.cache),
               "bytes_per_token": per_token, "tok_s": eng.perf.decode_tps,
               # the live rows (the step's bound), and every slot the plain
               # attention reads
               "bound_ms": q8_step_bound(model, len(prompt) + 16)["bound_ms"],
               "bound_ms_every_slot": q8_step_bound(model, max_seq)["bound_ms"],
               **replay_times(step), "tokens_first8": toks[:8]}
        print("phase 5t, long context:", json.dumps(row))
        out.append(row)
        del eng, step
        torch.cuda.empty_cache()
    return out


def gpt_cuts(greedy) -> list:
    """2-layer bf16 cuts at their config.json widths, each decode graph
    against an eager engine (streams equal, first decode logits bit-equal):
    mosaicml/mpt-7b (E=4096, 32 heads, F=16384, V=50432: ALiBi, LayerNorm
    without biases, no biases, tied head), EleutherAI/gpt-j-6b (E=4096, 16
    heads of 256, rope over 64 lanes interleaved, F=16384, V=50400: the
    parallel block with one LayerNorm, FFN and head biases) and
    bigcode/starcoder (E=6144, 48 heads over 1 KV head, F=24576, V=49152,
    8192 learned positions, biases everywhere)."""
    import torch

    from sparkinfer_tpu_torch.models.config import ModelConfig
    from sparkinfer_tpu_torch.runtime.engine import Engine

    f32 = torch.float32
    mpt = ModelConfig(arch="mpt", n_layer=2, n_embd=4096, n_head=32, n_head_kv=32, head_dim=128,
                      n_ff=16384, n_vocab=50432, norm_eps=1e-5, n_ctx_train=2048)
    gptj = ModelConfig(arch="gptj", n_layer=2, n_embd=4096, n_head=16, n_head_kv=16,
                       head_dim=256, rope_dim=64, n_ff=16384, n_vocab=50400, norm_eps=1e-5,
                       rope_freq_base=10000.0, n_ctx_train=2048)
    starcoder = ModelConfig(arch="starcoder", n_layer=2, n_embd=6144, n_head=48, n_head_kv=1,
                            head_dim=128, n_ff=24576, n_vocab=49152, norm_eps=1e-5,
                            n_ctx_train=8192)

    def gptj_extra(normal):
        return {"attn_norm_b": normal((2, 4096), 0.1, f32), "b_up": normal((2, 16384), 0.02, f32),
                "b_down": normal((2, 4096), 0.02, f32)}

    def starcoder_extra(normal):
        E, KD = 6144, 128
        return {"attn_norm_b": normal((2, E), 0.1, f32), "ffn_norm_b": normal((2, E), 0.1, f32),
                "bq": normal((2, E), 0.02, f32), "bk": normal((2, KD), 0.02, f32),
                "bv": normal((2, KD), 0.02, f32), "bo": normal((2, E), 0.02, f32),
                "b_up": normal((2, 24576), 0.02, f32), "b_down": normal((2, E), 0.02, f32)}

    gen = torch.Generator().manual_seed(SEED + 94)
    out = []
    for name, cfg, extra in (("mpt", mpt, lambda normal: {}), ("gptj", gptj, gptj_extra),
                             ("starcoder", starcoder, starcoder_extra)):
        model = random_cut(cfg, SEED + 95 + len(out), extra)
        p = model.params
        p["layers"].pop("w_gate")  # gelu: no gate projection
        if name == "mpt":  # LayerNorm weights alone, the head tied
            p.pop("output_norm_b")
            p["output"] = p["tok_embd"].T.contiguous()
        cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 98 + len(out))
        if name == "gptj":  # one LayerNorm feeds both branches; the head's bias
            p["layers"].pop("ffn_norm_w")
            p["output_b"] = torch.empty(cfg.n_vocab, device="cuda").normal_(
                0.0, 0.1, generator=cuda_gen)
        if name == "starcoder":
            p["pos_embd"] = torch.empty((8192, cfg.n_embd), dtype=torch.bfloat16,
                                        device="cuda").normal_(0.0, 0.02, generator=cuda_gen)
        prompt = torch.randint(cfg.n_vocab, (32,), generator=gen).tolist()
        kw = dict(max_seq=1024, sampler=greedy, device="cuda")
        row = graph_vs_eager(f"{name} cut", Engine(model, **kw),
                             Engine(model, cuda_graph=False, **kw), prompt, 64)
        out.append({"arch": name, **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
                    "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]})
        del model, p
        torch.cuda.empty_cache()
    return out


def phase_gpt_archs(greedy, L: int = 30) -> dict:
    """Phase 5t: the f32 gate at 4 layers, then BLOOM-7b1 at full width and
    depth L in Q8_0 (q8_dense_engine: 6L quant_matmul_2d calls a forward,
    wq, wk, wv, wo, up and down; the head bf16), its cache at max_seq 2048
    and 16384, quant_matmul_2d at its three shapes, and the mpt, gpt-j and
    starcoder cuts. Returns its summary, with quant_matmul_2d's main-path
    launches."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5t: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 90)
    prompt = torch.randint(250880, (32,), generator=gen).tolist()
    gate = q8_f32_gate("BLOOM-7b1 widths, 4 layers, Q8_0", "5t",
                       random_bloom_q8(bloom_7b1_config(4), torch.float32, SEED + 91), prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5t, f32 gate")
    cfg = bloom_7b1_config(L)
    t1 = time.perf_counter()
    model = random_bloom_q8(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    packed = q8_step_bound(model, 0)["weight_bytes"]
    print(f"model: BLOOM-7b1 widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"D={cfg.head_dim} F={cfg.n_ff} V={cfg.n_vocab}, ALiBi, Q8_0 attention/FFN "
          f"({packed} bytes packed with f32 scales; the GGUF's {BLOOM_GGUF_PACKED} at 30 "
          f"layers), tied bf16 head, built in {time.perf_counter() - t1:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    row = q8_dense_engine("BLOOM-7b1 Q8_0 dense", "5t", model, greedy, prompt, 64)
    print("phase 5t, BLOOM-7b1 (graph decode; streams equal, first decode logits bit-equal):",
          json.dumps(row))
    mark("phase 5t, BLOOM-7b1 engine")
    long_ctx = bloom_long_context(model, greedy, prompt)
    rows = q8_qmm_rows(model, ("wq", "w_up", "w_down"), SEED + 92, per_call=1)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5t, long context and quant_matmul_2d at the BLOOM-7b1 shapes")
    cuts = gpt_cuts(greedy)
    mark("phase 5t, mpt, gpt-j and starcoder cuts")
    return {"f32_gate": gate, "engine": row, "long_context": long_ctx, "rows": rows,
            "cuts": cuts, "packed_bytes": packed, "qmm_launches": row["launches"],
            "seconds": time.perf_counter() - t0}


def gpt_archs_summary(g) -> dict:
    """Phase 5t's numbers in brief, for the end of the full run's output."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    e = g["engine"]
    return {"f32_gate_worst": g["f32_gate"]["worst_rel_err"],
            "bloom_7b1_qmm": [{"shape": r["shape"], **{k: r[k] for k in keys}}
                              for r in g["rows"]],
            "bloom_7b1": {"bound_ms": e["step_bound"]["bound_ms"], **{k: e[k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "replay_span_ms",
                "qmm_decode_per_step", "qmm_prefill_per_prefill", "x_bound", "peak_gib",
                "launches")}},
            "long_context": [{k: r[k] for k in ("max_seq", "kv_bytes", "replay_span_ms",
                                                "bound_ms", "bound_ms_every_slot", "tok_s")}
                             for r in g["long_context"]],
            "cuts": g["cuts"], "packed_bytes": g["packed_bytes"], "seconds": g["seconds"]}


# --- phase 5u: decoders with features of their own: OLMo-2-7B in Q8_0 and cuts --

OLMO2_GGUF_PACKED = 7317487616  # its Q8_0 GGUF's linears and head at 32 layers: 34 bytes a 32 weights


def olmo2_7b_config(L):
    """allenai/OLMo-2-1124-7B's config.json: 32 layers, hidden 4096, 32 heads
    of 128 (MHA), FFN 11008, vocab 100352, RMS eps 1e-6, rope theta 500000,
    an untied head; post-norms only and full-width q/k norms (the arch's
    blocks)."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="olmo2", n_layer=L, n_embd=4096, n_head=32, n_head_kv=32,
                       head_dim=128, n_ff=11008, n_vocab=100352, norm_eps=1e-6,
                       rope_freq_base=500000.0, n_ctx_train=4096)


def random_olmo2_q8(cfg, dtype, seed):
    """OLMo-2 as its Q8_0 GGUF loads with keep_quantized: Q8_0 wq, wk, wv, wo,
    up, gate, down and head (q8_random), the embedding in `dtype`, and in
    f32 1 + N(0, 0.1) post-norms (attn_post_norm, ffn_post_norm), full-width
    q/k norms (H*D and Hkv*D wide) and output norm; no pre-norms."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab
    HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim

    def norm(*shape):
        return torch.empty(shape, device="cuda").normal_(1.0, 0.1, generator=gen)

    layers = {"attn_post_norm_w": norm(L, E), "ffn_post_norm_w": norm(L, E),
              "attn_q_norm_w": norm(L, HD), "attn_k_norm_w": norm(L, KD),
              "wq": q8_random(gen, (L, E, HD)), "wk": q8_random(gen, (L, E, KD)),
              "wv": q8_random(gen, (L, E, KD)), "wo": q8_random(gen, (L, HD, E)),
              "w_up": q8_random(gen, (L, E, F)), "w_gate": q8_random(gen, (L, E, F)),
              "w_down": q8_random(gen, (L, F, E))}
    tok = torch.empty((V, E), dtype=dtype, device="cuda").normal_(0.0, 0.02, generator=gen)
    params = {"tok_embd": tok, "output_norm_w": norm(E), "output": q8_random(gen, (E, V)),
              "layers": layers}
    return LoadedModel(config=cfg, params=params)


def olmo2_long_context(model, greedy, prompt) -> list:
    """The dense Engine at max_seq 2048 and 16384: its K/V bytes (L x 2 x E
    x 2 a token, 524,288 at 32 layers) and the device ms of a decode step
    (one replay's span; the plain attention reads every slot) after 16
    greedy tokens."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    cfg = model.config
    per_token = cfg.n_layer * 2 * cfg.n_head_kv * cfg.head_dim * 2
    out = []
    for max_seq in (2048, 16384):
        eng = Engine(model, max_seq=max_seq, sampler=greedy, device="cuda")
        toks = run_generate(eng, prompt, 16)
        check(kv_bytes(eng.cache) == per_token * max_seq,
              f"5u: a K/V cache of {kv_bytes(eng.cache)} bytes, want {per_token} a token")
        step = eng.graphs.get(eng.cache, 1, "decode", None)
        row = {"max_seq": max_seq, "kv_bytes": kv_bytes(eng.cache),
               "bytes_per_token": per_token, "tok_s": eng.perf.decode_tps,
               "bound_ms": q8_step_bound(model, len(prompt) + 16)["bound_ms"],
               "bound_ms_every_slot": q8_step_bound(model, max_seq)["bound_ms"],
               **replay_times(step), "tokens_first8": toks[:8]}
        print("phase 5u, long context:", json.dumps(row))
        out.append(row)
        del eng, step
        torch.cuda.empty_cache()
    return out


def mrope_on_the_card() -> dict:
    """apply_mrope at Qwen2-VL-7B's text widths (28 heads of 128, sections
    16, 24, 24) on the card: three equal position streams give apply_rope's
    neox rotation bit for bit (f32), and distinct streams move it."""
    import torch

    from sparkinfer_tpu_torch.ops.rope import RopeParams, apply_mrope, apply_rope

    gen = torch.Generator(device="cuda").manual_seed(SEED + 101)
    x = torch.randn((1, 32, 28, 128), generator=gen, device="cuda")
    p = RopeParams(dim=128, mode="neox", freq_base=1e6)
    pos = torch.arange(1000, 1032, device="cuda")[None]
    same = apply_mrope(x, pos.expand(3, 1, 32), (16, 24, 24), p)
    plain = apply_rope(x, pos, p)
    check(torch.equal(same, plain), f"5u: M-RoPE over equal streams differs from neox rope by "
                                    f"{(same - plain).abs().max().item():.3e}")
    moved = apply_mrope(x, torch.stack([pos, pos // 2, pos % 7]), (16, 24, 24), p)
    row = {"equal_streams_bit_equal": True,
           "distinct_streams_max_diff": (moved - plain).abs().max().item()}
    check(row["distinct_streams_max_diff"] > 1e-2, "5u: distinct M-RoPE streams moved nothing")
    print("phase 5u, M-RoPE on the card:", json.dumps(row))
    return row


def feature_cuts(greedy) -> list:
    """2-layer bf16 cuts at their config.json widths, each decode graph
    against an eager engine (streams equal, first decode logits bit-equal):
    swiss-ai/Apertus-8B-2509 (E=4096, 32 heads over 8, an ungated F=21504
    under xIELU with per-layer coefficients, per-head q/k norms, V=131072),
    microsoft/bitnet-b1.58-2B-4T (E=2560, 20 heads over 5, F=6912,
    relu2_glu, both sub-norms, tied head, V=128256), facebook/chameleon-7b
    (E=4096, 32 heads, F=11008, (H, D) LayerNorm q/k norms with biases,
    V=65536) and Qwen/Qwen2-VL-7B-Instruct's text stack (E=3584, 28 heads
    over 4, F=18944, qkv biases, M-RoPE sections 16, 24, 24, V=152064)."""
    import torch

    from sparkinfer_tpu_torch.models.config import ModelConfig
    from sparkinfer_tpu_torch.runtime.engine import Engine

    f32 = torch.float32
    cuts = {
        "apertus": ModelConfig(arch="apertus", n_layer=2, n_embd=4096, n_head=32, n_head_kv=8,
                               head_dim=128, n_ff=21504, n_vocab=131072, norm_eps=1e-5,
                               rope_freq_base=12e6, n_ctx_train=65536,
                               xielu_alpha_p=(0.8, 0.7), xielu_alpha_n=(0.3, 0.4),
                               xielu_beta=(0.5, 0.5), xielu_eps=(-1e-6, -1e-6)),
        "bitnet": ModelConfig(arch="bitnet", n_layer=2, n_embd=2560, n_head=20, n_head_kv=5,
                              head_dim=128, n_ff=6912, n_vocab=128256, norm_eps=1e-5,
                              rope_freq_base=500000.0, n_ctx_train=4096),
        "chameleon": ModelConfig(arch="chameleon", n_layer=2, n_embd=4096, n_head=32,
                                 n_head_kv=32, head_dim=128, n_ff=11008, n_vocab=65536,
                                 norm_eps=1e-5, rope_freq_base=10000.0, n_ctx_train=4096),
        "qwen2vl": ModelConfig(arch="qwen2vl", n_layer=2, n_embd=3584, n_head=28, n_head_kv=4,
                               head_dim=128, n_ff=18944, n_vocab=152064, norm_eps=1e-6,
                               rope_freq_base=1e6, n_ctx_train=32768,
                               mrope_sections=(16, 24, 24)),
    }

    def extra(name, cfg):
        H, Hkv, D, F = cfg.n_head, cfg.n_head_kv, cfg.head_dim, cfg.n_ff

        def make(normal):
            if name == "apertus":
                sp = torch.nn.functional.softplus
                ap = torch.tensor(cfg.xielu_alpha_p, device="cuda")
                an = torch.tensor(cfg.xielu_alpha_n, device="cuda")
                return {"attn_q_norm_w": normal((2, D), 0.1, f32, 1.0),
                        "attn_k_norm_w": normal((2, D), 0.1, f32, 1.0),
                        "xielu_ap": sp(ap)[:, None], "xielu_an": (0.5 + sp(an))[:, None],
                        "xielu_beta": torch.full((2, 1), 0.5, device="cuda"),
                        "xielu_eps": torch.full((2, 1), -1e-6, device="cuda")}
            if name == "bitnet":
                return {"attn_sub_norm_w": normal((2, H * D), 0.1, f32, 1.0),
                        "ffn_sub_norm_w": normal((2, F), 0.1, f32, 1.0)}
            if name == "chameleon":
                return {"attn_q_norm_w": normal((2, H, D), 0.1, f32, 1.0),
                        "attn_q_norm_b": normal((2, H, D), 0.1, f32),
                        "attn_k_norm_w": normal((2, Hkv, D), 0.1, f32, 1.0),
                        "attn_k_norm_b": normal((2, Hkv, D), 0.1, f32)}
            return {"bq": normal((2, H * D), 0.1, f32), "bk": normal((2, Hkv * D), 0.1, f32),
                    "bv": normal((2, Hkv * D), 0.1, f32)}

        return make

    gen = torch.Generator().manual_seed(SEED + 102)
    out = []
    for i, (name, cfg) in enumerate(cuts.items()):
        model = random_cut(cfg, SEED + 103 + i, extra(name, cfg))
        p = model.params
        if name == "apertus":  # ungated: xIELU of up alone
            p["layers"].pop("w_gate")
        if name == "bitnet":  # the tied head
            p["output"] = p["tok_embd"].T.contiguous()
        prompt = torch.randint(cfg.n_vocab, (32,), generator=gen).tolist()
        kw = dict(max_seq=1024, sampler=greedy, device="cuda")
        row = graph_vs_eager(f"{name} cut", Engine(model, **kw),
                             Engine(model, cuda_graph=False, **kw), prompt, 64)
        out.append({"arch": name, **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
                    "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]})
        del model, p
        torch.cuda.empty_cache()
    return out


def random_deci(seed):
    """A 4-layer deci stack at E=4096, 32 heads of 128, with per-layer KV
    heads (8, 4, 0, 8) and FFN widths (14336, 11008, 14336, 8192), layer 2
    attention-free, V=128256 (synthetic widths in the shape of
    Llama-3.1-Nemotron's NAS layers, not a published config): each layer a
    segment of its own, as the loader stacks it, bf16, N(0, 0.02)
    projections and 1 + N(0, 0.1) f32 norms."""
    import torch

    from sparkinfer_tpu_torch.models.config import ModelConfig
    from sparkinfer_tpu_torch.models.loader import LoadedModel

    heads, kvs, ffs = (32, 32, 0, 32), (8, 4, 0, 8), (14336, 11008, 14336, 8192)
    cfg = ModelConfig(arch="deci", n_layer=4, n_embd=4096, n_head=32, n_head_kv=8,
                      n_head_arr=heads, n_head_kv_arr=kvs, n_ff=max(ffs), n_ff_arr=ffs,
                      head_dim=128, n_vocab=128256, norm_eps=1e-5, rope_freq_base=500000.0,
                      n_ctx_train=131072)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, D = cfg.n_embd, cfg.head_dim

    def normal(shape, std=0.02, dt=torch.bfloat16, mean=0.0):
        return torch.empty(shape, dtype=dt, device="cuda").normal_(mean, std, generator=gen)

    segs = []
    for H, Hkv, F in zip(heads, kvs, ffs):
        seg = {"attn_norm_w": normal((1, E), 0.1, torch.float32, 1.0),
               "ffn_norm_w": normal((1, E), 0.1, torch.float32, 1.0),
               "w_up": normal((1, E, F)), "w_gate": normal((1, E, F)),
               "w_down": normal((1, F, E))}
        if H:
            seg.update(wq=normal((1, E, H * D)), wk=normal((1, E, Hkv * D)),
                       wv=normal((1, E, Hkv * D)), wo=normal((1, H * D, E)))
        segs.append(seg)
    params = {"tok_embd": normal((cfg.n_vocab, E)),
              "output_norm_w": normal((E,), 0.1, torch.float32, 1.0),
              "output": normal((E, cfg.n_vocab)), "layers": segs[0], "layer_segments": segs}
    return LoadedModel(config=cfg, params=params)


def deci_cut(greedy) -> dict:
    """random_deci's stack, graph against eager past a context shift (max_seq
    64: a 32-token prompt and 64 tokens): streams equal and first decode
    logits bit-equal; its layer of 4 KV heads reads and writes the first 4
    of the cache's 8 through a narrowed view, which the replayed graph must
    write in place."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    model = random_deci(SEED + 107)
    gen = torch.Generator().manual_seed(SEED + 108)
    prompt = torch.randint(model.config.n_vocab, (32,), generator=gen).tolist()
    kw = dict(max_seq=64, sampler=greedy, device="cuda")
    graph_eng = Engine(model, **kw)
    row = graph_vs_eager("deci cut, past a context shift", graph_eng,
                         Engine(model, cuda_graph=False, **kw), prompt, 64)
    k = graph_eng.cache.k  # (L, B, S, 8, D): the narrowed layer's heads 4-7 never written
    check(not k[1, :, :, 4:].any() and bool(k[1, :, :, :4].any()) and not k[2].any(),
          "5u deci: the narrowed layer wrote past its 4 KV heads, or the attention-free one "
          "wrote at all")
    del model, graph_eng
    torch.cuda.empty_cache()
    return {"arch": "deci", **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
            "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]}


def phase_feature_archs(greedy, L: int = 32) -> dict:
    """Phase 5u: the f32 gate at 4 layers, then OLMo-2-1124-7B at full width
    and depth L in Q8_0 (q8_dense_engine: 7L + 1 quant_matmul_2d calls a
    forward, wq, wk, wv, wo, up, gate, down and the head), its cache at
    max_seq 2048 and 16384, quant_matmul_2d at its three new shapes, M-RoPE
    on the card, the apertus, bitnet, chameleon and qwen2vl cuts and the
    deci stack. Returns its summary, with quant_matmul_2d's main-path
    launches."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5u: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 100)
    prompt = torch.randint(100352, (32,), generator=gen).tolist()
    gate = q8_f32_gate("OLMo-2-7B widths, 4 layers, Q8_0", "5u",
                       random_olmo2_q8(olmo2_7b_config(4), torch.float32, SEED + 104), prompt)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5u, f32 gate")
    cfg = olmo2_7b_config(L)
    t1 = time.perf_counter()
    model = random_olmo2_q8(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    packed = q8_step_bound(model, 0)["weight_bytes"]
    print(f"model: OLMo-2-1124-7B widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"D={cfg.head_dim} F={cfg.n_ff} V={cfg.n_vocab}, post-norms only, Q8_0 "
          f"attention/FFN/head ({packed} bytes packed with f32 scales; the GGUF's "
          f"{OLMO2_GGUF_PACKED} at 32 layers), built in {time.perf_counter() - t1:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    row = q8_dense_engine("OLMo-2-7B Q8_0 dense", "5u", model, greedy, prompt, 64)
    print("phase 5u, OLMo-2-7B (graph decode; streams equal, first decode logits bit-equal):",
          json.dumps(row))
    mark("phase 5u, OLMo-2-7B engine")
    long_ctx = olmo2_long_context(model, greedy, prompt)
    rows = q8_qmm_rows(model, ("w_up", "w_down", "head"), SEED + 105, per_call=1)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5u, long context and quant_matmul_2d at the OLMo-2-7B shapes")
    mrope = mrope_on_the_card()
    cuts = feature_cuts(greedy)
    cuts.append(deci_cut(greedy))
    mark("phase 5u, apertus, bitnet, chameleon, qwen2vl and deci cuts")
    return {"f32_gate": gate, "engine": row, "long_context": long_ctx, "rows": rows,
            "mrope": mrope, "cuts": cuts, "packed_bytes": packed,
            "qmm_launches": row["launches"], "seconds": time.perf_counter() - t0}


def feature_archs_summary(g) -> dict:
    """Phase 5u's numbers in brief, for the end of the full run's output."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    e = g["engine"]
    return {"f32_gate_worst": g["f32_gate"]["worst_rel_err"],
            "olmo2_7b_qmm": [{"shape": r["shape"], **{k: r[k] for k in keys}}
                             for r in g["rows"]],
            "olmo2_7b": {"bound_ms": e["step_bound"]["bound_ms"], **{k: e[k] for k in (
                "tok_s", "wall_ms_per_step", "device_ms_per_step", "replay_span_ms",
                "qmm_decode_per_step", "qmm_prefill_per_prefill", "x_bound", "peak_gib",
                "launches")}},
            "long_context": [{k: r[k] for k in ("max_seq", "kv_bytes", "replay_span_ms",
                                                "bound_ms", "bound_ms_every_slot", "tok_s")}
                             for r in g["long_context"]],
            "mrope": g["mrope"], "cuts": g["cuts"], "packed_bytes": g["packed_bytes"],
            "seconds": g["seconds"]}


# --- phase 5v: the non-causal encoders (bge-large-en-v1.5 Q8_0, EmbeddingGemma,
# NeoBERT) and 15g's trait decoders ---------------------------------------------

# f32: a layer's hidden states through the kernels against the plain path's,
# both fed the plain path's input, of their scale. Both round each packed
# product's input to bf16, so where an f32 input differs in a last bit a
# rounding lands apart: on the plain path alone, noise of 1e-7 on a
# bge-large layer's input moves its output by 5.5e-4 of the scale (CPU)
ENCODER_GATE_TOL = 2e-3
ENCODER_LENGTHS = (1, 4, 32, 128, 512)
# the gate's inputs: (seed, tokens), qmm_prefill at 512 and 32, qmm_decode at 4
ENCODER_GATE_INPUTS = ((SEED + 112, 512), (SEED + 113, 512), (SEED + 114, 32),
                       (SEED + 115, 4))


def bge_large_config(L: int = 24):
    """BAAI/bge-large-en-v1.5's config.json: BertModel, 24 layers, hidden
    1024, 16 heads of 64, FFN 4096, vocab 30522, 512 learned positions,
    type vocab 2, gelu (erf), LayerNorm eps 1e-12; CLS pooling (its
    sentence-transformers pooling config)."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="bert", n_layer=L, n_embd=1024, n_head=16, n_head_kv=16,
                       head_dim=64, n_ff=4096, n_vocab=30522, norm_eps=1e-12, n_ctx_train=512)


def random_bert_q8(cfg, dtype, seed):
    """bert as its Q8_0 GGUF loads with keep_quantized: Q8_0 wq, wk, wv, wo,
    up and down (q8_random), the embeddings (tokens, 512 positions, 2 token
    types) in `dtype` and the tied head the token embedding's transpose (a
    view: the Embedder reads no head), 1 + N(0, 0.1) LayerNorm weights (the
    embedding LayerNorm's and each layer's two post-sum norms) with N(0,
    0.02) biases, N(0, 0.02) biases on q, k, v, o, up and down, in f32; and
    a seeded reranker head (cls_w, cls_b, cls_out_w, cls_out_b), f32."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab

    def f32(*shape, mean=0.0, std=0.02):
        return torch.empty(shape, device="cuda").normal_(mean, std, generator=gen)

    def emb(*shape):
        return torch.empty(shape, dtype=dtype, device="cuda").normal_(0.0, 0.02, generator=gen)

    layers = {"attn_norm_w": f32(L, E, mean=1.0, std=0.1), "attn_norm_b": f32(L, E),
              "ffn_norm_w": f32(L, E, mean=1.0, std=0.1), "ffn_norm_b": f32(L, E),
              **{k: q8_random(gen, (L, E, E)) for k in ("wq", "wk", "wv", "wo")},
              **{k: f32(L, E) for k in ("bq", "bk", "bv", "bo")},
              "w_up": q8_random(gen, (L, E, F)), "b_up": f32(L, F),
              "w_down": q8_random(gen, (L, F, E)), "b_down": f32(L, E)}
    tok = emb(V, E)
    params = {"tok_embd": tok, "pos_embd": emb(cfg.n_ctx_train, E), "type_embd": emb(2, E),
              "tok_norm_w": f32(E, mean=1.0, std=0.1), "tok_norm_b": f32(E), "output": tok.T,
              "layers": layers, "cls_w": f32(E, E, std=0.03), "cls_b": f32(E),
              "cls_out_w": f32(1, E, std=0.05), "cls_out_b": f32(1)}
    return LoadedModel(config=cfg, params=params)


def wpm_vocab(n_vocab: int, seed: int):
    """A WordPiece Vocab of n_vocab pieces in bert-base-uncased's layout:
    [PAD] 0, [unused0-98] 1-99, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103,
    then the letters, digits and punctuation, their ## continuations, and
    whole words and ## suffixes of 2-9 letters made from the seed; [CLS]
    the bos and [SEP] the eos and separator, both added."""
    import numpy as np

    from sparkinfer_tpu_torch.tokenizer import Vocab

    rng = np.random.default_rng(seed)
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'")
    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars])
    seen = set(tokens)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(tokens) < n_vocab:
        piece = "".join(rng.choice(letters, size=int(rng.integers(2, 10))))
        piece = piece if rng.random() < 0.7 else "##" + piece
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
    types = np.full(n_vocab, 1, np.int32)  # NORMAL
    types[[0, 101, 102, 103]] = 3  # CONTROL
    types[100] = 2  # UNKNOWN
    return Vocab(model="bert", pre="default", tokens=tokens, token_types=types, scores=None,
                 merges=None, bos_id=101, eos_id=102, unk_id=100, pad_id=0, sep_id=102,
                 add_bos=True, add_eos=True, add_space_prefix=False)


def wpm_texts(vocab, gen, lengths):
    """Texts of whole vocabulary words that tokenize to `lengths` tokens each,
    [CLS] and [SEP] included."""
    import torch

    words = [t for t in vocab.tokens[104 + 2 * 41:] if not t.startswith("##")]
    return [" ".join(words[i] for i in torch.randint(len(words), (n - 2,), generator=gen))
            for n in lengths]


def encoder_layer_model(model, il, stream):
    """Layer il of a bert alone, fed `stream` (T, E): a 1-layer model whose
    token embedding is the stream (token t its row t) and whose positions,
    token types and embedding norm add nothing, so that its forward over
    tokens 0..T-1 is layer il of the port's forward on that input (its
    post-sum norms close it; bert has no final norm)."""
    import dataclasses

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    T, E = stream.shape
    layers = {k: (QuantTensor(v.q[il:il + 1], v.s[il:il + 1], v.kind)
                  if isinstance(v, QuantTensor) else v[il:il + 1])
              for k, v in model.params["layers"].items()}
    zeros = torch.zeros((T, E), device=stream.device)
    params = {"tok_embd": stream, "pos_embd": zeros, "type_embd": zeros[:2],
              "output": stream.T, "layers": layers}
    return LoadedModel(config=dataclasses.replace(model.config, n_layer=1), params=params)


def encoder_hidden(model, ids) -> "torch.Tensor":
    """The port's forward's hidden states (T, E) of ids on the card, f32."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    fwd = make_forward(model.config, with_hidden=True, fresh_prefill=True, head=False)
    with torch.inference_mode():
        return fwd(model.params, torch.tensor([ids], device="cuda"),
                   torch.arange(len(ids), device="cuda")[None],
                   init_cache(model.config, 1, max(len(ids), 8), torch.float32, "cuda"))[1][0]


def bge_f32_gate() -> dict:
    """bge-large-en-v1.5 at full width and depth in f32 with Q8_0 linears,
    layer by layer at each ENCODER_GATE_INPUTS input: the plain path
    (every packed product through quant_matmul_2d_plain, on the card) runs
    each layer on its own previous layer's output (encoder_layer_model,
    from the embeddings of a 0-layer forward) and feeds each product's
    input to the kernel too (within ARCH_GATE_TOL of the plain output's
    scale); the kernel path runs each layer on the same plain input, and
    its output must lie within ENCODER_GATE_TOL of the plain layer's scale.
    Whole forwards are no gate: both paths round each product's input to
    bf16, an input a last f32 bit apart can round apart, and 24 post-sum
    layers of random weights carry such a difference on; the two whole
    forwards' gap is printed."""
    import dataclasses

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    t0 = time.perf_counter()
    model = random_bert_q8(bge_large_config(), torch.float32, SEED + 111)
    L, V = model.config.n_layer, model.config.n_vocab
    kernel, plain = qm.quant_matmul_2d, qm.quant_matmul_2d_plain
    errs, rows = [], []

    def gate(x, qw, scales, *, kind):
        want = plain(x, qw, scales, kind=kind)
        errs.append(rel_gap(kernel(x, qw, scales, kind=kind), want))
        return want

    embed_only = LoadedModel(config=dataclasses.replace(model.config, n_layer=0), params={
        **model.params, "layers": {k: v[:0] for k, v in model.params["layers"].items()
                                   if not isinstance(v, qm.QuantTensor)}})
    for seed, n in ENCODER_GATE_INPUTS:
        ids = torch.randint(104, V, (n,), generator=torch.Generator().manual_seed(seed))
        ids = [101] + ids.tolist()[: n - 2] + [102] if n > 2 else ids.tolist()
        stream = encoder_hidden(embed_only, ids)
        gaps, n0 = [], kernel.launches
        gate.launches = 0
        for il in range(L):
            layer_ids = list(range(n))
            got = encoder_hidden(encoder_layer_model(model, il, stream), layer_ids)
            qm.quant_matmul_2d = gate
            try:
                want = encoder_hidden(encoder_layer_model(model, il, stream), layer_ids)
            finally:
                qm.quant_matmul_2d = kernel
            check(bool(torch.isfinite(got).all()), f"5v gate: non-finite states at layer {il}")
            gaps.append(rel_gap(got, want))
            stream = want
        check(gate.launches == kernel.launches - n0 == 6 * L,
              f"5v gate: {gate.launches} and {kernel.launches - n0} quant_matmul_2d launches, "
              f"want {6 * L} (6 a layer) each")
        final = rel_gap(encoder_hidden(model, ids), stream)
        rows.append({"seed": seed, "tokens": n, "worst_layer_rel_gap": max(gaps),
                     "worst_layer": gaps.index(max(gaps)), "whole_forward_rel_gap": final})
    worst_product, worst_layer = max(errs), max(r["worst_layer_rel_gap"] for r in rows)
    out = {"layers": L, "products": len(errs), "worst_product_rel_err": worst_product,
           "product_tol": ARCH_GATE_TOL, "worst_layer_rel_gap": worst_layer,
           "layer_tol": ENCODER_GATE_TOL, "inputs": rows, "seconds": time.perf_counter() - t0}
    print("phase 5v, f32 gate (bge-large-en-v1.5 widths and depth, Q8_0, layer by layer):",
          json.dumps(out))
    check(worst_product <= ARCH_GATE_TOL,
          f"5v gate: a packed product is {worst_product:.3e} of its scale off")
    check(worst_layer <= ENCODER_GATE_TOL,
          f"5v gate: a layer's hidden states are {worst_layer:.3e} of their scale off")
    del model
    torch.cuda.empty_cache()
    return out


def embed_bound(model, n: int) -> dict:
    """The least one n-token forward of a Q8_0 encoder takes: its packed
    weights read once (int8 values and f32 scales) against its products'
    and attention's bf16 operations (2 N a packed weight, 4 N^2 E a layer)."""
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    cfg, lay = model.config, model.params["layers"]
    packed = [t for t in lay.values() if isinstance(t, QuantTensor)]
    w_bytes = sum(t.q.numel() + t.s.numel() * 4 for t in packed)
    flops = 2 * n * sum(t.q.numel() for t in packed) + 4 * n * n * cfg.n_embd * cfg.n_layer
    ms, by = bound(w_bytes, flops, PEAK_BF16_FLOP_S)
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": w_bytes, "flops": flops}


def bge_embedder(model, gen) -> dict:
    """The Embedder (CLS pooling) over bge-large on its main path: each
    ENCODER_LENGTHS input embedded once with every launch count set to 0
    just before and read just after (quant_matmul_2d 144 times a forward,
    no other kernel), a profile of each length's forward (qmm_decode at N
    <= 4, qmm_prefill above, 144 a forward), and its wall ms (median of 7,
    host pooling included), device ms and bound."""
    import torch

    from sparkinfer_tpu_torch.runtime.embeddings import Embedder

    cfg = model.config
    per_fwd, V = 6 * cfg.n_layer, cfg.n_vocab
    emb = Embedder(model, max_seq=512, pooling="cls", device="cuda")
    inputs = {n: [101] + torch.randint(104, V, (n,), generator=gen).tolist()[: n - 2]
              + [102] if n > 2 else torch.randint(104, V, (n,), generator=gen).tolist()
              for n in ENCODER_LENGTHS}
    emb.embed_tokens([inputs[512]])  # warm
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    vecs = emb.embed_tokens([inputs[n] for n in ENCODER_LENGTHS])
    launches = {name: w.launches for name, w in wrappers.items()}
    want = per_fwd * len(ENCODER_LENGTHS)
    check(launches["quant_matmul_2d"] == want
          and sum(launches.values()) == want,
          f"5v: the Embedder launched {launches}, want quant_matmul_2d {want} alone")
    check(vecs.shape == (len(ENCODER_LENGTHS), cfg.n_embd) and np_isfinite(vecs),
          f"5v: CLS vectors of shape {vecs.shape}, or not finite")
    rows = []
    for n in ENCODER_LENGTHS:
        ids = inputs[n]
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb.embed_tokens([ids])
            times.append(1e3 * (time.perf_counter() - t0))
        prof, _ = profile_steps(f"{n}-token bge-large forwards", lambda: emb.hidden(ids), 2)
        qmm = [(k, ms, c) for k, ms, c in prof if "qmm_" in k]
        kind = "qmm_decode" if n <= 4 else "qmm_prefill"
        check(sum(c for _, _, c in qmm) == 2 * per_fwd and all(kind in k for k, _, _ in qmm),
              f"5v: a profiled {n}-token forward launched {qmm}, want {per_fwd} {kind} a "
              f"forward")
        row = {"tokens": n, "wall_ms": sorted(times)[3], "wall_ms_all": times,
               "device_ms": sum(ms for _, ms, _ in prof) / 2,
               "qmm_ms": sum(ms for _, ms, _ in qmm) / 2, "qmm_kernel": kind,
               "qmm_per_forward": sum(c for _, _, c in qmm) // 2, **embed_bound(model, n)}
        print("phase 5v, bge-large embedding:", json.dumps(row))
        rows.append(row)
    return {"launches": launches["quant_matmul_2d"], "rows": rows}


def np_isfinite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


def rank_bound(p, h) -> tuple[float, float]:
    """(the f64 head's score of hidden state h, the bound an f32 evaluation
    in any summation order keeps to it): each of the two products' E-term
    dot products within (E + 1) 2^-24 of its terms' sizes, tanh within two
    f32 ulps, the first product's error carried through tanh (slope <= 1)
    and the second's weights."""
    import numpy as np

    u = 2.0**-24
    w1, b1, w2, b2 = (p[k].double().cpu().numpy() for k in ("cls_w", "cls_b", "cls_out_w",
                                                            "cls_out_b"))
    E = len(h)
    pre = w1 @ h + b1
    t = np.tanh(pre)
    e1 = (E + 1) * u * (np.abs(w1) @ np.abs(h) + np.abs(b1)) + 2 * u * np.abs(t)
    score = float((w2 @ t + b2)[0])
    e2 = float((np.abs(w2) @ e1)[0] + (E + 1) * u * (np.abs(w2) @ np.abs(t) + np.abs(b2))[0])
    return score, e2


def bge_serving(model, gen) -> dict:
    """SparkServer over bge-large (one slot, max_seq 512, the Scheduler
    built and idle): /v1/embeddings of inputs of 16 to 510 tokens bit-equal
    to the Embedder called directly on each input, /v1/rerank's scores
    within rank_bound of the head in f64 over the first token's hidden
    state of a forward of its own, and a completion answered with the
    error that names the arch."""
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.embeddings import Embedder
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    cfg = model.config
    model.vocab = wpm_vocab(cfg.n_vocab, SEED + 116)
    srv = SparkServer(model, ServerConfig(port=0, n_slots=1, max_seq=512),
                      sampler=SamplerConfig(temp=0.0))
    try:
        srv.serve(block=False)
        texts = wpm_texts(model.vocab, gen, (16, 32, 64, 128, 256, 510))
        toks = [srv.tokenizer.encode(t, add_special=True) for t in texts]
        check([len(t) for t in toks] == [16, 32, 64, 128, 256, 510]
              and all(t[0] == 101 and t[-1] == 102 and 100 not in t for t in toks),
              f"5v: the WordPiece inputs tokenized to {[len(t) for t in toks]} tokens, or "
              "without [CLS] ... [SEP], or with [UNK]")
        r = http(srv.port, "/v1/embeddings", {"input": texts})
        vecs = [np.asarray(d["embedding"], np.float32) for d in r["body"]["data"]]
        emb = Embedder(model, max_seq=512, device="cuda")
        for i, ids in enumerate(toks):
            check(np.array_equal(vecs[i], emb.embed_tokens([ids])[0]),
                  f"5v: HTTP embedding {i} ({len(ids)} tokens) differs from the direct one")
        query, docs = texts[0], texts[:5]
        rr = http(srv.port, "/v1/rerank", {"query": query, "documents": docs})
        q_ids = srv.tokenizer.encode(query, add_special=False)
        fwd = make_forward(cfg, with_hidden=True, fresh_prefill=True, head=False)
        worst = 0.0
        for res in rr["body"]["results"]:
            ids = [101] + q_ids + [102] + srv.tokenizer.encode(
                docs[res["index"]], add_special=False) + [102]
            with torch.inference_mode():
                _, hid = fwd(model.params, torch.tensor([ids], device="cuda"),
                             torch.arange(len(ids), device="cuda")[None],
                             init_cache(cfg, 1, len(ids), torch.float32, "cuda"))
            want, tol = rank_bound(model.params, hid[0, 0].double().cpu().numpy())
            err = abs(res["relevance_score"] - want)
            check(err <= tol, f"5v: rerank score {res['relevance_score']} lies {err:.3e} from "
                              f"the f64 head's {want}, past its bound {tol:.3e}")
            worst = max(worst, err / tol)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": texts[0], "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            refused = None
        except urllib.error.HTTPError as e:
            refused = (e.code, json.loads(e.read())["error"])
        check(refused is not None and refused[0] == 400 and "'bert'" in refused[1],
              f"5v: a completion over bert was answered {refused}, want a 400 naming 'bert'")
        out = {"inputs": len(texts), "tokens": [len(t) for t in toks],
               "http_equal_direct": True, "documents": len(docs),
               "rerank_worst_err_of_bound": worst, "completion_refused": refused[1],
               "http_embeddings_e2e_ms": r["e2e_ms"], "http_rerank_e2e_ms": rr["e2e_ms"]}
    finally:
        srv.shutdown()
        model.vocab = None
    print("phase 5v, bge-large server:", json.dumps(out))
    return out


def embeddinggemma_config(L: int = 24):
    """google/embeddinggemma-300m's config.json: 24 layers, hidden 768, 3
    heads over 1 KV head of 256, FFN 1152 (geglu), vocab 262144, a sliding
    window of 512 on five layers of six (the band |key - query| <= 256 of
    the arch), rope theta 1e6 on its full layers and 10000 on its sliding
    ones, RMS eps 1e-6."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="gemma-embedding", n_layer=L, n_embd=768, n_head=3, n_head_kv=1,
                       head_dim=256, n_ff=1152, n_vocab=262144, norm_eps=1e-6,
                       rope_freq_base=1e6, rope_freq_base_swa=10000.0, sliding_window=512,
                       n_ctx_train=2048)


def neobert_config(L: int = 28):
    """chandar-lab/NeoBERT's config.json: 28 layers, hidden 768, 12 heads of
    64, vocab 30522, RMS eps 1e-5, rope theta 10000, a swiglu FFN whose
    intermediate_size 3072 the model takes as 2/3 of it, rounded up to a
    multiple of 8: 2048."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="neo-bert", n_layer=L, n_embd=768, n_head=12, n_head_kv=12,
                       head_dim=64, n_ff=2048, n_vocab=30522, norm_eps=1e-5,
                       rope_freq_base=10000.0, n_ctx_train=4096)


def encoder_extra(cfg):
    """gemma-embedding's per-head q/k norms and sandwich post-norms; neo-bert
    needs nothing past random_cut's llama tensors."""
    import torch

    def make(normal):
        if cfg.arch != "gemma-embedding":
            return {}
        L, E, D, f32 = cfg.n_layer, cfg.n_embd, cfg.head_dim, torch.float32
        return {"attn_q_norm_w": normal((L, D), 0.1, f32, 1.0),
                "attn_k_norm_w": normal((L, D), 0.1, f32, 1.0),
                "attn_post_norm_w": normal((L, E), 0.1, f32, 1.0),
                "ffn_post_norm_w": normal((L, E), 0.1, f32, 1.0)}

    return make


def bf16_encoder(label, cfg, seed, n_tokens) -> dict:
    """An encoder at full width and depth in bf16 (random_cut's draws), the
    Embedder's mean vectors of an n_tokens input: finite, its wall ms
    (median of 5) and device ms; for a windowed arch, the hidden states
    against the same weights without the window, which the band must move;
    then a 2-layer f32 cut of the same widths, the card's hidden states
    against the CPU's within 1e-4 of their scale."""
    import dataclasses

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.runtime.embeddings import Embedder

    model = random_cut(cfg, seed, encoder_extra(cfg))
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(cfg.n_vocab, (n_tokens,), generator=gen).tolist()
    emb = Embedder(model, max_seq=4096, device="cuda")
    vec = emb.embed_tokens([ids])
    check(vec.shape == (1, cfg.n_embd) and np_isfinite(vec),
          f"5v {label}: a vector of shape {vec.shape}, or not finite")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb.embed_tokens([ids])
        times.append(1e3 * (time.perf_counter() - t0))
    prof, _ = profile_steps(f"{n_tokens}-token {label} forwards", lambda: emb.hidden(ids), 2)
    row = {"arch": cfg.arch, "layers": cfg.n_layer, "tokens": n_tokens,
           "wall_ms": sorted(times)[2], "device_ms": sum(ms for _, ms, _ in prof) / 2}
    if cfg.sliding_window:
        unbanded = LoadedModel(config=dataclasses.replace(cfg, sliding_window=0),
                               params=model.params)
        gap = rel_gap(torch.from_numpy(Embedder(unbanded, max_seq=4096, device="cuda")
                                       .hidden(ids)), torch.from_numpy(emb.hidden(ids)))
        check(gap > 1e-2, f"5v {label}: the symmetric band moved the hidden states by "
                          f"{gap:.3e} of their scale only")
        row["band_moved_rel"] = gap
    del model, emb
    torch.cuda.empty_cache()
    cut = random_cut(dataclasses.replace(cfg, n_layer=2), seed + 1,
                     encoder_extra(dataclasses.replace(cfg, n_layer=2)))
    f32 = {k: (v.float() if torch.is_floating_point(v) else v)
           for k, v in cut.params.items() if k != "layers"}
    f32["layers"] = {k: v.float() for k, v in cut.params["layers"].items()}
    small = ids[:min(n_tokens, 300)]
    card = Embedder(LoadedModel(config=cut.config, params=f32), device="cuda",
                    max_seq=4096).hidden(small)
    host = Embedder(LoadedModel(config=cut.config, params=to_device(f32, "cpu")), device="cpu",
                    max_seq=4096).hidden(small)
    gap = rel_gap(torch.from_numpy(card), torch.from_numpy(host))
    check(gap <= 1e-4, f"5v {label}: the 2-layer f32 cut on the card is {gap:.3e} of its scale "
                       "from the CPU's")
    row.update(f32_cut_tokens=len(small), f32_cut_card_vs_cpu=gap)
    print(f"phase 5v, {label}:", json.dumps(row))
    del cut, f32
    torch.cuda.empty_cache()
    return row


def trait_cut_configs() -> dict:
    """The 15g trait archs at their config.json widths (as recalled), cut to
    2 layers; the multipliers and windows as the JAX converter writes them.
    pangu-embedded's is a stack of synthetic widths (not a published
    config)."""
    from sparkinfer_tpu_torch.models.config import ModelConfig

    def cfg(arch, E, H, Hkv, D, F, V, **kw):
        return ModelConfig(arch=arch, n_layer=2, n_embd=E, n_head=H, n_head_kv=Hkv,
                           head_dim=D, n_ff=F, n_vocab=V, **kw)

    return {
        # ibm-granite/granite-3.1-8b-instruct: 40 layers, the four multipliers, tied
        "granite": cfg("granite", 4096, 32, 8, 128, 12800, 49155, norm_eps=1e-5,
                       rope_freq_base=1e7, n_ctx_train=131072, embd_scale=12.0,
                       residual_scale=0.22, attn_scale=0.0078125, logit_scale=1 / 16),
        # openbmb/MiniCPM-2B: 40 layers, scale_emb 12, scale_depth 1.4, dim_model_base 256, tied
        "minicpm": cfg("minicpm", 2304, 36, 36, 64, 5760, 122753, norm_eps=1e-5,
                       n_ctx_train=4096, embd_scale=12.0, residual_scale=1.4 / 40 ** 0.5,
                       logit_scale=256 / 2304),
        # bigcode/starcoder2-7b: 32 layers, biases, the ungated gelu, window 4096
        "starcoder2": cfg("starcoder2", 4608, 36, 4, 128, 18432, 49152, norm_eps=1e-5,
                          rope_freq_base=1e6, n_ctx_train=16384, sliding_window=4096),
        # CohereForAI/c4ai-command-r-v01: 40 layers, one bias-less LayerNorm a block, tied
        "command-r": cfg("command-r", 8192, 64, 64, 128, 22528, 256000, norm_eps=1e-5,
                         rope_freq_base=8e6, n_ctx_train=131072, logit_scale=0.0625),
        # microsoft/Phi-3-mini-4k-instruct: 32 layers, window 2047
        "phi3": cfg("phi3", 3072, 32, 32, 96, 8192, 32064, norm_eps=1e-5, n_ctx_train=4096,
                    sliding_window=2047),
        # pfnet/plamo-13b: 40 layers, 40 heads sharing 5 KV heads (n_shared_head 8)
        "plamo": cfg("plamo", 5120, 40, 5, 128, 13824, 50432, norm_eps=1e-6,
                     n_ctx_train=4096),
        # pangu-embedded: synthetic widths, not a published config
        "pangu-embedded": cfg("pangu-embedded", 4096, 32, 8, 128, 12800, 153600,
                              norm_eps=1e-5, n_ctx_train=32768),
    }


def trait_cuts(greedy) -> list:
    """Each trait_cut_configs cut in bf16, graph against eager (streams equal,
    first decode logits bit-equal), a 32-token prompt and 64 tokens, every
    stream decoded in full: granite's multipliers, minicpm's, starcoder2's
    LayerNorm and FFN biases without a gate, command-r's and plamo's
    parallel blocks (no FFN norm; command-r's LayerNorm without biases),
    phi3's split projections under its window, pangu-embedded's q/k/v and
    output biases; granite, minicpm and command-r tie their heads."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine

    f32 = torch.float32

    def extra(name, cfg):
        H, Hkv, D, E, F = cfg.n_head, cfg.n_head_kv, cfg.head_dim, cfg.n_embd, cfg.n_ff

        def make(normal):
            if name in ("starcoder2", "pangu-embedded"):
                out = {"bq": normal((2, H * D), 0.1, f32), "bk": normal((2, Hkv * D), 0.1, f32),
                       "bv": normal((2, Hkv * D), 0.1, f32), "bo": normal((2, E), 0.1, f32)}
                if name == "starcoder2":
                    out.update(attn_norm_b=normal((2, E), 0.1, f32),
                               ffn_norm_b=normal((2, E), 0.1, f32),
                               b_up=normal((2, F), 0.1, f32), b_down=normal((2, E), 0.1, f32))
                return out
            return {}

        return make

    gen = torch.Generator().manual_seed(SEED + 120)
    out = []
    for i, (name, cfg) in enumerate(trait_cut_configs().items()):
        model = random_cut(cfg, SEED + 121 + i, extra(name, cfg))
        p = model.params
        if name == "starcoder2":  # the ungated FFN
            p["layers"].pop("w_gate")
        if name in ("command-r", "plamo"):  # one pre-norm under the parallel block
            p["layers"].pop("ffn_norm_w")
        if name == "command-r":  # a LayerNorm without biases
            p.pop("output_norm_b")
        if name in ("granite", "minicpm", "command-r"):  # tied heads
            p["output"] = p["tok_embd"].T.contiguous()
        prompt = torch.randint(cfg.n_vocab, (32,), generator=gen).tolist()
        kw = dict(max_seq=1024, sampler=greedy, device="cuda")
        row = graph_vs_eager(f"{name} cut", Engine(model, **kw),
                             Engine(model, cuda_graph=False, **kw), prompt, 64)
        out.append({"arch": name, **{k: row[k] for k in ("replay_span_ms", "wall_speedup")},
                    "graph_tok_s": row["graph"]["tok_s"], "eager_tok_s": row["eager"]["tok_s"]})
        del model, p
        torch.cuda.empty_cache()
    return out


def phase_encoders(greedy) -> dict:
    """Phase 5v: bge-large-en-v1.5 Q8_0 at full width and depth (the f32
    gate, the Embedder's main path and timings, quant_matmul_2d at its three
    shapes, N = 1, 32 and 512, the server's routes), EmbeddingGemma and
    NeoBERT in bf16, then the 15g trait cuts. Returns its summary, with
    quant_matmul_2d's main-path launches."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    print(f"phase 5v: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free at its start")
    t0 = time.perf_counter()
    gate = bge_f32_gate()
    mark("phase 5v, f32 gate")
    cfg = bge_large_config()
    t1 = time.perf_counter()
    model = random_bert_q8(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    packed = embed_bound(model, 0)["weight_bytes"]
    print(f"model: bge-large-en-v1.5 widths, L={cfg.n_layer} E={cfg.n_embd} H={cfg.n_head} "
          f"D={cfg.head_dim} F={cfg.n_ff} V={cfg.n_vocab}, 512 positions, post-sum "
          f"LayerNorms, Q8_0 attention/FFN ({packed} bytes packed with f32 scales), built in "
          f"{time.perf_counter() - t1:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated")
    gen = torch.Generator().manual_seed(SEED + 117)
    embed = bge_embedder(model, gen)
    mark("phase 5v, bge-large Embedder")
    rows = q8_qmm_rows(model, ("wq", "w_up", "w_down"), SEED + 118, per_call=1,
                       Ns=(1, 32, 512))
    serving = bge_serving(model, gen)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5v, quant_matmul_2d at the bge-large shapes and the server")
    gemma = bf16_encoder("EmbeddingGemma-300m", embeddinggemma_config(), SEED + 130, 600)
    neobert = bf16_encoder("NeoBERT", neobert_config(), SEED + 131, 512)
    mark("phase 5v, EmbeddingGemma and NeoBERT")
    cuts = trait_cuts(greedy)
    mark("phase 5v, the 15g trait cuts")
    return {"f32_gate": gate, "embed": embed, "rows": rows, "serving": serving,
            "encoders": [gemma, neobert], "cuts": cuts, "packed_bytes": packed,
            "qmm_launches": embed["launches"], "seconds": time.perf_counter() - t0}


def encoders_summary(g) -> dict:
    """Phase 5v's numbers in brief, for the end of the full run's output."""
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")
    return {"f32_gate": {k: g["f32_gate"][k] for k in (
                "worst_product_rel_err", "product_tol", "worst_layer_rel_gap", "layer_tol")},
            "bge_large_qmm": [{"shape": r["shape"], **{k: r[k] for k in keys}}
                              for r in g["rows"]],
            "bge_large_embed": [{k: r[k] for k in ("tokens", "wall_ms", "device_ms", "qmm_ms",
                                                   "qmm_kernel", "bound_ms", "bound_by")}
                                for r in g["embed"]["rows"]],
            "serving": {k: g["serving"][k] for k in (
                "http_equal_direct", "rerank_worst_err_of_bound", "completion_refused",
                "http_embeddings_e2e_ms", "http_rerank_e2e_ms")},
            "encoders": g["encoders"], "cuts": g["cuts"], "packed_bytes": g["packed_bytes"],
            "qmm_launches": g["qmm_launches"], "seconds": g["seconds"]}


def phase_child(tag, flag) -> dict:
    """Phase `tag` in a child process (`chip_smoke.py flag`), started before
    this process builds any model: its output is passed through, its
    summary read from its last line."""
    proc = subprocess.Popen([sys.executable, __file__, flag], stdout=subprocess.PIPE, text=True)
    last = None
    prefix = f"phase {tag} summary: "
    for line in proc.stdout:
        print(line, end="", flush=True)
        if line.startswith(prefix):
            last = line
    check(proc.wait(timeout=900) == 0 and last is not None,
          f"phase {tag}: the child process exited with {proc.returncode}")
    return json.loads(last[len(prefix):])


def kernel_line(name, source, replaces, launches, row, shape):
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: row[k] for k in keys}, "shape": shape}


def child_phase(tag, phase) -> int:
    """`chip_smoke.py --moe-phase` (5k), `--swa-phase` (5o), `--mla-phase`
    (5p) or `--archs-phase` (5q): the phase alone, in the child process the
    full run starts (the kernels built already); its summary is the last
    line."""
    import torch

    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase {tag} summary:", json.dumps(phase(SamplerConfig(temp=0.0))))
    return 0


SEVEN_B_KEYS = ("v6_row", "v6_shapes", "l7", "h5", "ratios", "row_rows", "row_per_call", "l_v1",
                "runtime", "kvq", "v7u_row", "l_v7u", "crossover", "batched", "l_srv", "srv7",
                "mask_ms", "emb", "l_v2", "tier_gate", "tier_rows", "tier_sched", "dense_peak",
                "tier_v6")


def seven_b_paths(greedy, prompt, n_new, L: int = 32) -> dict:
    """Phases 4a, 4c-4e, 5b, 5e-5j, 5l, 5m(c) and 5r over the
    ProSparse-Llama-2-7B-width bf16 model at depth L (32; the full run takes
    FULL_RUN_7B_L): its sparse and dense engines, the Scheduler, the
    runtime and the CLI, the int8 cache, v7u and batched decode, the
    server and embeddings, sparkinfer-bench and tiering. Returns the values
    SEVEN_B_KEYS names, which the `kernels` line and the summaries read."""
    import pathlib
    import tempfile

    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6,
        sparse_ffn_block_v6_plain,
    )
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    # 5a. the 7B-width bf16 model and its sparse engine (its flat stores serve phase 4)
    cfg = prosparse_config(L, 4096, 32, 11008, 32000, 1024)
    scfg = SparseConfig(group_size=128, capacity_groups=12)  # 12 of 86 groups, 12.5%
    t0 = time.perf_counter()
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    sparse_eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, device="cuda")
    torch.cuda.synchronize()
    print(f"model: ProSparse-Llama-2-7B widths, L={cfg.n_layer} E={cfg.n_embd} "
          f"F={cfg.n_ff} V={cfg.n_vocab} R={cfg.max_pred_rank}, bf16, built with "
          f"sparse stores in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # 4a. v6 against its plain version
    v6_row, v6_shapes = phase_v6(sparse_ffn_block_v6, sparse_ffn_block_v6_plain,
                                 sparse_eng.params["sparse_flat"], cfg.n_layer,
                                 scfg.n_groups(cfg.n_ff))

    # 5b. the 7B main path
    L = cfg.n_layer
    l7 = main_path("7B bf16 sparse", sparse_eng, prompt, n_new,
                       lambda steps: {"sparse_ffn_block_v6": L * steps})
    mark("phase 4a, 5b")
    # 5h. graph against eager: the sparse engine and an eager one over its
    # prepared stores, then the dense engines on the same weights
    h5 = [graph_vs_eager("7B bf16 sparse", sparse_eng, Engine(
        LoadedModel(config=cfg, params=sparse_eng.params), max_seq=1024, sampler=greedy,
        sparse=scfg, sparse_preprepared=True, device="cuda", cuda_graph=False), prompt, n_new)]
    rows7, steps7 = PROFILES["7B bf16 sparse"]
    v6_prof = [(k, ms, n) for k, ms, n in rows7 if "v6_ffn" in k]
    # the f32 copies: torch's casting copies (direct_copy_kernel_cuda)
    copies = [(k, ms, n) for k, ms, n in rows7 if "direct_copy_kernel" in k]
    print("profile: v6 in a 7B bf16 sparse step:", json.dumps({
        "device_ms": sum(ms for _, ms, _ in v6_prof) / steps7,
        "launches": sum(n for _, _, n in v6_prof) // steps7,
        "f32_copies": {"device_ms": sum(ms for _, ms, _ in copies) / steps7,
                       "launches": sum(n for _, _, n in copies) // steps7}}))
    check(sum(n for _, _, n in v6_prof) == L * steps7,
          f"the profiled 7B step launched {v6_prof} v6 kernels, want {L} a step")
    h5.append(graph_vs_eager(
        "7B bf16 dense", Engine(model, max_seq=1024, sampler=greedy, device="cuda"),
        Engine(model, max_seq=1024, sampler=greedy, device="cuda", cuda_graph=False),
        prompt, n_new))
    ratios = [sparse_dense_ratio("7B bf16", *h5[-2:])]
    torch.cuda.empty_cache()
    mark("7B engine path")

    # 5e. the Scheduler at 7B widths (its row stores serve phase 4c)
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_batch_max=4, device="cuda")
    row_rows, row_per_call = phase_rows(sched.params["layers"], scfg.capacity(cfg.n_ff))
    gen = torch.Generator().manual_seed(SEED + 11)
    prompts = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    l_v1 = scheduler_path(sched, prompts, 32)
    mark("phases 4c, 5e")
    # 5h. the tick, graph against eager, on requests whose prompts no slot
    # holds (a reused prefix would prefill another way than a fresh slot)
    prompts_h = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    h5.append(scheduler_graph_vs_eager(sched, Scheduler(
        model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg, sparse_batch_max=4,
        device="cuda", cuda_graph=False), prompts_h, 32))
    torch.cuda.empty_cache()
    mark("phase 5h, the Scheduler")
    # 5l. the single-sequence runtime (sampler chain, context shift,
    # self-extend, sparse prefill, drafters, slot files, LoRA) and the CLI
    runtime = phase_runtime(model, scfg, sparse_eng, sched, prompt)
    torch.cuda.empty_cache()
    mark("phase 5l")
    # 5r. the int8 and split-dtype KV caches over the same stores
    with tempfile.TemporaryDirectory() as tmp:
        kvq = phase_kvq(model, sparse_eng, sched, scfg, greedy, prompt, pathlib.Path(tmp))
    torch.cuda.empty_cache()

    # 4d, 5f. v7u, and batched decode of every decode path at B = 1, 2, 4, 8 (the ticks at 16)
    v7u_row = phase_v7u(sparse_eng.params["sparse_flat"], L, scfg.n_groups(cfg.n_ff))
    mark("phase 4d")
    l_v7u, crossover, batched = phase_batched(cfg, scfg, model.params, sparse_eng.params,
                                              sched.params)
    del sparse_eng, sched
    torch.cuda.empty_cache()
    mark("phase 5f")

    # 5i. the server over the Scheduler at 7B widths (its own row stores)
    torch.cuda.reset_peak_memory_stats()
    l_srv, srv7, mask_ms = phase_server(model, scfg)
    print(f"phase 5i, 7B server peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    # 5m(c). /v1/embeddings and /v1/rerank over HTTP on the same model
    mark("phase 5i, 7B server")
    emb = phase_embeddings(model)
    torch.cuda.empty_cache()
    mark("phase 5m(c)")

    # 5g, 4e. sparkinfer-bench's decode: dense, v1 and v2 (SPIF_KERNEL_V2),
    # then v2 against its plain version over the bench path's store
    l_v2 = phase_bench(model, scfg)
    row_rows["sparse_ffn_block_v2"] = phase_v2(model, scfg, scfg.capacity(cfg.n_ff),
                                               row_per_call)
    del model
    torch.cuda.empty_cache()
    mark("phases 5g, 4e")
    # 5j. tiering: the f32 gate, then the 7B tiered engines and Scheduler on
    # a fresh copy of the model (the same seed) that nothing else holds, so
    # that the Scheduler's taking its dense FFN frees the card's memory
    tier_gate = tier_f32_gate()
    mark("phase 5j, f32 gate")
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    tier_rows, tier_sched, dense_peak, tier_v6 = phase_tiered_7b(model, greedy, prompt, n_new)
    del model
    torch.cuda.empty_cache()
    mark("7B paths")

    out = locals()
    return {k: out[k] for k in SEVEN_B_KEYS}


def seven_b_paths_only(greedy) -> int:
    """`chip_smoke.py --7b-paths`: seven_b_paths at all 32 layers alone
    (after phases 1 and 2), with the summaries of the phases it runs."""
    import torch

    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    s7 = seven_b_paths(greedy, prompt, 64, 32)
    print("phase 5h summary (7B):", json.dumps({"graph_vs_eager": [
        {"path": r["path"], **{f"{k}_{m}": r[k][m] for k in ("graph", "eager")
                               for m in r["graph"]}} for r in s7["h5"]],
        "sparse_dense": s7["ratios"]}))
    print("phase 5i summary (7B):", json.dumps({
        "crossover": s7["crossover"], "server_7b": {k: s7["srv7"][k] for k in SERVER_KEYS},
        "server_7b_v1_launches": s7["l_srv"], "grammar_mask_ms_per_tick": s7["mask_ms"]}))
    print("phase 5l summary:", json.dumps(runtime_summary(s7["runtime"])))
    print("phase 5m(c) summary:", json.dumps(s7["emb"]))
    print("phase 5r summary:", json.dumps(kvq_summary(s7["kvq"])))
    print("7B launches:", json.dumps({"sparse_ffn_block_v6": s7["l7"]["sparse_ffn_block_v6"],
                                      "sparse_ffn_block": s7["l_v1"],
                                      "sparse_ffn_block_v7u": s7["l_v7u"],
                                      "sparse_ffn_block_v2": s7["l_v2"]}))
    print(f"total {time.perf_counter() - START[0]:.1f} s")
    return 0


def main(only: str | None = None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from sparkinfer_tpu_torch import native
    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops import _build
    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6,
        sparse_ffn_block_v6_plain,
    )
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = START[0] = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build, every source at once (and the tiered FFN's host library)
    t0 = time.perf_counter()
    native.library()
    print(f"build: the host library (csrc/spark_host.cpp, g++) in "
          f"{time.perf_counter() - t0:.2f} s; _Float16 {native.has_f16()}, "
          f"{native.num_threads()} threads")
    if only == "tiered":
        return tiered_phases(greedy_cfg=SamplerConfig(temp=0.0))
    for name, (lib, secs, log) in _build.build_all(
            ["sparse_ffn_v6", "sparse_ffn_v6q", "quant_matmul", "sparse_ffn_v1",
             "sparse_ffn_v7u"]).items():
        if not log:
            print(f"build: {name} -> {lib.name} was already built")
            continue
        print(f"build: {name} -> {lib.name} in {secs:.2f} s; ptxas:")
        print("\n".join("  " + ln for ln in log.splitlines() if "ptxas info" in ln
                        and ("Used" in ln or "entry" in ln)))

    greedy = SamplerConfig(temp=0.0)
    if only == "moe":
        print("phase 5k summary:", json.dumps(phase_moe(greedy)))
        return 0
    if only == "runtime":
        return runtime_phase_only(greedy)
    if only == "quant":
        return quant_phases(greedy)
    if only == "families":
        return families_only(greedy)
    if only == "swa":
        print("phase 5o summary:", json.dumps(swa_summary(phase_swa(greedy))))
        return 0
    if only == "mla":
        print("phase 5p summary:", json.dumps(mla_summary(phase_mla(greedy))))
        return 0
    if only == "archs":
        print("phase 5q summary:", json.dumps(archs_summary(phase_archs(greedy))))
        return 0
    if only == "mla_archs":
        print("phase 5s summary:", json.dumps(mla_archs_summary(phase_mla_archs(greedy))))
        return 0
    if only == "gpt_archs":
        print("phase 5t summary:", json.dumps(gpt_archs_summary(phase_gpt_archs(greedy))))
        return 0
    if only == "feature_archs":
        print("phase 5u summary:", json.dumps(feature_archs_summary(phase_feature_archs(greedy))))
        return 0
    if only == "kvq":
        return kvq_only(greedy)
    if only == "encoders":
        print("phase 5v summary:", json.dumps(encoders_summary(phase_encoders(greedy))))
        return 0
    if only == "7b_paths":
        return seven_b_paths_only(greedy)
    # 5k. Qwen3-30B-A3B (61 GB of bf16 weights) in a child process, before
    # this process builds any model; then 5o, gpt-oss-20b (42 GB), 5p,
    # DeepSeek-V2-Lite (31 GB), and 5q, Qwen3-8B Q8_0 (8.5 GB) then
    # Qwen1.5-MoE-A2.7B (28.6 GB), likewise
    moe = phase_child("5k", "--moe-phase")
    mark("phase 5k")
    swa = phase_child("5o", "--swa-phase")
    mark("phase 5o")
    mla = phase_child("5p", "--mla-phase")
    mark("phase 5p")
    archs = phase_child("5q", "--archs-phase")
    mark("phase 5q")
    mla_archs = phase_child("5s", "--mla-archs-phase")
    mark("phase 5s")
    gpt_archs = phase_child("5t", "--gpt-archs-phase")
    mark("phase 5t")
    feature_archs = phase_child("5u", "--feature-archs-phase")
    mark("phase 5u")
    encoders = phase_child("5v", "--encoders-phase")
    mark("phase 5v")

    # 3. f32 references on small inputs: kernel path == plain path
    phase_reference(SparseConfig, Engine, greedy)
    phase_serving_reference(SparseConfig, greedy)
    phase_bench_reference(SparseConfig)
    mark("phases 1-3")

    n_new = 64
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()

    s7 = seven_b_paths(greedy, prompt, n_new, FULL_RUN_7B_L)
    (v6_row, v6_shapes, l7, h5, ratios, row_rows, row_per_call, l_v1, runtime, kvq, v7u_row,
     l_v7u, crossover, batched, l_srv, srv7, mask_ms, emb, l_v2, tier_gate, tier_rows,
     tier_sched, dense_peak, tier_v6) = (s7[k] for k in SEVEN_B_KEYS)

    # 5c. the 13B-width Q8_0 model, made and quantized on the card
    cfg, scfg, weights, model, sparse_eng = q8_13b_engine(greedy, FULL_RUN_13B_L)
    ng, C = scfg.n_groups(cfg.n_ff), scfg.capacity(cfg.n_ff)

    # 4b. v6q and the quant matmuls against their plain versions
    v6q_row = phase_v6q(model.params["sparse_flat"], cfg.n_layer, ng, C)
    q2d_row, qflat_row = phase_quant_matmul(model.params)
    mark("phases 5c, 4b")

    # 5d. the 13B Q8_0 main path: per decode step v6q L, quant_matmul_2d
    # 4L+1 (wq, wk, wv, wo, head) and quant_matmul_flat 2(L+1) (the next
    # layer's predictor in every layer, layer 0's own); the prefill adds
    # 4L+1 and 2L (the masked-dense FFN's predictor)
    L = cfg.n_layer

    def want13(steps):
        return {"sparse_ffn_block_v6q": L * steps,
                "quant_matmul_2d": (4 * L + 1) * (steps + 1),
                "quant_matmul_flat": 2 * (L + 1) * steps + 2 * L}

    l13 = main_path("13B Q8_0 sparse", sparse_eng, prompt, n_new, want13)
    mark("phase 5d")
    h5.append(graph_vs_eager("13B Q8_0 sparse", sparse_eng, Engine(
        model, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
        device="cuda", cuda_graph=False), prompt, n_new))
    rows13, steps13 = PROFILES["13B Q8_0 sparse"]
    v6q_prof = [(k, ms, n) for k, ms, n in rows13 if "v6q_" in k]
    qmm_prof = [(k, ms, n) for k, ms, n in rows13 if "qmm_" in k]
    print("profile: v6q and quant_matmul in a 13B Q8_0 sparse step:", json.dumps({
        "device_ms": sum(ms for _, ms, _ in v6q_prof) / steps13,
        "launches": sum(n for _, _, n in v6q_prof) // steps13,
        "kernels": {k[:60]: [ms / steps13, n // steps13] for k, ms, n in v6q_prof + qmm_prof}}))
    check(sum(n for _, _, n in v6q_prof) == 2 * L * steps13,
          f"the profiled 13B step launched {v6q_prof} v6q kernels, want 2 x {L} a step")
    # quant_matmul_2d 4L + 1 and quant_matmul_flat 2(L + 1) a step, qmm_decode each
    check(sum(n for _, _, n in qmm_prof) == (6 * L + 3) * steps13
          and all("qmm_decode" in k for k, _, _ in qmm_prof),
          f"the profiled 13B step launched {qmm_prof}, want {6 * L + 3} qmm_decode a step")
    profile_prefill(sparse_eng, prompt)
    q8_logits = prefill_logits(sparse_eng, prompt)
    del sparse_eng
    mark("phase 5h, 13B Q8_0 sparse")
    # 5m(a). the JAX bench's headline row: W8A8 attention and predictor
    # stacks over the Q8_0 flat FFN stores and head of the same draws
    w8_attn, w8_pred, w8_row, l_w8 = phase_w8a8_13b(cfg, scfg, weights, model, greedy,
                                                    prompt, n_new, rows13, steps13, q8_logits)
    # 5j, 5m(a). the 13B tiered fetch path, with the model's Q8_0 attention,
    # head and predictor stacks, then with the W8A8 ones; its flat FFN
    # stores leave the card first
    mark("phase 5m(a), untiered")
    for k in [k for k in model.params["sparse_flat"] if not k.startswith("pred_")]:
        del model.params["sparse_flat"][k]
    torch.cuda.empty_cache()
    tier13, l_tier13 = phase_tiered_13b(cfg, scfg, weights, model, prompt, n_new,
                                        w8a8=(w8_attn, w8_pred))
    del w8_attn, w8_pred
    torch.cuda.empty_cache()
    mark("phases 5j, 5m(a), 13B tiered")
    dense_params = dict(model.params)
    dense_params.pop("sparse_flat")
    dense_params["layers"] = dict(model.params["layers"], **weights.dense_ffn())
    del model
    torch.cuda.empty_cache()
    dense = LoadedModel(config=cfg, params=dense_params)
    h5.append(graph_vs_eager(
        "13B Q8_0 dense", Engine(dense, max_seq=1024, sampler=greedy, device="cuda"),
        Engine(dense, max_seq=1024, sampler=greedy, device="cuda", cuda_graph=False),
        prompt, n_new))
    ratios.append(sparse_dense_ratio("13B Q8_0", h5[-2], h5[-1]))
    mark("phase 5h, 13B Q8_0 dense")
    # 5i. the Q8_0 server over the dense Scheduler, then the entry point
    l_srv_q8, srv13 = phase_server_q8(cfg, dense)
    del dense, dense_params
    torch.cuda.empty_cache()
    mark("13B path")
    # 5m(b). a K-quant GGUF at 7B widths through load_model and v6
    kq = phase_kquant(greedy, prompt)
    mark("phase 5m")
    entry = phase_entry_point()
    mark("phase 5i, entry point")
    # 5n. the paper's other sparse families: ReluFalcon-40B at full width,
    # OPT-6.7B and Qwen2-7B widths cut to 4 layers
    fam = phase_families(greedy, layers=FULL_RUN_FAMILY_L)
    mark("phase 5n")
    fl = fam["launches"]

    def fam_rows(*keys):  # the kernel's rows at 5n's shapes, by shape
        return {"families": {fam["rows"][k]["shape"]: {f: fam["rows"][k][f] for f in (
            "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for k in keys}}

    out = {"kernels": [
        {**kernel_line("sparse_ffn_block_v6", "sparkinfer_tpu_torch/csrc/sparse_ffn_v6.cu",
                       "sparkinfer_tpu/ops/sparse_ffn_pallas.py:564",
                       l7["sparse_ffn_block_v6"] + tier_v6 + runtime["v6_launches"]
                       + kq["v6_launches"] + fl["sparse_ffn_block_v6"] + kvq["v6_launches"],
                       v6_row,
                       "N=1 C=12 G=128 E=4096 bf16 fatrelu"),
         **fam_rows("v6 falcon40b", "v6 opt6.7b", "v6 qwen2-7b"),
         # the speculative verify (N = K+1) and the 32-token sparse prefill
         "shapes": {k: {f: r[f] for f in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
                    for k, r in v6_shapes.items()}},
        {**kernel_line("sparse_ffn_block_v6q", "sparkinfer_tpu_torch/csrc/sparse_ffn_v6q.cu",
                       "sparkinfer_tpu/ops/sparse_ffn_pallas.py:706",
                       l13["sparse_ffn_block_v6q"] + l_tier13["sparse_ffn_block_v6q"]
                       + l_w8["sparse_ffn_block_v6q"] + fl["sparse_ffn_block_v6q"],
                       v6q_row, "N=1 C=16 G=128 E=5120 q8_0 fatrelu"),
         **fam_rows("v6q falcon40b")},
        {**kernel_line("quant_matmul_2d", "sparkinfer_tpu_torch/csrc/quant_matmul.cu",
                       "sparkinfer_tpu/ops/quant_matmul.py:149",
                       l13["quant_matmul_2d"] + l_tier13["quant_matmul_2d"]
                       + l_w8["quant_matmul_2d"] + fl["quant_matmul_2d"]
                       + archs["qmm_launches"] + mla_archs["qmm_launches"]
                       + gpt_archs["qmm_launches"] + feature_archs["qmm_launches"]
                       + encoders["qmm_launches"], q2d_row, q2d_row["shape"]),
         **fam_rows("qmm head"),
         **{name: {"launches": a["qmm_launches"],
                   "shapes": {r["shape"]: {f: r[f] for f in (
                       "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")} for r in rows}}
            for name, a, rows in (("qwen3_8b", archs, archs["qwen3_8b"]["rows"]),
                                  ("minicpm3_4b", mla_archs, mla_archs["rows"]),
                                  ("bloom_7b1", gpt_archs, gpt_archs["rows"]),
                                  ("olmo2_7b", feature_archs, feature_archs["rows"]),
                                  ("bge_large", encoders, encoders["rows"]))}},
        {**kernel_line("quant_matmul_flat", "sparkinfer_tpu_torch/csrc/quant_matmul.cu",
                       "sparkinfer_tpu/ops/quant_matmul.py:243",
                       l13["quant_matmul_flat"] + l_tier13["quant_matmul_flat"]
                       + fl["quant_matmul_flat"], qflat_row, qflat_row["shape"]),
         **fam_rows("qmm pred_up_qt", "qmm pred_down_qt")},
        {**kernel_line("sparse_ffn_block", "sparkinfer_tpu_torch/csrc/sparse_ffn_v1.cu",
                       "sparkinfer_tpu/ops/sparse_ffn_pallas.py:124",
                       l_v1 + moe["v1_launches"] + fl["sparse_ffn_block"]
                       + swa["v1_launches"] + mla["v1_launches"] + archs["v1_launches"]
                       + kvq["v1_launches"],
                       row_rows["sparse_ffn_block"],
                       "N=1 C=12 G=128 E=4096 bf16 fatrelu, row stores"),
         **fam_rows("v1 falcon40b"),
         "moe": {"launches": moe["v1_launches"],
                 **{k: moe["v1_moe"][0][k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                                     "bound_ms", "bound_by")},
                 "shape": "N=1 C=48 G=128 E=2048 bf16 silu, scale = router weights"},
         "gpt_oss": {"launches": swa["v1_launches"],
                     **{k: swa["v1_gpt_oss"][0][k] for k in (
                         "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")},
                     "shape": "N=1 C=180 G=64 E=2880 bf16 swiglu_oai, up and gate biases, "
                              "scale = router weights"},
         "deepseek_v2_lite": {"launches": mla["v1_launches"],
                              **{k: mla["v1_deepseek_v2_lite"][0][k] for k in (
                                  "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
                              "shape": "N=1 C=66 G=128 E=2048 bf16 silu, scale = routed "
                                       "weights"},
         "qwen15_moe": {"launches": archs["v1_launches"],
                        **{k: archs["qwen15_moe"]["v1_rows"][0][k] for k in (
                            "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")},
                        "shape": "N=1 C=44 G=128 E=2048 bf16 silu, scale = routed weights"}},
        # v2 runs on the bench path (SPIF_KERNEL_V2); v3, v4 and v5 on no
        # path of the package (only its TPU probes call them)
        *(kernel_line(name, "sparkinfer_tpu_torch/csrc/sparse_ffn_v1.cu",
                      f"sparkinfer_tpu/ops/sparse_ffn_pallas.py:{line}",
                      l_v2 if name == "sparse_ffn_block_v2" else 0, row_rows[name],
                      f"N=1 C=12 G=128 E=4096 bf16 fatrelu + up bias, {store}")
          for name, line, store in (
              ("sparse_ffn_block_v2", 1044, "concatenated store"),
              ("sparse_ffn_block_v3", 306, "row stores"),
              ("sparse_ffn_block_v4", 446, "interleaved store"),
              ("sparse_ffn_block_v5", 888, "row stores"))),
        kernel_line("sparse_ffn_block_v7u", "sparkinfer_tpu_torch/csrc/sparse_ffn_v7u.cu",
                    "sparkinfer_tpu/ops/sparse_ffn_pallas.py:1172", l_v7u, v7u_row,
                    "B=8 Cu=48 G=128 E=4096 bf16 fatrelu"),
    ]}
    print(f"crossover measured: the graphed v1 tick beats the graphed masked-dense tick up to "
          f"B={crossover}")
    print("phase 5i summary:", json.dumps({
        "crossover": crossover,
        "batched_graph_ticks": [{"B": r["B"], "v1_tok_s": r["v1"],
                                 "masked_dense_tok_s": r["masked_dense"],
                                 "wall_ms": {k: r["ms_per_step"][k] for k in GRAPHED},
                                 "device_ms": r["graph_device_ms"]} for r in batched],
        "server_7b": {k: srv7[k] for k in SERVER_KEYS},
        "server_7b_v1_launches": l_srv, "grammar_mask_ms_per_tick": mask_ms,
        "server_13b_q8": {k: srv13[k] for k in SERVER_KEYS},
        "server_13b_quant_matmul_2d_launches": l_srv_q8, "entry_point": entry}))
    print("phase 5h summary:", json.dumps({"graph_vs_eager": [
        {"path": r["path"], **{f"{k}_{m}": r[k][m] for k in ("graph", "eager")
                               for m in r["graph"]},
         **{k: r[k] for k in ("replay_span_ms", "replay_launch_ms", "replay_sync_ms",
                              "step_breakdown", "capture_s", "graph_pool_bytes") if k in r}}
        for r in h5],
        "sparse_dense": ratios}))
    print("phase 5j summary:", json.dumps(tier_summary(
        tier_gate, tier_rows, tier_sched, tier13[0], h5, dense_peak)))
    print("phase 5k summary:", json.dumps(moe_summary(moe)))
    print("phase 5l summary:", json.dumps(runtime_summary(runtime)))
    print("phase 5m summary:", json.dumps(quant_summary(w8_row, tier13[1:], kq, emb)))
    print("phase 5n summary:", json.dumps(families_summary(fam)))
    print("phase 5o summary:", json.dumps(swa_summary(swa)))
    print("phase 5p summary:", json.dumps(mla_summary(mla)))
    print("phase 5q summary:", json.dumps(archs_summary(archs)))
    print("phase 5r summary:", json.dumps(kvq_summary(kvq)))
    print("phase 5s summary:", json.dumps(mla_archs_summary(mla_archs)))
    print("phase 5t summary:", json.dumps(gpt_archs_summary(gpt_archs)))
    print("phase 5u summary:", json.dumps(feature_archs_summary(feature_archs)))
    print("phase 5v summary:", json.dumps(encoders_summary(encoders)))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--prefill-profile"]:
        sys.exit(prefill_only())
    if sys.argv[1:] == ["--moe-phase"]:
        sys.exit(child_phase("5k", lambda greedy: phase_moe(greedy, FULL_RUN_MOE_L)))
    if sys.argv[1:] == ["--swa-phase"]:
        sys.exit(child_phase("5o", lambda greedy: phase_swa(greedy, FULL_RUN_SWA_L)))
    if sys.argv[1:] == ["--mla-phase"]:
        sys.exit(child_phase("5p", lambda greedy: phase_mla(greedy, FULL_RUN_MLA_L)))
    if sys.argv[1:] == ["--archs-phase"]:
        sys.exit(child_phase("5q", lambda greedy: phase_archs(
            greedy, FULL_RUN_ARCHS_QWEN3_L, FULL_RUN_ARCHS_MOE_L)))
    if sys.argv[1:] == ["--mla-archs-phase"]:
        sys.exit(child_phase("5s", lambda greedy: phase_mla_archs(greedy, FULL_RUN_MLA_ARCHS_L)))
    if sys.argv[1:] == ["--gpt-archs-phase"]:
        sys.exit(child_phase("5t", lambda greedy: phase_gpt_archs(greedy, FULL_RUN_GPT_L)))
    if sys.argv[1:] == ["--feature-archs-phase"]:
        sys.exit(child_phase("5u", lambda greedy: phase_feature_archs(greedy,
                                                                      FULL_RUN_FEATURE_L)))
    if sys.argv[1:] == ["--encoders-phase"]:
        sys.exit(child_phase("5v", phase_encoders))
    sys.exit(main(only={"--tiered": "tiered", "--moe": "moe", "--runtime": "runtime",
                        "--quant": "quant", "--families": "families", "--swa": "swa",
                        "--mla": "mla", "--archs": "archs", "--kvq": "kvq",
                        "--mla-archs": "mla_archs",
                        "--gpt-archs": "gpt_archs",
                        "--feature-archs": "feature_archs", "--encoders": "encoders",
                        "--7b-paths": "7b_paths"}.get(" ".join(sys.argv[1:]))))
