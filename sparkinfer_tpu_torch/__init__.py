"""SparkInfer on PyTorch and CUDA: the port of `sparkinfer_tpu` to one
NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout so a
reader finds each counterpart, and imports nothing of it (nor JAX).

  gguf/       GGUF reader, writer and every GGML block format's codecs (copies)
  ops/        plain torch ops + hand-written CUDA kernels (csrc/, ctypes)
  models/     arch config (copy), GGUF loader, llama-family forward and
              its MoE (llama-MoE, mixtral, qwen3moe)
  runtime/    static KV cache, sampling, Engine, Scheduler, embeddings
  sparse/     predictor, group selection, pipelined sparse FFN, hot/cold
              tiering, the online balancer, model splits, MoE routing, the
              expert FFN and expert tiering
  native.py   the tiered FFN's host library (csrc/spark_host.cpp, g++)

Entry points (`models.loader.load_model`, `runtime.engine.Engine`) run on
the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
