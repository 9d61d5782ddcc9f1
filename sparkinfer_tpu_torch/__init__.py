"""SparkInfer on PyTorch and CUDA: the port of `sparkinfer_tpu` to one
NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout so a
reader finds each counterpart, and imports nothing of it (nor JAX).

  gguf/       GGUF reader and the dequantizers the port needs (copies)
  ops/        plain torch ops + hand-written CUDA kernels (csrc/, ctypes)
  models/     arch config (copy), GGUF loader, llama-family forward
  runtime/    static KV cache, sampling, Engine
  sparse/     predictor, group selection, pipelined sparse FFN

Entry points (`models.loader.load_model`, `runtime.engine.Engine`) run on
the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
