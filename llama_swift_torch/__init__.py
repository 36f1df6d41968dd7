"""llama_swift_torch: the PyTorch/CUDA port of tpu-llama, for an NVIDIA H100.

It mirrors ``llama_swift_tpu`` module for module and does not depend on
it.  The batch-1 serving path runs through three hand-written CUDA kernels
(``csrc/``): the Q4_0 matvec, flash-decode attention and the Q4_0 dequant
that feeds the prefill matmuls.  The continuous-batching ``Engine`` adds
three more: the multi-row Q4_0 matmul and the batched and paged
flash-decode attention.  An int8 KV cache (``kv_cache_dtype="int8"`` or
``cache_dtype=torch.int8``) reaches an int8 flash-decode kernel in each
cache mode: batch 1 (the runner), dense batched and paged (the engine).
Fused wqkv/w13 params decode batch 1 through a whole-stack kernel.  Q4_1
files take a Q4_1 matvec (one row) and a Q4_1 dequant (more rows).  They
are built with ``nvcc`` at first use.  ``tools/quantize.py`` writes Q4_0
and Q4_1 files; ``tools/perplexity.py`` scores a model on a text.

    from llama_swift_torch import LlamaRunner, RunnerConfig

    runner = LlamaRunner("ggml-model-q4_0.bin")          # CUDA card
    for event in runner.run_events("Hello", RunnerConfig(num_tokens=32)):
        ...
"""

from .config import GGMLType, ModelConfig, QK, RunnerConfig, SamplingConfig
from .runtime.errors import (
    ERROR_DOMAIN,
    FailedToLoadModelError,
    LlamaError,
    PredictionFailedError,
)
from .runtime.engine import Engine, StreamHandle
from .runtime.events import Event, EventKind, RunState
from .runtime.runner import LlamaRunner
from .tokenizer import BOS_TOKEN_ID, Vocab

__all__ = [
    "BOS_TOKEN_ID",
    "ERROR_DOMAIN",
    "Engine",
    "Event",
    "EventKind",
    "FailedToLoadModelError",
    "GGMLType",
    "LlamaError",
    "LlamaRunner",
    "ModelConfig",
    "PredictionFailedError",
    "QK",
    "RunState",
    "RunnerConfig",
    "SamplingConfig",
    "StreamHandle",
    "Vocab",
]

__version__ = "0.1.0"
