"""Typed configuration for the PyTorch/CUDA port of tpu-llama.

A copy of ``llama_swift_tpu/config.py`` (the port does not depend on the
JAX package); the knobs keep their names so a config means the same thing
in both packages.

The reference scatters configuration across three disconnected layers
(SURVEY.md §5.6): the C++ ``gpt_params`` struct with hardcoded defaults
(reference ``Sources/cpp/utils.h:15-37``), the Swift ``LlamaRunner.Config``
exposing only a 3-field subset (``Sources/llama/LlamaRunner.swift:12-32``),
and the model hyperparameters read from the GGML file header
(``Sources/llamaObjCxx/bridge/LlamaPredictOperation.mm:41-50, 124-135``).

Here they are unified into three typed dataclasses:

* :class:`ModelConfig` — architecture hparams (the GGML header + derived
  quantities ``n_ff``/``n_parts`` computed exactly as the reference loader
  does).
* :class:`SamplingConfig` — the full ``gpt_params`` sampling surface.  The
  reference's Swift API silently hides top_k/top_p/temp/repeat_penalty/seed;
  surfacing them is a deliberate capability-parity fix (SURVEY.md §5.6).
* :class:`RunnerConfig` — the ``LlamaRunner.Config`` parity surface
  (numThreads/numTokens/reversePrompt) plus sampling + runtime knobs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class GGMLType(enum.IntEnum):
    """Weight dtypes of the GGML file format.

    Encoded in the header's ``f16`` field; mapping per the reference loader
    ``LlamaPredictOperation.mm:169-180`` (0=F32, 1=F16, 2=Q4_0, 3=Q4_1).
    """

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3


#: Number of checkpoint parts per model size, keyed by n_embd.
#: Mirrors ``LLAMA_N_PARTS`` (``LlamaPredictOperation.mm:33-38``) and
#: ``get_n_parts`` (``tools/convert-pth-to-ggml.py:39-49``).
LLAMA_N_PARTS = {4096: 1, 5120: 2, 6656: 4, 8192: 8}

#: GGML magic number ("ggml" in little-endian hex),
#: ``LlamaPredictOperation.mm:110``.
GGML_MAGIC = 0x67676D6C

#: Quantization block size (``QK``, ``ggml.c:360``).
QK = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LLaMA architecture hyperparameters (``llama_hparams``,
    ``LlamaPredictOperation.mm:41-50``).

    ``n_ctx`` is *not* stored in the model file — the reference hardcodes 512
    at load time (``LlamaPredictOperation.mm:125, 790``).  Here it is a real
    config knob (capability fix, SURVEY.md §5.7).
    """

    n_vocab: int = 32000
    n_embd: int = 4096
    n_mult: int = 256
    n_head: int = 32
    n_layer: int = 32
    n_rot: int = 64
    ftype: GGMLType = GGMLType.F16
    n_ctx: int = 512

    # Runtime knobs (no reference equivalent); shared with the JAX package.
    norm_type: str = "layernorm"  # "layernorm" (reference ggml_norm) | "rmsnorm"
    norm_eps: float = 1e-5  # hardcoded in the reference, ggml.c:5355
    quantize_activations: bool = True  # replicate mul_mat_q4_0 INIT behaviour
    compute_dtype: str = "float32"  # activation compute dtype
    #: fuse wq/wk/wv into one matmul and w1/w3 into one (out-dim concat;
    #: numerically exact — Q4 block scales are per source row). Off by
    #: default: measured no decode gain (bandwidth-bound, launch overhead is
    #: negligible) and the concatenated out dims can break TP divisibility
    #: with the 128-row tiled Q4 layout (e.g. 2·11008/128 tiles % 8 ≠ 0).
    fuse_layer_matmuls: bool = False
    #: KV cache dtype ("float32" matches the reference's f32 cache,
    #: .mm:297-304; "bfloat16" halves attention HBM traffic; "int8" stores
    #: symmetric codes with one f32 scale per (head, position) row, about a
    #: quarter of the f32 bytes)
    kv_cache_dtype: str = "float32"
    #: use the flash-decode attention kernels (ops/attention.py) for
    #: single-token steps over f32, bf16 or int8 caches; they read the cache
    #: in place.  Off: the plain masked-softmax attention.
    use_flash_decode: bool = True
    #: kept for config compatibility with the JAX package (it picks a
    #: ``lax.scan`` layer loop there); the port always runs a Python loop
    #: over views of the stacked weights.
    scan_layers: bool = True
    #: prefill (N>1) dense-dequant matmuls take bf16 operands on the card
    #: (f32 accumulation and output): halves the dequantized weight bytes
    #: and runs on the tensor cores.  Activations are already 4-bit
    #: fake-quantized, so the bf16 rounding is inside the quantization
    #: noise.  False: f32 operands with TF32 off.  CPU tensors stay f32.
    prefill_bf16: bool = True

    @property
    def n_ff(self) -> int:
        """FFN hidden size; exact integer formula from
        ``LlamaPredictOperation.mm:135``."""
        return ((2 * (4 * self.n_embd) // 3 + self.n_mult - 1) // self.n_mult) * self.n_mult

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_parts(self) -> int:
        """Checkpoint part count (``LLAMA_N_PARTS.at(n_embd)``); sizes not in
        the table are single-part."""
        return LLAMA_N_PARTS.get(self.n_embd, 1)

    # ---- presets -------------------------------------------------------

    @classmethod
    def llama_7b(cls, **kw) -> "ModelConfig":
        return cls(n_embd=4096, n_head=32, n_layer=32, n_rot=128, **kw)

    @classmethod
    def llama_13b(cls, **kw) -> "ModelConfig":
        return cls(n_embd=5120, n_head=40, n_layer=40, n_rot=128, **kw)

    @classmethod
    def llama_30b(cls, **kw) -> "ModelConfig":
        return cls(n_embd=6656, n_head=52, n_layer=60, n_rot=128, **kw)

    @classmethod
    def llama_65b(cls, **kw) -> "ModelConfig":
        return cls(n_embd=8192, n_head=64, n_layer=80, n_rot=128, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests: shapes chosen so n_embd/n_head and Q4
        blocking (multiples of 64, loader assert ``LlamaPredictOperation.mm:441``)
        still hold."""
        defaults = dict(
            n_vocab=256, n_embd=64, n_mult=32, n_head=4, n_layer=2, n_rot=16,
            n_ctx=64,
        )
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Full sampling parameter set of the reference (``gpt_params``,
    ``utils.h:15-37``), with identical defaults.

    ``seed=-1`` in the reference feeds ``std::mt19937((uint32)-1)`` — i.e. a
    *fixed* seed, since the ObjC bridge never overrides it
    (``LlamaRunnerBridge.mm:34-43``).  Here ``seed=None`` means
    "nondeterministic"; pass an int for reproducibility.
    """

    seed: Optional[int] = None
    n_predict: int = 128
    repeat_last_n: int = 64
    top_k: int = 40
    top_p: float = 0.95
    temp: float = 0.80
    repeat_penalty: float = 1.30
    n_batch: int = 8  # prompt-prefill chunk size
    #: "numpy" (counted Generator) or "mt19937" (native std::mt19937 via the
    #: port's C++ sampler, native/ggml_io.cpp built with g++ into _build/ —
    #: bit-compatible RNG stream with the reference,
    #: LlamaPredictOperation.mm:773, and with the JAX package's sampler;
    #: falls back to numpy only if the native lib can't build)
    rng_impl: str = "numpy"


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    """Parity surface of ``LlamaRunner.Config``
    (``LlamaRunner.swift:12-32``; defaults ``:17``) plus the sampling knobs
    the Swift API hid.

    ``num_threads`` is accepted for API compatibility but has no effect
    (the pthread pool it configured in the reference, ``ggml.c:9123-9149``,
    has no analogue on the GPU).
    """

    num_threads: int = 8
    num_tokens: int = 512  # maps to n_predict (LlamaRunnerBridge.mm:38)
    reverse_prompt: Optional[str] = None
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    n_ctx: int = 512
    #: consume the prompt in chunks of ``sampling.n_batch`` like the
    #: reference's batched prompt loop (.mm:878-889; sans its off-by-one),
    #: instead of one padded prefill. Same numerics; more, smaller steps.
    chunked_prefill: bool = False
    #: sample on DEVICE (runtime/device_sampler.py): the exact reference
    #: pipeline as torch ops, ``device_chunk`` tokens per host read instead
    #: of one device-to-host copy per token.  Default ON.  Set False for the
    #: host sampler's numpy / native-mt19937 RNG stream.
    device_sampling: bool = True
    #: tokens generated per host read when ``device_sampling`` (the
    #: streaming granularity)
    device_chunk: int = 32

    def resolved_sampling(self) -> SamplingConfig:
        """numTokens overrides n_predict, like the bridge translation
        (``LlamaRunnerBridge.mm:34-43``)."""
        return dataclasses.replace(self.sampling, n_predict=self.num_tokens)
