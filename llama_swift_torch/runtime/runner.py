"""`LlamaRunner` — the public streaming-generation API of the port
(counterpart of ``llama_swift_tpu/runtime/runner.py``).

Mirrors the reference's Swift API surface (``Sources/llama/LlamaRunner.swift``):
:meth:`LlamaRunner.run` (async iterator of token strings),
:meth:`LlamaRunner.run_with_callback` (closure variant) and the underlying
synchronous event stream :meth:`LlamaRunner.run_events`.

Behavioral parity with the generation loop
(``LlamaPredictOperation.mm:768-911``): an empty prompt gets a canned random
one; ``n_predict`` is clamped to ``n_ctx - len(prompt_tokens)``; the token
stream ECHOES the prompt; the last-n ring starts as ``repeat_last_n`` zeros;
no eos-stop; ``reverse_prompt`` stops generation when the emitted ids end
with it.  The model is loaded once per runner.

The runner runs on the CUDA card unless it is given ``device="cpu"``.  Its
KV cache follows ``runner.config.kv_cache_dtype`` (f32, bf16, or int8 with
per-row scales), as the JAX runner's does.
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue as queue_mod
import threading
import time
from typing import AsyncIterator, Callable, Iterator, Optional

import numpy as np
import torch

from ..config import ModelConfig, RunnerConfig
from ..formats import ggml
from ..models import llama as model_lib
from ..tokenizer import Vocab
from .errors import FailedToLoadModelError, LlamaError, PredictionFailedError
from .events import Event, RunState
from .sampler import SamplerState

_RANDOM_PROMPTS = [
    "So",
    "Once upon a time,",
    "When",
    "The",
    "After",
    "If",
    "import",
    "He",
    "She",
    "They",
]


class LlamaRunner:
    """Load a GGML model and stream generated tokens.

    ``model_path`` plays the role of ``modelURL`` (``LlamaRunner.swift:42-47``);
    the model is lazily loaded on first run and cached.  ``device``: None
    means the CUDA card, and raises if there is none.
    ``fuse_layer_matmuls``: load fused wqkv/w13 params, on which batch-1
    decode runs every layer in one launch of the whole-stack kernel (see
    ``models/llama.py``).
    """

    def __init__(
        self,
        model_path: str,
        *,
        n_ctx: int = 512,
        param_dtype=None,
        prefill_bucket: int = 64,
        device=None,
        fuse_layer_matmuls: bool = False,
    ):
        self.device = model_lib.resolve_device(device)
        self.fuse_layer_matmuls = fuse_layer_matmuls
        self.model_path = model_path
        self.n_ctx = n_ctx
        self.param_dtype = param_dtype
        self.prefill_bucket = prefill_bucket
        self._loaded = False
        self.config: Optional[ModelConfig] = None
        self.vocab: Optional[Vocab] = None
        self.params = None
        # perf counters the reference accumulates but never reports
        # (LlamaPredictOperation.mm:778-871) — reported here
        self.stats: dict = {}

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    def ensure_loaded(self) -> None:
        if self._loaded:
            return
        t0 = time.perf_counter()
        try:
            mf = ggml.load_model_file(self.model_path, n_ctx=self.n_ctx)
        except FileNotFoundError as e:
            raise FailedToLoadModelError(f"failed to open '{self.model_path}'") from e
        except ggml.GGMLFormatError as e:
            raise FailedToLoadModelError(str(e)) from e
        self.config = dataclasses.replace(mf.config, fuse_layer_matmuls=self.fuse_layer_matmuls)
        self.vocab = Vocab(mf.vocab)
        self.params = model_lib.params_from_tensors(
            mf.tensors, self.config, device=self.device, param_dtype=self.param_dtype
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # load time includes the copies
        if mf.native_handle is not None:  # single-part files are mmap-loaded;
            mf.native_handle.close()  # the tensors own their memory
        self._loaded = True
        self.stats["t_load_s"] = time.perf_counter() - t0

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    # ------------------------------------------------------------------
    # core synchronous event loop
    # ------------------------------------------------------------------

    def run_events(
        self, prompt: str, config: Optional[RunnerConfig] = None
    ) -> Iterator[Event]:
        """Synchronous generator of lifecycle events — the ``_LlamaEvent``
        stream (``LlamaPredictOperation.mm:785-900``)."""
        config = config or RunnerConfig()
        yield Event.started_loading_model()
        try:
            self.ensure_loaded()
        except LlamaError as e:
            yield Event.failed(e)
            return
        yield Event.finished_loading_model()
        yield Event.started_generating_output()

        try:
            sampling = config.resolved_sampling()
            sampler = SamplerState(sampling)
            if not prompt:
                prompt = _RANDOM_PROMPTS[int(sampler.rng.integers(len(_RANDOM_PROMPTS)))]

            assert self.vocab is not None and self.config is not None
            cfg = self.config
            prompt_ids = self.vocab.tokenize(prompt, bos=True)
            if len(prompt_ids) >= cfg.n_ctx:
                prompt_ids = prompt_ids[: cfg.n_ctx - 1]
            n_predict = min(sampling.n_predict, cfg.n_ctx - len(prompt_ids))
            reverse_ids = (
                self.vocab.tokenize(config.reverse_prompt, bos=False)
                if config.reverse_prompt
                else []
            )

            t0 = time.perf_counter()
            cache = model_lib.init_cache(cfg, device=self.device)
            if config.chunked_prefill:
                # reference-style n_batch chunked prompt consumption (.mm:878-889)
                nb = max(1, sampling.n_batch)
                n_done = 0
                while n_done < len(prompt_ids):
                    chunk = prompt_ids[n_done : n_done + nb]
                    padded, length = model_lib.pad_tokens(chunk, nb)
                    padded = padded[: cfg.n_ctx - n_done]
                    logits_all, cache = model_lib.prefill(
                        self.params, self._tokens(padded), n_done, cache, cfg
                    )
                    logits = logits_all[length - 1]
                    n_done += len(chunk)
            else:
                # right-padded to a bucket like the JAX runner: padded slots
                # write stale cache entries that decode overwrites
                padded, length = model_lib.pad_tokens(prompt_ids, self.prefill_bucket)
                padded = padded[: cfg.n_ctx]
                logits_all, cache = model_lib.prefill(
                    self.params, self._tokens(padded), 0, cache, cfg
                )
                logits = logits_all[length - 1]
            logits = logits.cpu().numpy()
            self.stats["t_prefill_s"] = time.perf_counter() - t0
            self.stats["prompt_tokens"] = len(prompt_ids)

            # echo prompt tokens through the stream (.mm:892-895)
            for tid in prompt_ids:
                sampler.observe(tid)
                yield Event.output_token(self.vocab.piece_str(tid))

            n_past = len(prompt_ids)
            generated: list[int] = []
            t_decode = 0.0
            if config.device_sampling:
                yield from self._decode_device(
                    config, sampling, prompt_ids, reverse_ids, n_predict,
                    cache, generated,
                )
            else:
                # host sampler per token (numpy / native-mt19937 RNG stream;
                # one device→host copy of the logits per token)
                for _ in range(n_predict):
                    tid = sampler.sample(logits)
                    generated.append(tid)
                    if reverse_ids and generated[-len(reverse_ids):] == reverse_ids:
                        break
                    yield Event.output_token(self.vocab.piece_str(tid))
                    if len(generated) >= n_predict:
                        break
                    t1 = time.perf_counter()
                    step_logits, cache = model_lib.decode_step(
                        self.params, self._tokens(tid), n_past, cache, cfg,
                    )
                    logits = step_logits.cpu().numpy()
                    t_decode += time.perf_counter() - t1
                    n_past += 1
                self.stats["t_decode_s"] = t_decode
                self.stats["generated_tokens"] = len(generated)
                if t_decode > 0 and len(generated) > 1:
                    self.stats["decode_tok_per_s"] = (len(generated) - 1) / t_decode
        except LlamaError as e:
            yield Event.failed(e)
            return
        except Exception as e:  # pragma: no cover - defensive
            yield Event.failed(PredictionFailedError(str(e)))
            return
        yield Event.completed()

    def _decode_device(
        self, config, sampling, prompt_ids, reverse_ids, n_predict,
        cache, generated,
    ) -> Iterator[Event]:
        """On-device sampled decode, ``device_chunk`` tokens per host read
        (``sampled_decode_loop``).  The reverse-prompt check runs between
        emitted tokens on the host (stop before emitting the matching
        token)."""
        from .device_sampler import init_ring, sampled_decode_loop

        cfg = self.config
        seed = sampling.seed
        if seed is None or (isinstance(seed, int) and seed < 0):
            import secrets

            seed = 0xFFFFFFFF if seed == -1 else secrets.randbits(31)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        ring, pos = init_ring(prompt_ids, sampling.repeat_last_n, self.device)
        chunk = max(1, int(config.device_chunk))
        last = self._tokens(prompt_ids[-1])
        n_past = len(prompt_ids) - 1  # the loop re-evaluates the last prompt slot
        t_decode = 0.0
        stop = False
        while len(generated) < n_predict and not stop:
            steps = min(chunk, n_predict - len(generated))
            t1 = time.perf_counter()
            toks, cache, ring, pos = sampled_decode_loop(
                self.params, last, n_past, cache, ring, pos, generator,
                steps, cfg, sampling,
            )
            out = toks.cpu().numpy()
            t_decode += time.perf_counter() - t1
            for tid in out:
                tid = int(tid)
                generated.append(tid)
                if reverse_ids and generated[-len(reverse_ids):] == reverse_ids:
                    stop = True
                    break
                yield Event.output_token(self.vocab.piece_str(tid))
                if len(generated) >= n_predict:
                    break
            last = toks[-1]
            n_past += steps
        self.stats["t_decode_s"] = t_decode
        self.stats["generated_tokens"] = len(generated)
        if t_decode > 0 and generated:
            self.stats["decode_tok_per_s"] = len(generated) / t_decode

    # ------------------------------------------------------------------
    # closure variant (LlamaRunner.swift:90-123)
    # ------------------------------------------------------------------

    def run_with_callback(
        self,
        prompt: str,
        config: Optional[RunnerConfig] = None,
        token_handler: Optional[Callable[[str], None]] = None,
        state_change_handler: Optional[Callable[[RunState], None]] = None,
    ) -> None:
        def set_state(s: RunState):
            if state_change_handler:
                state_change_handler(s)

        set_state(RunState.NOT_STARTED)
        for event in self.run_events(prompt, config):
            event.match(
                started_loading_model=lambda: set_state(RunState.INITIALIZING),
                started_generating_output=lambda: set_state(RunState.GENERATING_OUTPUT),
                output_token=(lambda t: token_handler(t)) if token_handler else None,
                completed=lambda: set_state(RunState.COMPLETED),
                failed=lambda e: set_state(RunState.FAILED),
            )

    # ------------------------------------------------------------------
    # async variant (LlamaRunner.swift:51-87)
    # ------------------------------------------------------------------

    def run(
        self,
        prompt: str,
        config: Optional[RunnerConfig] = None,
        state_change_handler: Optional[Callable[[RunState], None]] = None,
    ) -> AsyncIterator[str]:
        """Async iterator of token strings; raises the failure error through
        the iterator like ``AsyncThrowingStream`` (``LlamaRunner.swift:78-81``)."""

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=256)
        SENTINEL = object()

        def set_state(s: RunState):
            if state_change_handler:
                state_change_handler(s)

        def worker():
            try:
                for event in self.run_events(prompt, config):
                    q.put(event)
            finally:
                q.put(SENTINEL)

        async def agen() -> AsyncIterator[str]:
            set_state(RunState.NOT_STARTED)
            t = threading.Thread(target=worker, daemon=True)
            t.start()
            loop = asyncio.get_running_loop()
            error: Optional[BaseException] = None
            while True:
                item = await loop.run_in_executor(None, q.get)
                if item is SENTINEL:
                    break
                ev: Event = item
                if ev.kind.value == "startedLoadingModel":
                    set_state(RunState.INITIALIZING)
                elif ev.kind.value == "startedGeneratingOutput":
                    set_state(RunState.GENERATING_OUTPUT)
                elif ev.kind.value == "outputToken":
                    yield ev.token or ""
                elif ev.kind.value == "completed":
                    set_state(RunState.COMPLETED)
                elif ev.kind.value == "failed":
                    set_state(RunState.FAILED)
                    error = ev.error
            if error is not None:
                raise error

        return agen()
