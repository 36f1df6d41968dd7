"""The port's LlamaRunner (device="cpu", the kernels' plain versions) on a
tiny Q4_0 GGML file: the same greedy token stream as the JAX LlamaRunner on
both sampling paths, the event order, prompt echo, the callback and async
variants, and the refusal to start without a CUDA device unless asked."""

import asyncio
import dataclasses

import pytest
import torch

from llama_swift_tpu.config import GGMLType, RunnerConfig, SamplingConfig
from llama_swift_tpu.formats import ggml
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.runtime.runner import LlamaRunner as JaxRunner
from llama_swift_torch.config import RunnerConfig as TRunnerConfig
from llama_swift_torch.config import SamplingConfig as TSamplingConfig
from llama_swift_torch.runtime.errors import FailedToLoadModelError
from llama_swift_torch.runtime.events import EventKind, RunState
from llama_swift_torch.runtime.runner import LlamaRunner

N_TOKENS = 10


@pytest.fixture(scope="module")
def model_path(tmp_path_factory, tiny_cfg, tiny_tensors, tiny_vocab_pieces):
    cfg = dataclasses.replace(tiny_cfg, ftype=GGMLType.Q4_0)
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in tiny_tensors.items()}
    path = str(tmp_path_factory.mktemp("tq4") / "model-q4_0.bin")
    ggml.write_model_file(path, cfg, tiny_vocab_pieces, tensors)
    return path


def _jax_cfg(device_sampling, n_tokens=N_TOKENS):
    return RunnerConfig(num_tokens=n_tokens, device_sampling=device_sampling,
                        sampling=SamplingConfig(seed=7, top_k=1))


def _port_cfg(device_sampling, n_tokens=N_TOKENS):
    return TRunnerConfig(num_tokens=n_tokens, device_sampling=device_sampling,
                         sampling=TSamplingConfig(seed=7, top_k=1))


def _tokens(events):
    """Output tokens of either package's event stream (two enum classes)."""
    return [e.token for e in events if e.kind.value == EventKind.OUTPUT_TOKEN.value]


@pytest.fixture(scope="module")
def port_runner(model_path):
    return LlamaRunner(model_path, n_ctx=64, prefill_bucket=8, device="cpu")


@pytest.mark.parametrize("device_sampling", [True, False])
def test_greedy_stream_matches_jax_runner(model_path, port_runner, device_sampling):
    prompt = "the rain in"
    jax_toks = _tokens(JaxRunner(model_path, n_ctx=64, prefill_bucket=8).run_events(prompt, _jax_cfg(device_sampling)))
    port_toks = _tokens(port_runner.run_events(prompt, _port_cfg(device_sampling)))
    assert len(jax_toks) > N_TOKENS
    assert port_toks == jax_toks
    assert port_runner.stats["generated_tokens"] == N_TOKENS


def test_event_order_and_prompt_echo(port_runner, tiny_vocab_pieces):
    from llama_swift_torch.tokenizer import Vocab

    events = list(port_runner.run_events("the rain", _port_cfg(True)))
    kinds = [e.kind for e in events]
    assert kinds[:3] == [EventKind.STARTED_LOADING_MODEL, EventKind.FINISHED_LOADING_MODEL,
                         EventKind.STARTED_GENERATING_OUTPUT]
    assert kinds[-1] == EventKind.COMPLETED
    assert all(k == EventKind.OUTPUT_TOKEN for k in kinds[3:-1])
    v = Vocab(tiny_vocab_pieces)
    ids = v.tokenize("the rain", bos=True)
    toks = _tokens(events)
    assert "".join(toks[: len(ids)]) == "".join(v.piece_str(t) for t in ids)
    assert len(toks) == len(ids) + N_TOKENS


def test_sampled_runs_are_seeded(port_runner):
    cfg = TRunnerConfig(num_tokens=6, sampling=TSamplingConfig(seed=3))
    a = _tokens(port_runner.run_events("the", cfg))
    b = _tokens(port_runner.run_events("the", cfg))
    assert a == b


def test_callback_and_async(port_runner):
    states, tokens = [], []
    port_runner.run_with_callback("the", _port_cfg(True, 4), tokens.append, states.append)
    assert states == [RunState.NOT_STARTED, RunState.INITIALIZING,
                      RunState.GENERATING_OUTPUT, RunState.COMPLETED]
    got = []

    async def go():
        async for tok in port_runner.run("the", _port_cfg(True, 4)):
            got.append(tok)

    asyncio.run(go())
    assert got == tokens


def test_missing_model_fails(tmp_path):
    runner = LlamaRunner(str(tmp_path / "missing.bin"), device="cpu")
    events = list(runner.run_events("x", _port_cfg(True)))
    assert events[-1].kind == EventKind.FAILED
    assert isinstance(events[-1].error, FailedToLoadModelError)


def test_requires_cuda_unless_cpu_asked(model_path):
    if torch.cuda.is_available():
        assert LlamaRunner(model_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            LlamaRunner(model_path)
