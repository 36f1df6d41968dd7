"""The port under test for a LLaMA-family configuration: ``LlamaRunner`` of
``llama_swift_torch`` on fused Q4_0 params, built from the seed.

``LlamaRunner`` loads only from a file, and a Q4_0 file is gigabytes, so
the benchmark writes none: it makes the weights on the device
(``benchmark/weights.py``) straight into the layout ``params_from_tensors``
builds for fused params (stacked ``[L, ...]`` Q4_0 codes and f32 scales,
``wqkv`` and ``w13`` as out-dim concats), a vocabulary of 3-letter pieces,
and sets the runner's loaded state (``config``, ``vocab``, ``params``).
Requests then go through ``LlamaRunner.run_events``, the timed entry.
"""

from __future__ import annotations

import string

import torch

from .. import weights
from ..counts import llama as counts

ALPHABET = string.ascii_letters + string.digits
SPECIALS = (b"<unk>", b"<s>", b"</s>")


def vocab_pieces(n_vocab: int) -> list:
    """Special pieces 0..2, then distinct 3-letter pieces: the port's greedy
    longest-match tokenizer reads a concatenation of them back to its ids."""
    a = len(ALPHABET)
    if n_vocab - len(SPECIALS) > a**3:
        raise ValueError(f"{n_vocab} pieces do not fit in 3 letters")
    return list(SPECIALS) + [(ALPHABET[j // (a * a)] + ALPHABET[j // a % a] + ALPHABET[j % a]).encode()
                             for j in range(n_vocab - len(SPECIALS))]


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from llama_swift_torch.config import GGMLType, ModelConfig

    p = cfg["port"]
    mc = ModelConfig(
        n_vocab=p["n_vocab"], n_embd=p["n_embd"], n_mult=p["n_mult"], n_head=p["n_head"],
        n_layer=p["n_layer"], n_rot=p["n_embd"] // p["n_head"], ftype=GGMLType(p["ftype"]), n_ctx=p["n_ctx"],
        norm_type=p["norm_type"], norm_eps=p["norm_eps"], quantize_activations=p["quantize_activations"],
        compute_dtype=p["compute_dtype"], fuse_layer_matmuls=p["fuse_layer_matmuls"],
        kv_cache_dtype=p["kv_cache_dtype"], prefill_bf16=p["prefill_bf16"],
    )
    if mc.n_ff != p["n_ff"] or mc.ftype != GGMLType.Q4_0 or not mc.fuse_layer_matmuls or p["rope_base"] != 10000.0:
        raise ValueError(f"{cfg['name']}: the port runs fused Q4_0 at RoPE base 10000 with n_ff {mc.n_ff}")
    return mc


def build_params(cfg: dict, seed: int, device):
    """The port's fused Q4_0 ``Params``, made layer by layer on ``device``."""
    from llama_swift_torch.models.llama import Params
    from llama_swift_torch.ops.q4_matvec import Q4_0Weight

    d = counts.dims(cfg)
    specs = {t.name: t for t in counts.tensors(d)}
    stacked = {}
    for name in ("attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2"):
        t = specs[name]
        if t.out is None:
            stacked[name] = torch.empty((d.L, t.in_dim), dtype=torch.float32, device=device)
        else:
            stacked[name] = Q4_0Weight(
                torch.empty((d.L, t.out, t.in_dim // 2), dtype=torch.uint8, device=device),
                torch.empty((d.L, t.out, t.in_dim // 32), dtype=torch.float32, device=device))
        for il in range(d.L):
            w = weights.make(seed, t, il, device)
            if t.out is None:
                stacked[name][il].copy_(w)
            else:
                stacked[name].qs[il].copy_(w[0])
                stacked[name].d[il].copy_(w[1])
            del w
    return Params({
        "tok_embeddings": Q4_0Weight(*weights.make(seed, specs["tok_embeddings"], 0, device)),
        "norm": weights.make(seed, specs["norm"], 0, device),
        "output": Q4_0Weight(*weights.make(seed, specs["output"], 0, device)),
        "layers_stacked": stacked,
    })


class Session:
    """One loaded runner: ``events(request, span)`` sends a request and
    yields ``(kind, token_id)`` for each token event, ``kind`` "echo" for
    the prompt's echo and "token" for a generated one; ``span(label)`` is
    entered around each step of the generator, labelled by the work it
    does ("prefill", "decode", "stream")."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        from llama_swift_torch.runtime.runner import LlamaRunner
        from llama_swift_torch.tokenizer import Vocab

        self.cfg, self.mix = cfg, mix
        p = cfg["port"]
        self.bucket = int(p["prefill_bucket"])
        runner = LlamaRunner("", n_ctx=p["n_ctx"], device=device, fuse_layer_matmuls=True,
                             prefill_bucket=self.bucket)
        runner.config = model_config(cfg)
        pieces = vocab_pieces(p["n_vocab"])
        runner.vocab = Vocab(pieces)
        runner.params = build_params(cfg, seed, runner.device)
        runner._loaded = True
        self.runner = runner
        self.piece_id = {pc.decode(): i for i, pc in enumerate(pieces)}
        self.pieces = pieces

    def runner_config(self, request):
        from llama_swift_torch.config import RunnerConfig, SamplingConfig

        s = self.mix["greedy_sampling" if request.greedy else "sampling"]
        sampling = SamplingConfig(seed=request.sampler_seed, temp=s["temp"], top_k=s["top_k"], top_p=s["top_p"],
                                  repeat_penalty=s["repeat_penalty"], repeat_last_n=s["repeat_last_n"])
        return RunnerConfig(num_tokens=request.n_predict, sampling=sampling, n_ctx=self.cfg["port"]["n_ctx"],
                            device_sampling=True, device_chunk=int(self.mix["device_chunk"]))

    def prompt_text(self, request) -> str:
        """The prompt's pieces after BOS, which the runner tokenizes (adding
        BOS) back to ``request.prompt``."""
        return b"".join(self.pieces[t] for t in request.prompt[1:]).decode()

    def events(self, request, span):
        from llama_swift_torch.runtime.events import EventKind

        chunk = int(self.mix["device_chunk"])
        gen = self.runner.run_events(self.prompt_text(request), self.runner_config(request))
        echoed = generated = 0
        try:
            while True:
                if echoed == 0:
                    label = "prefill"
                elif echoed == request.prompt_len and generated % chunk == 0 and generated < request.n_predict:
                    label = "decode"
                else:
                    label = "stream"
                with span(label):
                    ev = next(gen, None)
                if ev is None:
                    return
                if ev.kind is EventKind.FAILED:
                    raise RuntimeError(f"request {request.index} failed: {ev.error!r}")
                if ev.kind is not EventKind.OUTPUT_TOKEN:
                    continue
                tid = self.piece_id.get(ev.token, -1)
                if echoed < request.prompt_len:
                    echoed += 1
                    yield "echo", tid
                else:
                    generated += 1
                    yield "token", tid
        finally:
            gen.close()

    def stats(self) -> dict:
        """The runner's counters of its last finished request."""
        return dict(self.runner.stats)

    def release(self) -> None:
        """Drop the runner and its params, and return their memory."""
        self.runner = None
        torch.cuda.empty_cache()
