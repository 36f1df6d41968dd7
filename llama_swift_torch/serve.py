"""Tensor-parallel serving entry point (counterpart of ``llama_swift_tpu/serve.py``).

One process per device, identical invocation everywhere except
``--process-id``::

    python -m llama_swift_torch.serve --model ggml-model-q4_0.bin \\
        --coordinator host0:8476 --num-processes 2 --process-id $RANK \\
        --prompt "..." [--tp 2] [--device cpu]

``parallel/multihost.init_distributed`` forms the process group (NCCL on
the card, gloo with ``--device cpu``; nothing without ``--coordinator``);
the weights are loaded fused (wqkv, w13), interleaved per shard and
row-sharded with ``parallel/tp.py``; every rank drives the same step in
lockstep and only rank 0 prints.  Each rank samples the full logits with
its own sampler and feeds the id back, so the ranks stay in step only if
their samplers draw alike: without ``--seed``, rank 0 draws a seed and
broadcasts it before the samplers are built (the JAX package leaves each
process to seed itself from OS entropy, and the ranks then write different
tokens into their shards of the cache).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="llama_swift_torch tensor-parallel serving")
    ap.add_argument("--model", default=os.environ.get("MODEL_PATH"))
    ap.add_argument("--prompt", default="Once upon a time,")
    ap.add_argument("--n-tokens", type=int, default=128)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--temp", type=float, default=0.80)
    ap.add_argument("--repeat-penalty", type=float, default=1.30)
    # process group (parallel/multihost.py)
    ap.add_argument("--coordinator", default=None,
                    help="host0:port of rank 0 (or an init-method URL); omit for a single process")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=int(os.environ.get("HOST_INDEX", "0")))
    ap.add_argument("--tp", type=int, default=None, help="tensor-parallel degree (default: every rank)")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU over gloo (default: the card)")
    return ap


def shared_seed(device) -> int:
    """A sampler seed drawn by rank 0 and broadcast to every rank."""
    import torch
    import torch.distributed as dist

    seed = torch.tensor([int(np.random.SeedSequence().entropy % 2**31)], dtype=torch.int64, device=device)
    dist.broadcast(seed, src=0)
    return int(seed.item())


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not args.model:
        print("Model path not specified - define in MODEL_PATH or --model")
        return 1
    if not os.path.exists(args.model):
        print("Invalid model path, make sure this is a file path")
        return 1

    from .parallel.multihost import init_distributed, shutdown

    device = init_distributed(
        args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id if args.coordinator else None,
        device=args.device,
    )
    try:
        return _serve(args, device)
    finally:
        shutdown()


def _serve(args, device) -> int:
    import torch
    import torch.distributed as dist

    from .config import SamplingConfig
    from .formats import ggml
    from .models import llama as model_lib
    from .parallel import tp as tp_lib
    from .parallel.mesh import make_mesh
    from .parallel.multihost import is_primary
    from .parallel.sharding import validate_tp_divisibility
    from .runtime.sampler import SamplerState
    from .tokenizer import Vocab

    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = args.tp or world
    mesh = make_mesh(tp=tp)
    say = print if is_primary() else (lambda *a, **k: None)

    say(f"[serve] mesh tp={tp} over {world} devices, process {mesh.rank}/{world}")
    t0 = time.perf_counter()
    mf = ggml.load_model_file(args.model, n_ctx=args.n_ctx)
    # fused wqkv/w13, interleaved per shard, and per-shard flash decode
    cfg = dataclasses.replace(mf.config, fuse_layer_matmuls=True)
    vocab = Vocab(mf.vocab)
    try:  # shard_pad below pads n_ff and the vocab when tp > 1
        validate_tp_divisibility(cfg, tp, tiled_q4=tp > 1)
    except ValueError as e:
        print(e)
        return 1
    params = model_lib.params_from_tensors(
        mf.tensors, cfg, device=device,
        shard_pad=128 * tp if tp > 1 else 1,
        # "v" explicitly, as the JAX serve.py: the per-product kernels of
        # the port's own layout run per shard
        q4_layout="v",
        fuse_shards=tp,
    )
    if mf.native_handle is not None:  # the params own their memory
        mf.native_handle.close()
    params = tp_lib.shard_params_tp(params, mesh)
    cache = tp_lib.shard_cache_tp(model_lib.init_cache(cfg, device=device), mesh)
    fwd = tp_lib.make_tp_forward(cfg, params, cache)
    say(f"[serve] model loaded+sharded in {time.perf_counter() - t0:.1f}s")

    seed = args.seed if args.seed is not None or not dist.is_initialized() else shared_seed(device)
    sampler = SamplerState(SamplingConfig(
        seed=seed, top_k=args.top_k, top_p=args.top_p, temp=args.temp, repeat_penalty=args.repeat_penalty,
    ))
    prompt_ids = vocab.tokenize(args.prompt, bos=True)
    if len(prompt_ids) >= cfg.n_ctx:
        prompt_ids = prompt_ids[: cfg.n_ctx - 1]
    n_predict = min(args.n_tokens, cfg.n_ctx - len(prompt_ids))

    padded, length = model_lib.pad_tokens(prompt_ids, 64)
    t0 = time.perf_counter()
    logits, cache = fwd(params, torch.as_tensor(padded.astype(np.int64), device=device), 0, cache)
    logits = logits[length - 1].cpu().numpy()
    t_prefill = time.perf_counter() - t0
    for t in prompt_ids:
        sampler.observe(t)
        say(vocab.piece_str(t), end="", flush=True)

    n_past = length
    t0 = time.perf_counter()
    for _ in range(n_predict):
        tid = sampler.sample(logits)
        say(vocab.piece_str(tid), end="", flush=True)
        step_logits, cache = fwd(params, torch.tensor([tid], device=device), n_past, cache)
        logits = step_logits[0].cpu().numpy()
        n_past += 1
    dt = time.perf_counter() - t0
    say(
        f"\n[serve] {n_predict} tokens, {n_predict / dt:.2f} tok/s decode, "
        f"prefill {t_prefill:.2f}s (p50 TTFT ~ prefill + 1 step)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
