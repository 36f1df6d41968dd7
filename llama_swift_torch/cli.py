"""Interactive REPL demo — parity with the ``llamaTest`` app
(``llamaTest/main.swift:11-74``): loop reading prompts, stream tokens as they
arrive, print lifecycle transitions.

Usage::

    python -m llama_swift_torch.cli --model /path/to/ggml-model-q4_0.bin \
        [--device cuda] [--n-tokens 512] [--n-ctx 512] [--seed 42] [--prompt "..."]

The PyTorch/CUDA port's copy of ``llama_swift_tpu/cli.py``; ``--device``
defaults to the CUDA card (``--device cpu`` runs the kernels' plain
versions).

The model path may also come from the ``MODEL_PATH`` environment variable
(the reference reads ``LlamaModelPath`` from Info.plist populated by a
``MODEL_PATH`` xcconfig — ``llamaTest/main.swift:11-14``).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import RunnerConfig, SamplingConfig
from .runtime.events import RunState
from .runtime.runner import LlamaRunner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpu-llama interactive demo (PyTorch/CUDA port)")
    ap.add_argument("--model", default=os.environ.get("MODEL_PATH"))
    ap.add_argument("--prompt", default=None, help="one-shot prompt (skip REPL)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-tokens", type=int, default=512)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--temp", type=float, default=0.80)
    ap.add_argument("--repeat-penalty", type=float, default=1.30)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--reverse-prompt", default=None)
    ap.add_argument("--color", action="store_true",
                    help="distinguish prompt echo (bold) from generated text "
                         "(green), like the reference's use_color flag")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="consume the prompt in n_batch chunks (reference "
                         "behavior) instead of one padded prefill")
    ap.add_argument("--n-batch", type=int, default=8)
    args = ap.parse_args(argv)

    if not args.model:
        print("Model path not specified - define in MODEL_PATH or --model")
        return 1
    if not os.path.exists(args.model):
        print("Invalid model path, make sure this is a file path")
        return 1

    config = RunnerConfig(
        num_tokens=args.n_tokens,
        reverse_prompt=args.reverse_prompt,
        n_ctx=args.n_ctx,
        chunked_prefill=args.chunked_prefill,
        sampling=SamplingConfig(
            seed=args.seed, top_k=args.top_k, top_p=args.top_p, temp=args.temp,
            repeat_penalty=args.repeat_penalty, repeat_last_n=args.repeat_last_n,
            n_batch=args.n_batch,
        ),
    )
    runner = LlamaRunner(args.model, n_ctx=args.n_ctx, device=args.device)

    def on_state(state: RunState):
        if state == RunState.INITIALIZING:
            print("Initializing model... ", end="", flush=True)
        elif state == RunState.GENERATING_OUTPUT:
            print("Done.\n\nGenerating output...")
            print('"', end="", flush=True)
        elif state == RunState.COMPLETED:
            print('"\n')
            stats = runner.stats
            if "decode_tok_per_s" in stats:
                print(
                    f"[{stats.get('generated_tokens', 0)} tokens, "
                    f"{stats['decode_tok_per_s']:.2f} tok/s decode, "
                    f"prefill {stats.get('t_prefill_s', 0):.2f}s]"
                )

    def run_one(prompt: str) -> None:
        failed = {}
        seen = {"n": 0}

        def on_state_or_fail(state: RunState):
            if state == RunState.FAILED:
                failed["x"] = True
            on_state(state)

        def emit(t: str):
            if args.color:
                n_prompt = runner.stats.get("prompt_tokens", 0)
                style = "\033[1m" if seen["n"] < n_prompt else "\033[32m"
                print(f"{style}{t}\033[0m", end="", flush=True)
            else:
                print(t, end="", flush=True)
            seen["n"] += 1

        runner.run_with_callback(
            prompt,
            config,
            token_handler=emit,
            state_change_handler=on_state_or_fail,
        )
        if failed:
            print("\nFailed to generate output")

    if args.prompt is not None:
        run_one(args.prompt)
        return 0

    while True:
        try:
            prompt = input("Enter prompt: ").strip()
        except EOFError:
            break
        if not prompt:
            break
        run_one(prompt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
