"""Perplexity CLI over a GGML model and a text corpus (WikiText-2 style).

Usage::

    python -m llama_swift_torch.tools.perplexity --model ggml-model-q4_1.bin \
        --text wiki.test.raw [--n-ctx 512] [--max-windows N] [--device cuda|cpu]

Prints the running ppl per window on stderr and a final JSON summary on
stdout.  The port's copy of ``llama_swift_tpu/tools/perplexity.py``; the
model runs on the CUDA card unless ``--device cpu`` is given.  Scoring uses
exact-f32 prefill products (``prefill_bf16=False``), not the serving bf16
fast path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True, help="raw text file")
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--param-dtype", default=None, choices=[None, "float32", "bfloat16"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..formats.ggml import load_model_file
    from ..models.llama import params_from_tensors, resolve_device
    from ..tokenizer import Vocab
    from ..utils.perplexity import perplexity

    device = resolve_device(args.device)
    mf = load_model_file(args.model, n_ctx=args.n_ctx)
    vocab = Vocab(mf.vocab)
    cfg = dataclasses.replace(mf.config, prefill_bf16=False)
    dtype = getattr(torch, args.param_dtype) if args.param_dtype else None
    params = params_from_tensors(mf.tensors, cfg, device=device, param_dtype=dtype)

    with open(args.text, "rb") as f:
        text = f.read()
    ids = np.asarray(vocab.tokenize(text, bos=False), dtype=np.int64)
    if args.max_windows:
        ids = ids[: args.max_windows * args.n_ctx]
    print(f"tokenized {len(ids)} tokens -> {len(ids) // args.n_ctx} windows", file=sys.stderr)

    def progress(done, total, run_ppl):
        print(f"[{done}/{total}] ppl = {run_ppl:.4f}", file=sys.stderr, flush=True)

    seconds: list = []
    out = perplexity(params, cfg, ids, progress=progress, window_seconds=seconds)
    print(json.dumps({
        "model": args.model, "n_ctx": args.n_ctx, "device": str(device),
        "ppl": round(out["ppl"], 4), "nll": round(out["nll"], 6), "n_scored": out["n_scored"],
        "window_s": seconds,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
