"""Time launch plans of the dense batched flash-decode kernel
(``flash_decode_batched`` in ``csrc/flash_decode.cu``) on one card, beside
the paged kernel on the same keys.

    python -m llama_swift_torch.tools.flash_variants [--iters 100] [--kinds ...] [--cases ...]

A plan is ``(max_splits, stage_bytes)``: at most that many splits a
(slot, head), tiles of ``stage_bytes / 2`` of K rows through the kernel's
ring of two stages.  The C entry takes the splits and the tile as
arguments, so no rebuild: this tool launches it itself (``variant_plan``),
and plans whose shared memory the launcher refuses are skipped.  Cases: 32
heads of 128 dims on f32, bf16 and int8 caches of 4 layers, timed round
robin over the layers, at B = 8 (the engine's step, n_ctx 512), B = 16
(n_ctx 512), B = 8 and 16 at n_ctx 2048 with a slot at its last key, B =
4 and B = 1 (``--cases`` picks).  The wrapper's own plan
(``ops/attention.batched_plan``, ``max_splits`` None) runs first and last
in each case (a drift check); every plan's output is held to the plain
version within 1e-5.  One JSON line a (case, plan), then a line with the
fastest plan of each case.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..models.llama import quantize_kv
from ..ops import attention as att
from ..ops import build
from .kernelbench import time_ms

#: (name, n_pasts, n_ctx): the slots' positions of each case
CASES = [
    ("B8_ctx512", [0, 63, 64, 127, 200, 311, 511, 5], 512),
    ("B16_ctx512", [0, 63, 64, 127, 200, 311, 511, 5, 31, 400, 256, 1, 450, 99, 64, 383], 512),
    ("B8_ctx2048", [0, 255, 256, 511, 800, 1244, 2047, 20], 2048),
    ("B16_ctx2048", [0, 255, 256, 511, 800, 1244, 2047, 20, 1500, 100, 1023, 1024, 3, 600, 1900, 333], 2048),
    ("B4_ctx512", [511, 0, 200, 63], 512),
    ("B1_ctx2048", [2047], 2048),
]
SPLITS = (1, 2, 4, 8)
KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the C entry's ``kind``
STAGE_BYTES = (8192, 16384, 32768, 65536)


def _caches(kind: str, B: int, n_ctx: int, L: int, H: int, dh: int, g):
    """K and V caches [L, B, H, n_ctx, dh] (int8: codes by the port's write
    and their row scales) and their paged form (pages of 128, each slot's
    pages in order): (dense, pools, table)."""
    k = torch.randn((L, B, H, n_ctx, dh), device="cuda", generator=g)
    v = torch.randn((L, B, H, n_ctx, dh), device="cuda", generator=g)
    if kind == "int8":
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        dense = [k8, v8, ks, vs]
    else:
        dense = [k.to(getattr(torch, kind)), v.to(getattr(torch, kind))]
    del k, v
    page, mp = 128, n_ctx // 128
    table = torch.arange(B * mp, dtype=torch.int32, device="cuda").reshape(B, mp)
    pools = [t.reshape(L, B, t.shape[2], mp, page, t.shape[-1]).permute(1, 3, 0, 2, 4, 5)
             .reshape(B * mp, L, t.shape[2], page, t.shape[-1]).contiguous() for t in dense]
    return dense, pools, table


def variant_plan(dh: int, elt: int, n_keys: int, max_splits: int, stage_bytes: int) -> tuple[int, int]:
    """``(splits, tile)`` of a plan: ``split_plan(n_keys, max_splits)``
    splits, tiles of ``stage_bytes / 2`` of K rows or the longest split's
    keys if fewer (as ``ops/attention.batched_plan`` cuts its own)."""
    splits = att.split_plan(n_keys, max_splits)[0]
    keys = att.split_plan(n_keys, splits)[1]
    return splits, min(att.pass_tile_rows(dh * elt, stage_bytes), keys, att.MAX_TILE)


def launch(q, dense, il: int, n_pasts, max_np: int, splits: int, tile: int):
    """One launch of the batched kernel on layer ``il`` with ``splits`` and
    ``tile``, or None where the launcher refuses the plan."""
    k, v, *scales = dense
    B, H, n_ctx, dh = k.shape[1:]
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode_batched(
        q.data_ptr(), k[il].data_ptr(), v[il].data_ptr(), *([s[il].data_ptr() for s in scales] or [None, None]),
        n_pasts.data_ptr(), out.data_ptr(), B, H, n_ctx, dh, max_np + 1, splits, tile, 1.0 / math.sqrt(dh),
        KIND[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    return out if code == 0 else None


def run_case(name: str, n_list, n_ctx: int, kind: str, iters: int, L: int = 4, H: int = 32, dh: int = 128) -> list:
    g = torch.Generator(device="cuda").manual_seed(len(n_list) + n_ctx)
    B, max_np = len(n_list), max(n_list)
    dense, pools, table = _caches(kind, B, n_ctx, L, H, dh, g)
    q = torch.randn((B, H, dh), device="cuda", generator=g)
    n_pasts = torch.tensor(n_list, dtype=torch.int32, device="cuda")
    s = "_int8" if kind == "int8" else ""
    ref = getattr(att, f"flash_decode_attention_batched{s}_plain")(q, *dense, 1, n_pasts, max_np)
    elt = dense[0].element_size()
    own = att.batched_plan(B, H, dh, elt, max_np + 1, torch.cuda.get_device_properties(0).multi_processor_count)
    default = (None, att.BATCHED_STAGE_BYTES, own.splits, own.tile)
    plans = [default] + [(sp, sb, *variant_plan(dh, elt, max_np + 1, sp, sb)) for sp in SPLITS
                         for sb in STAGE_BYTES] + [default]
    keys = sum(n + 1 for n in n_list)
    base = {"case": name, "cache": kind, "B": B, "n_ctx": n_ctx, "keys": keys}
    recs = []
    for sp, sb, splits, tile in plans:
        first = launch(q, dense, 1, n_pasts, max_np, splits, tile)
        if first is None:
            continue

        def call(i, splits=splits, tile=tile):
            return launch(q, dense, i % L, n_pasts, max_np, splits, tile)

        err = float((first - ref).abs().max() / ref.abs().max())
        rec = dict(base, max_splits=sp, stage_bytes=sb, splits=splits, tile=tile,
                   us=time_ms(call, iters, q.device) * 1e3, max_rel_err=err, ok=err <= 1e-5)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    paged = getattr(att, f"flash_decode_attention_paged{s}")
    rec = dict(base, kernel="paged", page=128,
               us=time_ms(lambda i: paged(q, *pools, table, i % L, n_pasts, max_np), iters, q.device) * 1e3)
    print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--kinds", default="float32,bfloat16,int8")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES), help="names from CASES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device (it times the card's kernels)")
    ok, best = True, []
    for kind in args.kinds.split(","):
        for name, n_list, n_ctx in (c for c in CASES if c[0] in args.cases.split(",")):
            recs = run_case(name, n_list, n_ctx, kind, args.iters)
            ok = ok and all(r["ok"] for r in recs)
            fastest = min(recs, key=lambda r: r["us"])
            best.append({k: fastest[k] for k in ("case", "cache", "max_splits", "stage_bytes", "us")})
            torch.cuda.empty_cache()
    print(json.dumps({"fastest": best, "device": torch.cuda.get_device_name(0), "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
