"""Per-shape Q4_0 decode-kernel microbenchmark (the port's counterpart of
``llama_swift_tpu/tools/kernelbench.py``).

Measures the HBM rate each product reaches on each 7B matmul shape, against
the stream probe's rate on the same shape (``ops/q4_matvec.stream_probe``,
a read of the nibble words with almost no compute: the ceiling the card
reaches for this access pattern) and against the H100's nominal 3,350 GB/s.

Usage::

    python -m llama_swift_torch.tools.kernelbench [--iters 50]
        [--shapes attn,qkv,w13,w2,output] [--variants probe,vpu,vpu_raw,dense,phase]
        [--device cuda|cpu]

Variants: ``probe`` (the stream probe; nibble bytes only, as in the JAX
tool), ``vpu`` (``q4_0_matvec``, 4-bit activation codes), ``vpu_raw``
(``q4_0_matvec(quantize_acts=False)``), ``dense`` (one bf16
``torch.matmul`` of one row, 2 bytes a weight) and ``phase``
(``q4_0_matmul_t`` on 8 rows).  The Q4_0 variants count ``out·in/2`` nibble
bytes and ``out·in/8`` bytes of f32 scales.

The shapes are the port's logical ones: w2 is 4096×11008, not the JAX
tool's 4096×11264 (its V layout pads the in-dim to a multiple of 1024), and
the ``phase`` variant keeps that in-dim too (the JAX T layout pads to 4096).

Timing: the JAX tool amortizes its dispatch with ``lax.scan``.  Here the
host queues ``--iters`` launches behind a sleep kernel and CUDA events time
them on the card.  The H100's 50 MB L2 would hold the smaller weights
(attn 8.4 MB, w2 22.5 MB, qkv 25.2 MB), which the TPU has no counterpart
of, so the launches cycle over enough copies of each weight that a pass
over them moves more than 200 MB.  A reading above the nominal rate means
the weights came from a cache, and raises.

The tool runs on the card unless ``--device cpu`` is given; on the CPU it
runs the kernels' plain versions, timed on the host clock, for the tests:
those are CPU numbers, not the card's.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..models.llama import resolve_device
from ..ops.q4_matmul import Q4_0WeightT, q4_0_matmul_t
from ..ops.q4_matvec import Q4_0Weight, q4_0_matvec, stream_probe

#: the H100 SXM's nominal device-memory rate (NVIDIA's data sheet)
H100_HBM_GBPS = 3350.0

#: bytes a pass over a weight's copies must exceed on the card (L2: 50 MB)
SWEEP_BYTES = 2e8

# 7B shapes, logical (no in-dim padding)
SHAPES = {
    "attn": (4096, 4096),  # wq/wk/wv/wo
    "qkv": (12288, 4096),  # fused wqkv
    "w13": (22016, 4096),  # fused w1+w3
    "w2": (4096, 11008),
    "output": (32000, 4096),
}

VARIANTS = ("probe", "vpu", "vpu_raw", "dense", "phase")
PHASE_ROWS = 8


def q4_bytes(out_dim: int, in_dim: int) -> int:
    """Bytes a Q4_0 product streams: nibbles and f32 block scales."""
    return out_dim * in_dim // 2 + out_dim * in_dim // 8


def copies_for(nbytes: int, device: torch.device) -> int:
    """Copies of a weight to cycle over: more than ``SWEEP_BYTES`` on the card."""
    return max(2, math.ceil(SWEEP_BYTES / nbytes)) if device.type == "cuda" else 2


def synth_q4_0(out_dim: int, in_dim: int, n: int, device, seed: int = 0) -> Q4_0Weight:
    """``n`` stacked synthetic Q4_0 weights ``[n, out, in]``, made on the
    device from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    qs = torch.randint(0, 256, (n, out_dim, in_dim // 2), dtype=torch.uint8, device=device, generator=g)
    d = 1e-3 + 1e-3 * torch.rand((n, out_dim, in_dim // 32), device=device, generator=g)
    return Q4_0Weight(qs, d)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Time per call of ``fn(i)``.  On the card: the calls are queued behind
    a sleep kernel and timed with CUDA events (raises if the host took
    longer to queue them than the sleep lasted); on the CPU: the host clock."""
    fn(0)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    sleep, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    sleep.record()
    torch.cuda._sleep(int(1e8))  # tens of ms of device time at H100 clocks
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms > sleep.elapsed_time(start):
        raise RuntimeError(f"time_ms: host queueing ({host_ms:.1f} ms) outlasted the sleep kernel")
    return start.elapsed_time(end) / iters


def bench_shape(name: str, out_dim: int, in_dim: int, iters: int, variants, device: torch.device) -> dict:
    """{variant: GB/s} on one shape."""
    nbytes = q4_bytes(out_dim, in_dim)
    print(f"  shape {name}: [{out_dim} x {in_dim}]  {nbytes / 1e6:.0f} MB/pass")
    n = copies_for(out_dim * in_dim // 2, device)
    w = synth_q4_0(out_dim, in_dim, n, device)
    layers = [w.layer(i) for i in range(n)]
    x = torch.full((in_dim,), 0.01, device=device)
    cases = {  # variant: (fn(i), bytes a call)
        "probe": (lambda i: stream_probe(layers[i % n].qs, i), out_dim * in_dim // 2),
        "vpu": (lambda i: q4_0_matvec(x, layers[i % n]), nbytes),
        "vpu_raw": (lambda i: q4_0_matvec(x, layers[i % n], quantize_acts=False), nbytes),
    }
    if "phase" in variants:
        layers_t = [Q4_0WeightT(lw.qs, lw.d) for lw in layers]
        x8 = torch.full((PHASE_ROWS, in_dim), 0.01, device=device)
        cases["phase"] = (lambda i: q4_0_matmul_t(x8, layers_t[i % n]), nbytes)
    if "dense" in variants:
        nd = copies_for(out_dim * in_dim * 2, device)
        wd = torch.full((nd, out_dim, in_dim), 0.01, dtype=torch.bfloat16, device=device)
        xb = x[None].to(torch.bfloat16)
        cases["dense"] = (lambda i: torch.matmul(xb, wd[i % nd].t()), out_dim * in_dim * 2)
    results = {}
    for v in variants:
        fn, moved = cases[v]
        gbps = moved / (time_ms(fn, iters, device) * 1e-3) / 1e9
        if gbps > H100_HBM_GBPS:
            raise RuntimeError(f"kernelbench: {name}/{v} read {gbps:.0f} GB/s, above the card's "
                               f"{H100_HBM_GBPS:.0f}: the weights came from a cache")
        results[v] = gbps
    probe = results.get("probe")
    for v, gbps in results.items():
        shares = [f"{100 * gbps / probe:.1f}% of the probe"] if probe else []
        if device.type == "cuda":
            shares.append(f"{100 * gbps / H100_HBM_GBPS:.1f}% of the H100's {H100_HBM_GBPS:.0f} GB/s")
        print(f"    -> {v:10s} {gbps:8.1f} GB/s  ({', '.join(shares)})")
    return results


def main(argv=None) -> dict:
    """Returns {shape: {variant: GB/s}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--shapes", type=str, default="attn,qkv,w13,w2,output")
    ap.add_argument("--variants", type=str, default="probe,vpu,vpu_raw,dense",
                    help="comma list: " + ",".join(VARIANTS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"kernelbench: unknown variants {unknown}; known: {', '.join(VARIANTS)}")
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain versions)"
    print(f"device={device} ({name})")
    return {shape: bench_shape(shape, *SHAPES[shape], args.iters, variants, device)
            for shape in args.shapes.split(",")}


if __name__ == "__main__":
    main()
