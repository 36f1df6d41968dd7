#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``llama_swift_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # all phases; exits 0 only if all pass
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --only q4_1     # build + kernel checks + the Q4_1 phases (3c, 5)
    python3 chip_smoke.py --only tp       # build + kernel checks + the TP phases (4e)
    python3 chip_smoke.py --only int      # build + kernel checks + paths A and B (4f, 4g)
    python3 chip_smoke.py --only bench    # build + kernel checks + the kernelbench path (2b)
    python3 chip_smoke.py --profile       # adds profiled decode and engine-step windows

Phases:

1. identify the card (name and power limit from nvidia-smi), build the
   CUDA kernels from ``llama_swift_torch/csrc`` (one nvcc per source, all
   started together) and the native host library (g++, ``native/``);
2. hold each kernel against its plain PyTorch version on
   the card at the 7B shapes of the serving paths, and time kernel, plain
   version, bound and (where one exists) a single PyTorch call computing
   the same function; the int8 flash kernels read caches written by the
   port's own int8 write, with stale codes and huge scales beyond n_past;
   batch-1 flash decode also at n_ctx 2048 and its kernel launches a call
   from a profiler window (one); the whole-stack kernel runs 2 layers at
   n_past 0, 127 and 511 on f32 and bf16 caches, then all 32 layers of one
   token on both caches at n_past 127 and 511 (see
   ``check_fused_kernel`` for how 4-bit activation flips are counted); the
   Q4_1 matvec at the four matvec shapes and the Q4_1 dequant (bf16, f32,
   bit-exact) at 11008x4096, on weights whose mins centre them near zero;
   the three f32-activation kernels (Q4_0 and Q4_1 matvec, Q4_0 multi-row
   at B = 2, 8, 32) at the four matvec shapes and the fused 12288x4096 and
   22016x4096, beside the dequant + matmul pair they replace; the T
   layout's product (``q4_0_matmul_t``) at the four matvec shapes with
   N = 1, 8, 33, 64, beside the same pair; the stream probe
   (``stream_probe``) at kernelbench's five shapes, every row bit-equal,
   beside ``torch.sum(words, dtype=int32)``;
2b. the kernelbench path (``tools/kernelbench.main``, every variant at its
   five shapes; see ``run_kernelbench``): the stream probe's launches come
   from here, with each product's GB/s against the probe's on its shape;
3. whole-path parity at full 7B width and 2 layers: card vs CPU (the
   kernels' plain versions), decode logits within 2e-3 relative (the repo's
   hardware parity bar, bench.py's ``--check``) with f32 prefill, and bf16
   prefill logits within 0.25 (see ``check_parity``); then the same over an
   int8 cache (``check_parity_int8``): within 2e-3 with f32 activations
   (exactly the f32-activation kernels' launches, no dequant), and
   with 4-bit activations on a run with no activation-quantization flip,
   the flips and the int8 codes that differ between the devices counted;
   then on fused wqkv/w13 params (``check_parity_fused``), f32 and bf16
   caches, each card decode step exactly one whole-stack launch and one
   matvec;
3b. batched parity at 7B width and 2 layers: slot prefills of 3 slots, then
   4 ``forward_batched`` steps at B=8, dense and paged caches, f32 and int8,
   card vs CPU within 2e-3 (with f32 activations every product on the
   f32-activation multi-row kernel; see ``check_batched_parity`` for how
   activation-quantization flips are told apart); the card's batched rows
   are also held against batch-1 ``decode_step`` of the same slot state;
3c. Q4_1 parity at 7B width and 2 layers (``check_parity_q4_1``): an
   8-token prefill, slot prefills of 3 slots, 4 decode steps and 2
   ``forward_batched`` steps at B=8, card vs CPU: within 2e-3 with f32
   activations, and with Q4_1 activations wherever no 4-bit activation
   flip occurred (flips counted per output; the steps continue from the
   CPU's caches); each decode step exactly 15 Q4_1 matvec launches (of the
   f32-activation matvec with f32 activations) and each batched step 15
   Q4_1 dequant launches;
4. serve four requests through ``LlamaRunner`` on a synthetic 32-layer 7B
   Q4_0 GGML file written from a seed, after timing its load through the
   Python reader and through the native mapping (``load_paths``); the
   runners load through the mapping (three on the f32 cache, the fourth
   with ``runner.config.kv_cache_dtype = "int8"``), with the launch counters
   reset just before and read just after, and checked against 225 matvec
   and 32 flash (f32) or int8 flash launches per decoded token and 225
   dequant launches per prefill; the same file is also loaded with fused
   params, and kept for 4e;
4b. serve four waves through the continuous-batching ``Engine`` on the same
   params: A, 12 requests through 8 slots of a dense f32 cache; B, 8 through
   8 slots of a paged bf16 cache (half of them seeded, so the host sampler
   runs too); C, 20 through 16 slots of a dense int8 cache; D, 8 (half
   seeded) through 8 slots of a paged int8 cache.  Counters reset before
   and read after each wave, and checked against 225 multi-row matmul and
   32 flash launches of the wave's kernel per engine decode step, 225
   dequant launches per prefill chunk, and no other launch; every stream
   completes and every page comes back;
4c. f32 activations on the same params (``serve_f32_acts``): one runner
   request with ``quantize_activations = False`` (225 f32-activation matvec
   launches a token, 225 dequant a prefill) and wave G, wave A's shape
   (225 f32-activation multi-row launches a step), each with a profiled
   window for its idle share; then a seeded ``rng_impl="mt19937"``
   host-sampled request twice: the same tokens, through the native sampler;
4d. on the fused params: two requests through ``LlamaRunner`` (greedy on an
   f32 cache, sampled on a bf16 cache), each decoded token exactly one
   whole-stack launch and one matvec, each prefill 129 (4·32 + 1) dequant
   launches; then wave E, wave A's shape (12 requests, 8 dense f32 slots),
   129 multi-row launches per step and 129 dequant per chunk; then path B
   (``decode_r4``);
4h. dense-dequant params (``params_from_tensors(dense_dequant=True)``): 2-layer
   parity at 7B width, card vs CPU in bf16 within 2e-3, one dequant launch a
   packed tensor at load and no Q4 kernel in the forwards
   (``check_parity_dense``); the 7B file loaded dense in bf16, a prompt and 32
   greedy tokens through ``greedy_decode_loop``, and ``profiling.trace``
   around one more step (``serve_dense``); then ggml ops and an Adam run on
   the card against the CPU within 1e-5 (``check_aux``);
4e. tensor parallelism, once the earlier runners are gone: TP parity at 7B
   width and 2 layers (``check_tp_parity``), in a real NCCL group of one:
   ``make_tp_forward`` on the V layout (fused) and on the T layout
   (shard_pad=128, unfused and fused) against the same forward on the CPU
   without a group, a 64-row prefill and 4 decode steps, within 1e-5 with
   f32 activations; with 4-bit ones the CPU quantizes the card's product
   inputs, and logits and inputs are within 2e-3 (no flip exempted); every T-layout
   forward exactly 7·L + 1 (fused 4·L + 1) T kernel launches; then the TP
   serving paths on the 7B file (``serve_tp``):
   ``llama_swift_torch.serve.main`` in this process
   (tp = 1 over its own NCCL group, 32 seeded tokens; 129 matvec and 32
   flash launches a token, 129 dequant for the prefill), then the T-layout
   TP forward (params with shard_pad=128): a 64-row prefill and 32 greedy
   tokens, 225 T kernel launches a forward and no dequant; the file is
   then removed;
5. a synthetic 32-layer 7B Q4_1 file (5.05 GB, written from a seed once
   the Q4_0 runners are gone, see ``serve_q4_1``): the port's perplexity
   tool scores 2 windows of 512 tokens of README.md (225 Q4_1 dequant
   launches a window); two requests through ``LlamaRunner`` (f32 and int8
   caches; 225 Q4_1 matvec and 32 flash launches a token, 225 Q4_1 dequant
   a prefill, no Q4_0 kernel), one on fused Q4_1 params (129 matvec a
   token, no whole-stack launch, 129 dequant a prefill) and engine wave F
   (8 requests through 4 dense f32 slots, 16 tokens each: 225 Q4_1 dequant
   launches a step and a chunk, no multi-row launch) and one request with
   f32 activations (225 f32-activation Q4_1 matvec launches a token) with
   its profiled window; ``perplexity_of_text`` against the tokenized call
   on the same README text; with ``--profile``
   8-step windows of Q4_1 batch-1 decode and of a Q4_1 engine step (B = 4);
6. print the kernel table as one JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.

There is no CPU mode: without a CUDA device the script exits nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, published
INT8_OPS = 1979e12  # H100 SXM int8 tensor rate, published

BF16_PREFILL_BAR = 0.25
MATVEC_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
F32_SHAPES = MATVEC_SHAPES + [(12288, 4096), (22016, 4096)]  # and fused wqkv, w13
F32_MULTI_ROWS = [2, 8, 32]
FLASH_NPAST = [0, 63, 64, 127, 128, 511]  # 63/64: a split edge of the batched kernels
MULTI_ROWS = 8  # the engine's slots
BATCHED_NPASTS = [0, 63, 64, 127, 200, 311, 511, 5]  # per slot, at n_ctx 512
BATCHED_NPASTS_16 = BATCHED_NPASTS + [31, 400, 256, 1, 450, 99, 64, 383]  # wave C's 16 slots
STALE_CODE, STALE_SCALE = 127, 1e3  # int8 rows beyond n_past: never to be attended
PROMPTS = [
    "The rain in Spain stays mainly in the plain",
    "Once upon a time, in a land far away,",
    "import numpy as np",
]


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(torch, fn, iters: int) -> float:
    """Device time per call: the host queues ``iters`` calls behind a sleep
    kernel, so CUDA events around them measure the card, not the Python
    launch overhead.  Raises if the host took longer to queue the calls
    than the sleep lasted (the events would then include host gaps)."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep = torch.cuda.Event(enable_timing=True)
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


def launches_per_call(torch, fn, calls: int = 4, windows: int = 3) -> float:
    """Kernel launches a call of ``fn(i)``: device kernel events in a
    ``torch.profiler`` window of ``calls`` calls, after a warm-up call.  A
    window that shows fewer than the calls made lost records (the wrapper
    raises on a launch that fails), so up to ``windows`` windows are taken
    until one shows a whole number; returns the last window's count, which
    the caller holds to 1."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    per_call = 0.0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(1, calls + 1):
                fn(i)
            torch.cuda.synchronize()
        kernels = {ev.key: ev.count for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA}
        n = sum(kernels.values())
        per_call = n / calls
        log({"case": "launches_window", "calls": calls, "kernels": kernels})
        if n % calls == 0:
            break
    return per_call


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# synthetic 7B Q4_0 weights from a seed
# ---------------------------------------------------------------------------


def synthetic_tensors(cfg, seed: int):
    """(name, tensor) in loader naming: Q4_0 (or, for ``cfg.ftype`` Q4_1,
    Q4_1) 2-D weights with uniform random nibbles and scales sized so that
    W·x keeps the activation scale (``std(n-8) ≈ 4.6``; Q4_1 mins ``−8·d·U(0.8,
    1.2)`` centre the values near zero, as real Q4_1 weights are); f32
    norms near 1."""
    from llama_swift_torch.config import GGMLType
    from llama_swift_torch.formats.ggml import expected_tensor_shapes
    from llama_swift_torch.formats.quant import Q4_0Tensor, Q4_1Tensor

    rng = np.random.default_rng(seed)
    for name, shape in expected_tensor_shapes(cfg).items():
        if len(shape) == 1:
            yield name, (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
            continue
        rows, cols = shape
        qs = rng.integers(0, 256, size=(rows, cols // 2), dtype=np.uint8)
        base = 1.0 if "tok_embeddings" in name else 1.0 / (4.6 * math.sqrt(cols))
        d = (base * rng.uniform(0.5, 1.5, size=(rows, cols // 32))).astype(np.float32)
        if cfg.ftype == GGMLType.Q4_1:
            m = (-8.0 * d * rng.uniform(0.8, 1.2, size=d.shape)).astype(np.float32)
            yield name, Q4_1Tensor(mins=m, scales=d, qs=qs)
        else:
            yield name, Q4_0Tensor(scales=d, qs=qs)


def vocab_pieces(n_vocab: int) -> list:
    """Specials, printable ASCII, a few merges, fillers; the last 161 ids are
    the other single bytes, so that any text tokenizes to its end (the
    reference's tokenizer stops at the first byte it cannot match)."""
    pieces = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(32, 127)]
    pieces += [b" the", b"the", b"in", b"ing", b" a", b"on", b"er", b" s"]
    rest = [bytes([b]) for b in range(256) if not 32 <= b < 127]
    pieces += [f"<x{i}>".encode() for i in range(n_vocab - len(pieces) - len(rest))]
    return pieces + rest


def write_model(path: str, cfg, seed: int) -> None:
    from llama_swift_torch.formats import ggml

    with open(path, "wb") as f:
        ggml.write_header(f, cfg)
        ggml.write_vocab(f, vocab_pieces(cfg.n_vocab))
        for name, t in synthetic_tensors(cfg, seed):
            ggml.write_tensor_record(f, name, t)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at 7B shapes
# ---------------------------------------------------------------------------


def rand_q4(torch, g, n, out, in_dim):
    """A stack of ``n`` random Q4_0 weights ``[out, in_dim]`` on the card,
    scaled so that W·x keeps the activation scale."""
    from llama_swift_torch.ops.q4_matvec import Q4_0Weight

    qs = torch.randint(0, 256, (n, out, in_dim // 2), dtype=torch.uint8, device="cuda", generator=g)
    d = torch.rand((n, out, in_dim // 32), device="cuda", generator=g) * (2.0 / (4.6 * math.sqrt(in_dim)))
    return Q4_0Weight(qs, d)


def rand_q4_1(torch, g, n, out, in_dim):
    """A stack of ``n`` random Q4_1 weights: nibbles and d as ``rand_q4``,
    ``m ≈ −8·d·U(0.8, 1.2)``."""
    from llama_swift_torch.ops.q4_matvec import Q4_1Weight

    w = rand_q4(torch, g, n, out, in_dim)
    m = -8.0 * w.d * (0.8 + 0.4 * torch.rand(w.d.shape, device="cuda", generator=g))
    return Q4_1Weight(w.qs, torch.stack([w.d, m], dim=-1).contiguous())


def check_q4_1_kernels(torch, g, summary) -> list:
    """The Q4_1 matvec against its plain version at the four matvec shapes
    (≤ 1e-5 of max |y|: the kernel sums integer block dots, the plain version
    f32 products of rounded x̂), and the Q4_1 dequant bit-exact at 11008x4096
    in bf16 and f32.  Returns the cases that disagree.  No single PyTorch
    call computes either function, so ``library_ms`` is None."""
    from llama_swift_torch.ops import q4_dequant as dq
    from llama_swift_torch.ops import q4_matvec as mv

    failed = []
    for out, in_dim in MATVEC_SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 8
        n = max(2, math.ceil(2e8 / wbytes))  # a round robin streams > 200 MB (cold L2)
        w = rand_q4_1(torch, g, n, out, in_dim)
        x = torch.randn(in_dim, device="cuda", generator=g)
        y = mv.q4_1_matvec(x, w.layer(0))
        ref = mv.q4_1_matvec_plain(x, w.layer(0))
        err = rel_err(y, ref)
        nbytes = wbytes + in_dim * 4 + out * 4
        case = {"case": "q4_1_matvec", "out": out, "in": in_dim, "max_rel_err": err,
                "max_abs_err": float((y - ref).abs().max()),
                "kernel_ms": time_ms(torch, lambda i: mv.q4_1_matvec(x, w.layer(i % n)), 200),
                "plain_ms": time_ms(torch, lambda i: mv.q4_1_matvec_plain(x, w.layer(i % n)), 5),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, 4 * out * in_dim / INT8_OPS) * 1e3,
                "library_ms": None, "ok": err <= 1e-5}
        log(case)
        if not case["ok"]:
            failed.append(case)
        if (out, in_dim) == (11008, 4096):
            summary["q4_1_matvec"] = dict(case, bound_by="bytes", shape=f"{out}x{in_dim}")
        del w
    out, in_dim = 11008, 4096
    w = rand_q4_1(torch, g, 4, out, in_dim)
    for dtype in (torch.bfloat16, torch.float32):
        dense = dq.q4_1_dequant(w.layer(0), dtype)
        ref = dq.dequantize_q4_1(w.layer(0), dtype)
        exact = bool(torch.equal(dense, ref))
        nbytes = out * in_dim // 2 + out * (in_dim // 32) * 8 + out * in_dim * dense.element_size()
        case = {"case": "q4_1_dequant", "dtype": str(dtype).split(".")[-1], "out": out, "in": in_dim,
                "exact": exact, "max_abs_err": float((dense.float() - ref.float()).abs().max()),
                "kernel_ms": time_ms(torch, lambda i: dq.q4_1_dequant(w.layer(i % 4), dtype), 50),
                "plain_ms": time_ms(torch, lambda i: dq.dequantize_q4_1(w.layer(i % 4), dtype), 5),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, 2 * out * in_dim / F32_FLOPS) * 1e3,
                "library_ms": None, "ok": exact}
        log(case)
        if not exact:
            failed.append(case)
        if dtype == torch.bfloat16:
            summary["q4_1_dequant"] = dict(case, bound_by="bytes", shape=f"{out}x{in_dim} bf16")
    del w
    torch.cuda.empty_cache()
    return failed


def check_f32_kernels(torch, g, summary) -> list:
    """The three f32-activation kernels (the Q4_0 and Q4_1 matvecs and the
    Q4_0 multi-row matmul on unquantized rows) against their plain versions
    at ``F32_SHAPES`` (the multi-row kernel at B in ``F32_MULTI_ROWS``),
    within 1e-5 of max |y|.  Beside kernel, plain and bound times, the
    dequant + ``torch.matmul`` pair that these kernels replace on this path
    is timed as ``replaced_ms`` (no single PyTorch call computes the
    function, so ``library_ms`` is None).  The bound is the larger of the
    bytes and the f32 work (2·B operations a weight); ``bound_by`` says
    which.  Returns the cases that disagree."""
    from llama_swift_torch.ops import q4_dequant as dq
    from llama_swift_torch.ops import q4_matvec as mv

    failed = []
    for q41 in (False, True):
        for out, in_dim in F32_SHAPES:
            wbytes = out * in_dim // 2 + out * (in_dim // 32) * (8 if q41 else 4)
            n = max(2, math.ceil(2e8 / wbytes))  # a round robin streams > 200 MB (cold L2)
            w = (rand_q4_1 if q41 else rand_q4)(torch, g, n, out, in_dim)
            deq = dq.q4_1_dequant if q41 else dq.q4_0_dequant
            for rows in [1] if q41 else [1] + F32_MULTI_ROWS:
                x = torch.randn((rows, in_dim), device="cuda", generator=g)
                xr = x[0] if rows == 1 else x
                if q41:
                    name = "q4_1_matvec_f32"
                    fn = lambda i: mv.q4_1_matvec_f32(xr, w.layer(i % n))  # noqa: E731
                    plain = lambda i: mv.q4_1_matvec_plain(xr, w.layer(i % n), quantize_acts=False)  # noqa: E731
                elif rows == 1:
                    name = "q4_0_matvec_f32"
                    fn = lambda i: mv.q4_0_matvec_f32(xr, w.layer(i % n))  # noqa: E731
                    plain = lambda i: mv.q4_0_matvec_f32_plain(xr, w.layer(i % n))  # noqa: E731
                else:
                    name = "q4_0_matmul_multi_f32"
                    fn = lambda i: mv.q4_0_matmul_multi_f32(xr, w.layer(i % n))  # noqa: E731
                    plain = lambda i: mv.q4_0_matmul_multi_f32_plain(xr, w.layer(i % n))  # noqa: E731
                y, ref = fn(0), plain(0)
                err = rel_err(y, ref)
                t_bytes = (wbytes + rows * in_dim * 4 + rows * out * 4) / HBM_BYTES_PER_S
                t_ops = 2 * rows * out * in_dim / F32_FLOPS
                case = {"case": name, "rows": rows, "out": out, "in": in_dim, "max_rel_err": err,
                        "max_abs_err": float((y - ref).abs().max()),
                        "kernel_ms": time_ms(torch, fn, 200), "plain_ms": time_ms(torch, plain, 3),
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "replaced_ms": time_ms(torch, lambda i: xr @ deq(w.layer(i % n), torch.float32).t(), 20),
                        "library_ms": None, "ok": err <= 1e-5}
                log(case)
                if not case["ok"]:
                    failed.append(case)
                if (out, in_dim) == (11008, 4096) and rows in (1, MULTI_ROWS):
                    summary[name] = dict(case, shape=(f"B{rows} " if rows > 1 else "") + f"{out}x{in_dim}")
            del w
            torch.cuda.empty_cache()
    return failed


T_ROWS = [1, 8, 33, 64]


def check_t_kernel(torch, g, summary) -> list:
    """Row 10, ``q4_0_matmul_t`` (the T layout's product of 1–64 f32 rows),
    against its plain version at the four matvec shapes and N in
    ``T_ROWS``, within 1e-5 of max |y|.  Beside kernel, plain and bound
    times, the dequant + ``torch.matmul`` pair that the JAX package's
    alternative is (the path above 64 rows) is timed as ``replaced_ms``; no
    single PyTorch call reads Q4_0, so ``library_ms`` is None.  The bound is
    the larger of the bytes (0.625 a weight, x and y) and the f32 work
    (2·N operations a weight); ``bound_by`` says which.  Returns the cases
    that disagree."""
    from llama_swift_torch.ops import q4_dequant as dq
    from llama_swift_torch.ops import q4_matmul as qm

    failed = []
    for out, in_dim in MATVEC_SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))  # a round robin streams > 200 MB (cold L2)
        base = rand_q4(torch, g, n, out, in_dim)
        w = qm.Q4_0WeightT(base.qs, base.d)
        for rows in T_ROWS:
            x = torch.randn((rows, in_dim), device="cuda", generator=g)
            fn = lambda i: qm.q4_0_matmul_t(x, w.layer(i % n))  # noqa: E731
            plain = lambda i: qm.q4_0_matmul_t_plain(x, w.layer(i % n))  # noqa: E731
            y, ref = fn(0), plain(0)
            err = rel_err(y, ref)
            t_bytes = (wbytes + rows * in_dim * 4 + rows * out * 4) / HBM_BYTES_PER_S
            t_ops = 2 * rows * out * in_dim / F32_FLOPS
            case = {"case": "q4_0_matmul_t", "rows": rows, "out": out, "in": in_dim, "max_rel_err": err,
                    "max_abs_err": float((y - ref).abs().max()),
                    "kernel_ms": time_ms(torch, fn, 100), "plain_ms": time_ms(torch, plain, 10),
                    "bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "replaced_ms": time_ms(torch, lambda i: x @ dq.q4_0_dequant(w.layer(i % n), torch.float32).t(),
                                           10),
                    "library_ms": None, "ok": err <= 1e-5}
            log(case)
            if not case["ok"]:
                failed.append(case)
            if (out, in_dim, rows) == (11008, 4096, 1):
                summary["q4_0_matmul_t"] = dict(case, shape=f"N{rows} {out}x{in_dim}")
        del w, base
        torch.cuda.empty_cache()
    return failed


INT_ROWS = [1, 8, 33, 64]


def check_int_t_kernels(torch, g, summary) -> list:
    """Row 12, ``q4_0_int_matmul`` (the exact int4×int4 T product on the int8
    tensor cores), at the four matvec shapes and N in ``INT_ROWS``, and row
    13, ``q4_0_t_matmul_multi`` (the multi-row T product on the V layout's
    kernels), at B = 8 on the four shapes and B = 1 and 32 at 11008x4096,
    with 4-bit and f32 activations; each within 1e-5 of max |y| of its plain
    version.  Beside row 12, row 10 (``q4_0_matmul_t``, what serving takes at
    these rows) on the same rows, fake-quantized, is timed as
    ``replaced_ms``; no PyTorch call applies per-block scales to an int8
    product (``torch._int_mm`` has none), so ``library_ms`` is None.  The
    bound is the larger of the bytes (0.625 a weight, x and y in f32) and
    the work (2·N operations a weight at the int8 rate, or the f32 rate for
    f32 rows); ``bound_by`` says which.  Returns the cases that disagree."""
    from llama_swift_torch.ops import q4_matmul as qm
    from llama_swift_torch.ops import quantized_matmul as qmm

    failed = []

    def measure(case, fn, plain, rows, out, in_dim, wbytes, ops_rate, iters, plain_iters):
        y, ref = fn(0), plain(0)
        err = rel_err(y, ref)
        t_bytes = (wbytes + rows * in_dim * 4 + rows * out * 4) / HBM_BYTES_PER_S
        t_ops = 2 * rows * out * in_dim / ops_rate
        case.update(max_rel_err=err, max_abs_err=float((y - ref).abs().max()),
                    kernel_ms=time_ms(torch, fn, iters), plain_ms=time_ms(torch, plain, plain_iters),
                    bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, ok=err <= 1e-5)
        return case

    for out, in_dim in MATVEC_SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))  # a round robin streams > 200 MB (cold L2)
        base = rand_q4(torch, g, n, out, in_dim)
        w = qm.Q4_0WeightT(base.qs, base.d)
        for rows in INT_ROWS:
            x = torch.randn((rows, in_dim), device="cuda", generator=g)
            xq = qmm.fake_quantize_q4_0(x)
            case = measure({"case": "q4_0_int_matmul", "rows": rows, "out": out, "in": in_dim},
                           lambda i: qm.q4_0_int_matmul(x, w.layer(i % n)),
                           lambda i: qm.q4_0_int_matmul_plain(x, w.layer(i % n)),
                           rows, out, in_dim, wbytes, INT8_OPS, 100, 3)
            case["replaced_ms"] = time_ms(torch, lambda i: qm.q4_0_matmul_t(xq, w.layer(i % n)), 50)
            log(case)
            if not case["ok"]:
                failed.append(case)
            if (out, in_dim, rows) == (11008, 4096, 64):
                summary["q4_0_int_matmul"] = dict(case, shape=f"N{rows} {out}x{in_dim}")
        for rows in [1, 8, 32] if (out, in_dim) == (11008, 4096) else [8]:
            x = torch.randn((rows, in_dim), device="cuda", generator=g)
            for quantize in (True, False):
                case = measure({"case": "q4_0_t_matmul_multi", "rows": rows, "quantize_acts": quantize, "out": out,
                                "in": in_dim},
                               lambda i: qm.q4_0_t_matmul_multi(x, w.layer(i % n), quantize_acts=quantize),
                               lambda i: qm.q4_0_t_matmul_multi_plain(x, w.layer(i % n), quantize_acts=quantize),
                               rows, out, in_dim, wbytes, INT8_OPS if quantize else F32_FLOPS, 100, 3)
                log(case)
                if not case["ok"]:
                    failed.append(case)
                if (out, in_dim, rows, quantize) == (11008, 4096, MULTI_ROWS, True):
                    summary["q4_0_t_matmul_multi"] = dict(case, shape=f"B{rows} {out}x{in_dim}")
        del w, base
        torch.cuda.empty_cache()
    return failed


def check_stream_probe(torch, g, summary) -> list:
    """Row 14, the HBM stream probe, at kernelbench's five shapes: every
    row's sum bit-equal to the plain version's; timed over a round robin of
    copies that streams more than 200 MB (the H100's L2 holds 50 MB), beside
    the plain version and ``torch.sum(words, dim=1, dtype=torch.int32)``
    (the one PyTorch call that reads the same words).  Bytes-bound: one
    integer add per 4 bytes read."""
    from llama_swift_torch.ops import q4_matvec as mv
    from llama_swift_torch.tools import kernelbench as kb

    failed = []
    for name, (out, in_dim) in kb.SHAPES.items():
        nib = out * in_dim // 2
        n = max(2, math.ceil(2e8 / nib))
        qs = torch.randint(0, 256, (n, out, in_dim // 2), dtype=torch.uint8, device="cuda", generator=g)
        words = qs.view(torch.int32)
        rows = mv.stream_probe(qs[1], -7, all_rows=True)
        ref = mv.stream_probe_plain(qs[1], -7, all_rows=True)
        exact = bool(torch.equal(rows, ref)) and bool(torch.equal(mv.stream_probe(qs[1], -7), ref[::128]))
        case = {"case": "stream_probe", "shape": name, "out": out, "in": in_dim, "copies": n, "exact": exact,
                "max_abs_err": float((rows - ref).abs().max()),
                "kernel_ms": time_ms(torch, lambda i: mv.stream_probe(qs[i % n], i), 200),
                "plain_ms": time_ms(torch, lambda i: mv.stream_probe_plain(qs[i % n], i), 5),
                "library_ms": time_ms(torch, lambda i: torch.sum(words[i % n], dim=1, dtype=torch.int32), 200),
                "bound_ms": (nib + out * 4) / HBM_BYTES_PER_S * 1e3, "ok": exact}
        case["gbps"] = nib / case["kernel_ms"] / 1e6
        log(case)
        if not exact:
            failed.append(case)
        if name == "output":
            summary["stream_probe"] = dict(case, bound_by="bytes", shape=f"{out}x{in_dim}")
        del qs, words
    return failed


def run_kernelbench(torch) -> dict:
    """The kernelbench path (``tools/kernelbench.main``, every variant at
    its five shapes): the counters are reset just before and read just
    after; each variant makes ``iters + 1`` launches a shape of its kernel
    (probe: the stream probe; vpu, vpu_raw: the Q4_0 matvec on 4-bit and on
    f32 activations; phase: the T kernel; dense: none of the port's).  Logs
    one line a shape: GB/s, the share of the probe's rate on that shape and
    of the nominal 3,350 GB/s.  Returns the launch counts."""
    from llama_swift_torch import ops
    from llama_swift_torch.tools import kernelbench as kb

    iters = 50
    ops.reset_launch_counts()  # the kernelbench path's run starts here
    t0 = time.perf_counter()
    res = kb.main(["--iters", str(iters), "--shapes", ",".join(kb.SHAPES), "--variants", ",".join(kb.VARIANTS)])
    counts = ops.launch_counts()  # read just after
    wall = time.perf_counter() - t0
    for shape, rates in res.items():
        log({"case": "kernelbench", "shape": shape, "dims": kb.SHAPES[shape], "gbps": rates,
             "share_of_probe": {v: r / rates["probe"] for v, r in rates.items()},
             "share_of_nominal": {v: r / kb.H100_HBM_GBPS for v, r in rates.items()}})
    expect = {k: 0 for k in counts}
    per = (iters + 1) * len(res)
    expect.update(stream_probe=per, q4_0_matvec=per, q4_0_matvec_f32=per, q4_0_matmul_t=per)
    log({"case": "kernelbench_run", "wall_s": wall, "launches": {k: v for k, v in counts.items() if v}})
    if counts != expect or set(res) != set(kb.SHAPES):
        raise SystemExit(f"chip_smoke: the kernelbench path launched {counts}, expected {expect}")
    torch.cuda.empty_cache()
    return counts


def check_fused_blocks(torch, g, summary) -> list:
    """Row 11, the attention block and the FFN block, against their plain
    versions at 7B width (32 heads, n_ff 11008) with 2 layers of weights, at
    ``FUSED_NPAST`` on f32 and bf16 caches whose rows at and beyond n_past
    are stale (never read): the cache bytes unchanged by the call; k_new and
    v_new within 1e-5 (bf16: one bf16 step of their value); each delta
    within 5e-4 where no 4-bit activation code differs between the two
    (their quantizer inputs are traced), else the flips counted and held
    below ``FUSED_FLIP_LIMIT``.  Times against the bound of one layer's
    bytes (the attention block's weights and the n_past history rows; the
    FFN block's weights).  No single PyTorch call computes either block, so
    ``library_ms`` is None."""
    from llama_swift_torch.ops import fused_layer as fl
    from llama_swift_torch.ops.q4_matvec import quantize_activations_q4_0_int

    H, n_ctx, F, L = 32, 512, 11008, 2
    D = H * fl.HEAD_DIM
    wqkv, wo, w13, w2 = (rand_q4(torch, g, L, out, in_dim) for out, in_dim in
                         [(3 * D, D), (D, D), (2 * F, D), (D, F)])
    an, fn = (1.0 + 0.05 * torch.randn((L, D), device="cuda", generator=g) for _ in range(2))
    x = torch.randn(D, device="cuda", generator=g)
    grids = fl.block_grids(H, F)
    log({"case": "fused_blocks_grid", "attn_blocks": grids[0], "ffn_blocks": grids[1]})
    failed = []

    def flips(tr_k, tr_p):
        return int((quantize_activations_q4_0_int(tr_k[0])[0] != quantize_activations_q4_0_int(tr_p[0])[0]).sum())

    def wbytes(*shapes):
        return sum(out * in_dim // 2 + out * (in_dim // 32) * 4 for out, in_dim in shapes)

    # the FFN block reads no cache: one case
    tr_k, tr_p = [], []
    delta = fl.fused_ffn_block(x, fn[1], w13, w2, 1, trace=tr_k)
    ref = fl.fused_ffn_block_plain(x, fn[1], w13, w2, 1, trace=tr_p)
    err, nflip = rel_err(delta, ref), flips(tr_k, tr_p)
    nbytes = wbytes((2 * F, D), (D, F)) + 3 * D * 4
    t_ops = 2 * 3 * D * F / INT8_OPS
    case = {"case": "fused_ffn_block", "layers": L, "max_rel_err": err, "max_abs_err": float((delta - ref).abs().max()),
            "q4_flips": nflip,
            "kernel_ms": time_ms(torch, lambda i: fl.fused_ffn_block(x, fn[i % L], w13, w2, i % L), 50),
            "plain_ms": time_ms(torch, lambda i: fl.fused_ffn_block_plain(x, fn[i % L], w13, w2, i % L), 3),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3, "bound_by": "bytes", "library_ms": None,
            "ok": bool(torch.isfinite(delta).all()) and (err <= 5e-4 or 0 < nflip <= FUSED_FLIP_LIMIT)}
    log(case)
    if not case["ok"]:
        failed.append(case)
    summary["fused_ffn_block"] = dict(case, shape=f"D{D} n_ff{F}, one layer")

    for dtype in (torch.float32, torch.bfloat16):
        kc0 = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        vc0 = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        for n_past in FUSED_NPAST:
            kc, vc = kc0.clone(), vc0.clone()
            kc[:, :, n_past:] = 1e4  # stale rows: the block reads only j < n_past
            vc[:, :, n_past:] = -1e4
            k0, v0 = kc.clone(), vc.clone()
            cos, sin = fl.rope_vectors(n_past, device="cuda")
            tr_k, tr_p = [], []
            delta, k_new, v_new = fl.fused_attn_block(x, an[1], cos, sin, wqkv, wo, kc, vc, 1, n_past, trace=tr_k)
            torch.cuda.synchronize()
            cache_ok = bool(torch.equal(kc, k0) and torch.equal(vc, v0))
            ref, k_ref, v_ref = fl.fused_attn_block_plain(x, an[1], cos, sin, wqkv, wo, kc, vc, 1, n_past,
                                                          trace=tr_p)
            pairs = ((k_new, k_ref), (v_new, v_ref))
            kv_err = max(rel_err(a, b) for a, b in pairs)
            if dtype == torch.bfloat16:
                kv_ok = all(bool(((a - b).abs() <= b.abs() * 2.0**-7).all()) for a, b in pairs)
            else:
                kv_ok = kv_err <= 1e-5
            err, nflip = rel_err(delta, ref), flips(tr_k, tr_p)
            elt = kc.element_size()
            nbytes = wbytes((3 * D, D), (D, D)) + 2 * H * n_past * fl.HEAD_DIM * elt + 2 * D * 4 + 3 * D * 4
            t_ops = 2 * 4 * D * D / INT8_OPS
            case = {"case": "fused_attn_block", "layers": L, "cache": str(dtype).split(".")[-1], "n_past": n_past,
                    "max_rel_err": err, "max_abs_err": float((delta - ref).abs().max()), "kv_new_rel_err": kv_err,
                    "kv_new_ok": kv_ok, "cache_unchanged": cache_ok, "q4_flips": nflip,
                    "kernel_ms": time_ms(torch, lambda i: fl.fused_attn_block(
                        x, an[i % L], cos, sin, wqkv, wo, kc, vc, i % L, n_past), 50),
                    "plain_ms": time_ms(torch, lambda i: fl.fused_attn_block_plain(
                        x, an[i % L], cos, sin, wqkv, wo, kc, vc, i % L, n_past), 3),
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3, "bound_by": "bytes",
                    "library_ms": None}
            case["ok"] = bool(torch.isfinite(delta).all()) and cache_ok and (
                (err <= 5e-4 and kv_ok) or 0 < nflip <= FUSED_FLIP_LIMIT)
            log(case)
            if not case["ok"]:
                failed.append(case)
            if dtype == torch.float32 and n_past == 127:
                summary["fused_attn_block"] = dict(case, shape=f"H{H} n_past{n_past} f32, one layer")
        del kc0, vc0, kc, vc
    del wqkv, wo, w13, w2
    torch.cuda.empty_cache()
    return failed


def check_kernels(torch) -> dict:
    """Returns {kernel name: summary at its representative shape}."""
    from llama_swift_torch.ops import attention as att
    from llama_swift_torch.ops import q4_dequant as dq
    from llama_swift_torch.ops import q4_matvec as mv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    summary = {}
    failed = []

    # matvec: enough weight copies that a round robin streams > 200 MB (cold L2)
    for out, in_dim in MATVEC_SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))
        w = rand_q4(torch, g, n, out, in_dim)
        x = torch.randn(in_dim, device=dev, generator=g)
        y = mv.q4_0_matvec(x, w.layer(0))
        ref = mv.q4_0_matvec_plain(x, w.layer(0))
        err = rel_err(y, ref)
        ms = time_ms(torch, lambda i: mv.q4_0_matvec(x, w.layer(i % n)), 200)
        plain_ms = time_ms(torch, lambda i: mv.q4_0_matvec_plain(x, w.layer(i % n)), 5)
        nbytes = wbytes + in_dim * 4 + out * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * out * in_dim / INT8_OPS) * 1e3
        case = {"case": "q4_0_matvec", "out": out, "in": in_dim, "max_rel_err": err,
                "max_abs_err": float((y - ref).abs().max()), "kernel_ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "library_ms": None, "ok": err <= 1e-5}
        log(case)
        if not case["ok"]:
            failed.append(case)
        if (out, in_dim) == (11008, 4096):
            summary["q4_0_matvec"] = dict(case, bound_by="bytes", shape=f"{out}x{in_dim}")
        del w

    # flash decode over the 32-layer stacked cache, a layer per call
    L, H, n_ctx, dh = 32, 32, 512, 128
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn((L, H, n_ctx, dh), device=dev, generator=g).to(dtype)
        vc = torch.randn((L, H, n_ctx, dh), device=dev, generator=g).to(dtype)
        for n_past in FLASH_NPAST:
            q = torch.randn((H, dh), device=dev, generator=g)
            # stale data beyond n_past must not matter
            kc[3, :, n_past + 1 :] = 1e4
            vc[3, :, n_past + 1 :] = -1e4
            out = att.flash_decode_attention(q, kc, vc, 3, n_past)
            ref = att.flash_decode_attention_plain(q, kc, vc, 3, n_past)
            err = rel_err(out, ref)
            ms = time_ms(torch, lambda i: att.flash_decode_attention(q, kc, vc, i % L, n_past), 200)
            plain_ms = time_ms(torch, lambda i: att.flash_decode_attention_plain(q, kc, vc, i % L, n_past), 50)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qs4 = q.to(dtype)[None, :, None, :]
            lib_ms = time_ms(torch, lambda i: sdpa(
                qs4, kc[i % L, :, : n_past + 1][None], vc[i % L, :, : n_past + 1][None]), 200)
            elt = kc.element_size()
            nbytes = 2 * H * (n_past + 1) * dh * elt + 2 * H * dh * 4
            flops = 4 * H * (n_past + 1) * dh
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            case = {"case": "flash_decode_attention", "cache": str(dtype).split(".")[-1],
                    "n_past": n_past, "max_rel_err": err, "max_abs_err": float((out - ref).abs().max()),
                    "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib_ms,
                    "ok": err <= 1e-5}
            log(case)
            if not case["ok"]:
                failed.append(case)
            if n_past == 511:
                case["launches_per_call"] = launches_per_call(
                    torch, lambda i: att.flash_decode_attention(q, kc, vc, i % L, n_past))
                case["ok"] = case["ok"] and case["launches_per_call"] == 1
                log({"case": "flash_decode_attention_launches", "cache": case["cache"],
                     "launches_per_call": case["launches_per_call"]})
                if not case["ok"]:
                    failed.append(case)
            if dtype == torch.float32 and n_past == 511:
                summary["flash_decode_attention"] = dict(
                    case, bound_by="bytes", shape=f"H{H} Dh{dh} n_past{n_past} f32")
        del kc, vc
    # LLaMA's context: n_ctx 2048, 4 layers, up to its last position
    for dtype in (torch.float32, torch.bfloat16):
        L4, n_ctx_l = 4, 2048
        kc = torch.randn((L4, H, n_ctx_l, dh), device=dev, generator=g).to(dtype)
        vc = torch.randn((L4, H, n_ctx_l, dh), device=dev, generator=g).to(dtype)
        for n_past in (1000, 2047):
            q = torch.randn((H, dh), device=dev, generator=g)
            kc[1, :, n_past + 1 :] = 1e4
            vc[1, :, n_past + 1 :] = -1e4
            out = att.flash_decode_attention(q, kc, vc, 1, n_past)
            err = rel_err(out, att.flash_decode_attention_plain(q, kc, vc, 1, n_past))
            nbytes = 2 * H * (n_past + 1) * dh * kc.element_size() + 2 * H * dh * 4
            case = {"case": "flash_decode_attention", "cache": str(dtype).split(".")[-1], "n_ctx": n_ctx_l,
                    "n_past": n_past, "max_rel_err": err,
                    "kernel_ms": time_ms(torch, lambda i: att.flash_decode_attention(q, kc, vc, i % L4, n_past), 200),
                    "library_ms": time_ms(torch, lambda i: sdpa(
                        q.to(dtype)[None, :, None, :], kc[i % L4, :, : n_past + 1][None],
                        vc[i % L4, :, : n_past + 1][None]), 200),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ok": err <= 1e-5}
            log(case)
            if not case["ok"]:
                failed.append(case)
        del kc, vc

    # multi-row matmul: B=8 at the matvec shapes, B=32 at 11008x4096
    for rows, (out, in_dim) in [(MULTI_ROWS, sh) for sh in MATVEC_SHAPES] + [(32, (11008, 4096))]:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))
        w = rand_q4(torch, g, n, out, in_dim)
        x = torch.randn((rows, in_dim), device=dev, generator=g)
        y = mv.q4_0_matmul_multi(x, w.layer(0))
        ref = mv.q4_0_matmul_multi_plain(x, w.layer(0))
        err = rel_err(y, ref)
        ms = time_ms(torch, lambda i: mv.q4_0_matmul_multi(x, w.layer(i % n)), 200)
        plain_ms = time_ms(torch, lambda i: mv.q4_0_matmul_multi_plain(x, w.layer(i % n)), 3)
        nbytes = wbytes + rows * in_dim * 4 + rows * out * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * rows * out * in_dim / INT8_OPS) * 1e3
        case = {"case": "q4_0_matmul_multi", "rows": rows, "out": out, "in": in_dim, "max_rel_err": err,
                "max_abs_err": float((y - ref).abs().max()), "kernel_ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "library_ms": None, "ok": err <= 1e-5}
        log(case)
        if not case["ok"]:
            failed.append(case)
        if (rows, out, in_dim) == (MULTI_ROWS, 11008, 4096):
            summary["q4_0_matmul_multi"] = dict(case, bound_by="bytes", shape=f"B{rows} {out}x{in_dim}")
        del w

    # batched and paged flash decode: B=8 slots, per-slot n_past, stale data
    # beyond each; the paged pool holds the same keys through a shuffled table
    B, page = len(BATCHED_NPASTS), 128
    n_pasts = torch.tensor(BATCHED_NPASTS, dtype=torch.int32, device=dev)
    max_np = max(BATCHED_NPASTS)
    live = [n // page + 1 for n in BATCHED_NPASTS]
    n_pool = sum(live) + 1
    perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(5)).tolist()
    table = torch.full((B, n_ctx // page), 10**6, dtype=torch.int32)  # garbage beyond live pages
    for b in range(B):
        for c in range(live[b]):
            table[b, c] = perm.pop()
    table = table.to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(n_ctx, device=dev)[None, :] <= n_pasts[:, None].long())[:, None, None, :]
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn((L, B, H, n_ctx, dh), device=dev, generator=g).to(dtype)
        vc = torch.randn((L, B, H, n_ctx, dh), device=dev, generator=g).to(dtype)
        for b, n_past in enumerate(BATCHED_NPASTS):
            kc[:, b, :, n_past + 1 :] = 1e4
            vc[:, b, :, n_past + 1 :] = -1e4
        kp = torch.zeros((n_pool, L, H, page, dh), device=dev, dtype=dtype)
        vp = torch.zeros_like(kp)
        for b in range(B):
            for c in range(live[b]):
                kp[int(table[b, c])] = kc[:, b, :, c * page : (c + 1) * page]
                vp[int(table[b, c])] = vc[:, b, :, c * page : (c + 1) * page]
        q = torch.randn((B, H, dh), device=dev, generator=g)
        elt = kc.element_size()
        keys = sum(n + 1 for n in BATCHED_NPASTS)
        nbytes = 2 * H * keys * dh * elt + 2 * B * H * dh * 4 + B * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 4 * H * keys * dh / F32_FLOPS) * 1e3
        cache_name = str(dtype).split(".")[-1]
        ref = att.flash_decode_attention_batched_plain(q, kc, vc, 3, n_pasts, max_np)
        for name, fn, plain, lib in [
            ("flash_decode_attention_batched",
             lambda i: att.flash_decode_attention_batched(q, kc, vc, i % L, n_pasts, max_np),
             lambda i: att.flash_decode_attention_batched_plain(q, kc, vc, i % L, n_pasts, max_np),
             lambda i: sdpa(q.to(dtype)[:, :, None, :], kc[i % L], vc[i % L], attn_mask=mask)),
            ("flash_decode_attention_paged",
             lambda i: att.flash_decode_attention_paged(q, kp, vp, table, i % L, n_pasts, max_np),
             lambda i: att.flash_decode_attention_paged_plain(q, kp, vp, table, i % L, n_pasts, max_np),
             None),
        ]:
            out = fn(3)
            err = rel_err(out, ref)
            case = {"case": name, "cache": cache_name, "B": B, "n_pasts": BATCHED_NPASTS,
                    "max_rel_err": err, "max_abs_err": float((out - ref).abs().max()),
                    "kernel_ms": time_ms(torch, fn, 200), "plain_ms": time_ms(torch, plain, 20),
                    "bound_ms": bound, "library_ms": time_ms(torch, lib, 200) if lib else None,
                    "ok": err <= 1e-5}
            log(case)
            if not case["ok"]:
                failed.append(case)
            if dtype == torch.float32:
                summary[name] = dict(case, bound_by="bytes", shape=f"B{B} H{H} Dh{dh} n_ctx{n_ctx} f32"
                                     + (f" page{page}" if "paged" in name else ""))
        del kc, vc, kp, vp

    failed += check_int8_kernels(torch, g, summary)
    failed += check_fused_kernel(torch, g, summary)
    failed += check_q4_1_kernels(torch, g, summary)
    failed += check_f32_kernels(torch, g, summary)
    failed += check_t_kernel(torch, g, summary)
    failed += check_int_t_kernels(torch, g, summary)
    failed += check_fused_blocks(torch, g, summary)
    failed += check_stream_probe(torch, g, summary)

    # dequant 11008x4096 to bf16 and f32: bit-exact
    out, in_dim = 11008, 4096
    w = rand_q4(torch, g, 4, out, in_dim)
    for dtype in (torch.bfloat16, torch.float32):
        dense = dq.q4_0_dequant(w.layer(0), dtype)
        ref = dq.dequantize_q4_0(w.layer(0), dtype)
        exact = bool(torch.equal(dense, ref))
        ms = time_ms(torch, lambda i: dq.q4_0_dequant(w.layer(i % 4), dtype), 50)
        plain_ms = time_ms(torch, lambda i: dq.dequantize_q4_0(w.layer(i % 4), dtype), 5)
        nbytes = out * in_dim // 2 + out * (in_dim // 32) * 4 + out * in_dim * dense.element_size()
        case = {"case": "q4_0_dequant", "dtype": str(dtype).split(".")[-1], "out": out, "in": in_dim,
                "exact": exact, "max_abs_err": float((dense.float() - ref.float()).abs().max()),
                "kernel_ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "library_ms": None, "ok": exact}
        log(case)
        if not exact:
            failed.append(case)
        if dtype == torch.bfloat16:
            summary["q4_0_dequant"] = dict(case, bound_by="bytes", shape=f"{out}x{in_dim} bf16")
    # the prefill product on the dequant kernel's bf16 output: linear() on
    # the card vs the same bf16-rounded operands multiplied in f32
    from llama_swift_torch.ops import quantized_matmul as qmm

    x = torch.randn((64, in_dim), device=dev, generator=g)
    y = qmm.linear(x, w.layer(1), dense_matmul_dtype=torch.bfloat16)
    xq = qmm.fake_quantize_q4_0(x).to(torch.bfloat16).float()
    ref = xq @ dq.dequantize_q4_0(w.layer(1), torch.bfloat16).float().t()
    err = rel_err(y, ref)
    case = {"case": "prefill_linear_bf16", "rows": 64, "out": out, "in": in_dim,
            "max_rel_err": err, "ok": err <= 1e-4}
    log(case)
    if not case["ok"]:
        failed.append(case)
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} kernel case(s) disagree with the plain version")
    return summary


FUSED_NPAST = [0, 127, 511]
FUSED_FLIP_LIMIT = 64  # flipped 4-bit codes a row-11 or path-B case may show (a fault flips thousands)


def events_ms(torch, fn) -> float:
    """CUDA events around one call after a warm-up call, for a plain version
    too large to queue behind ``time_ms``'s sleep kernel (its temporaries
    make the caching allocator synchronize); host gaps are included."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check_fused_kernel(torch, g, summary) -> list:
    """The whole-stack kernel against its plain version at 7B width (32
    heads, n_ff 11008): 2 layers at ``FUSED_NPAST`` on f32 and bf16 caches
    with stale rows at and beyond n_past; then all 32 layers at n_past 127
    and 511, f32 and bf16, timed against the bound of one token's bytes.
    Each case is held to the bar of ``llama_swift_torch/utils/fused_check.py``
    (``fused_case``, which ``tests/test_torch_cuda.py`` shares): x and the
    new K/V within 5e-4 (the JAX package's fused tests' bar; bf16 K/V
    within one bf16 step), or, where 4-bit codes flip, the first flip at a
    rounding boundary and the plain arithmetic run on the kernel's own
    quantizer inputs and K/V rows agreeing everywhere; the kernel's second
    launch repeats the first bit for bit.  No single PyTorch call computes
    this function, so ``library_ms`` is None."""
    from llama_swift_torch.ops import fused_layer as fl
    from llama_swift_torch.utils.fused_check import fused_case

    H, n_ctx, F = 32, 512, 11008
    D = H * fl.HEAD_DIM
    shapes = [(3 * D, D), (D, D), (2 * F, D), (D, F)]
    failed = []
    log({"case": "fused_layers_grid", "blocks": fl.grid_blocks(H, F),
         "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    def inputs(L):
        weights = [rand_q4(torch, g, L, out, in_dim) for out, in_dim in shapes]
        norms = [1.0 + 0.05 * torch.randn((L, D), device="cuda", generator=g) for _ in range(2)]
        return weights, norms

    def bound_ms(L, n_past, elt):
        wbytes = L * sum(out * in_dim // 2 + out * (in_dim // 32) * 4 for out, in_dim in shapes)
        nbytes = wbytes + 2 * L * D * 4 + 2 * L * H * (n_past + 2) * fl.HEAD_DIM * elt + 2 * D * 4
        ops = 2 * L * sum(out * in_dim for out, in_dim in shapes)
        return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3

    L = 2
    weights, norms = inputs(L)
    x = torch.randn(D, device="cuda", generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        kc0 = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        vc0 = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        for n_past in FUSED_NPAST:
            kc, vc = kc0.clone(), vc0.clone()
            kc[:, :, n_past:] = 1e4  # stale rows: n_past is written first, beyond it never read
            vc[:, :, n_past:] = -1e4
            case = {"case": "fused_layers_block", "layers": L, "cache": str(dtype).split(".")[-1],
                    "n_past": n_past, **fused_case(x, norms, weights, kc, vc, n_past)}
            case.update(
                kernel_ms=time_ms(torch, lambda i: fl.fused_layers_block(x, *norms, *weights, kc, vc, n_past), 20),
                plain_ms=time_ms(torch, lambda i: fl.fused_layers_block_plain(x, *norms, *weights, kc, vc, n_past),
                                 2),
                bound_ms=bound_ms(L, n_past, kc.element_size()), library_ms=None)
            log(case)
            if not case["ok"]:
                failed.append(case)
        del kc0, vc0, kc, vc
    del weights, norms

    # one token of the 32-layer stack: 4.05 GB of weights, far beyond L2;
    # f32 and bf16 caches at n_past 127 and 511 (the summary: f32 at 127)
    L = 32
    weights, norms = inputs(L)
    for dtype, n_past in ((torch.float32, 127), (torch.bfloat16, 127), (torch.float32, 511), (torch.bfloat16, 511)):
        kc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        vc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        case = {"case": "fused_layers_block", "layers": L, "cache": str(dtype).split(".")[-1], "n_past": n_past,
                **fused_case(x, norms, weights, kc, vc, n_past)}
        case.update(
            kernel_ms=time_ms(torch, lambda i: fl.fused_layers_block(x, *norms, *weights, kc, vc, n_past), 10),
            plain_ms=events_ms(torch, lambda i: fl.fused_layers_block_plain(x, *norms, *weights, kc, vc, n_past)),
            bound_ms=bound_ms(L, n_past, kc.element_size()), library_ms=None)
        log(case)
        if not case["ok"]:
            failed.append(case)
        if dtype == torch.float32 and n_past == 127:
            summary["fused_layers_block"] = dict(case, bound_by="bytes",
                                                 shape=f"L{L} H{H} n_ff{F} n_past{n_past} f32, per token")
        del kc, vc
    del weights, norms
    torch.cuda.empty_cache()
    return failed


def int8_cache(torch, shape, g):
    """Codes and row scales of a seeded f32 cache ``shape = [L, ...]``, made
    by the port's own int8 write a layer at a time."""
    from llama_swift_torch.models.llama import quantize_kv

    codes = torch.empty(shape, dtype=torch.int8, device="cuda")
    scales = torch.empty(shape[:-1] + (1,), device="cuda")
    for il in range(shape[0]):
        codes[il], scales[il] = quantize_kv(torch.randn(shape[1:], device="cuda", generator=g))
    return codes, scales


def make_stale(codes, scale, n_past: int) -> None:
    """Stale codes and huge scales in the rows beyond ``n_past``."""
    codes[..., n_past + 1 :, :] = STALE_CODE
    scale[..., n_past + 1 :, :] = STALE_SCALE


def to_pages(torch, dense, table, live, n_pool: int, page: int):
    """Scatter a dense ``[L, B, H, n_ctx, X]`` into a pool ``[n_pool, L, H,
    page, X]`` at each slot's live table entries."""
    L, B, H, _, X = dense.shape
    pool = torch.zeros((n_pool, L, H, page, X), dtype=dense.dtype, device=dense.device)
    for b in range(B):
        for c in range(live[b]):
            pool[int(table[b, c])] = dense[:, b, :, c * page : (c + 1) * page]
    return pool


def check_int8_kernels(torch, g, summary) -> list:
    """The three int8 flash kernels against their plain versions at 7B
    shapes, on caches written by the port's int8 write with stale codes and
    huge scales beyond each n_past: batch 1 at ``FLASH_NPAST``; batched at
    B = 8 and B = 16; paged at B = 8 over 17 pages of 128 and over pages of
    16 (each 64-key chunk then crosses pages), garbage table entries beyond
    each slot's live pages.  Returns the cases that disagree.  No PyTorch
    call folds per-row scales into attention, so ``library_ms`` is None."""
    from llama_swift_torch.ops import attention as att

    L, H, n_ctx, dh = 32, 32, 512, 128
    failed = []

    def bound_ms(keys: int, n_q: int) -> float:
        # K and V rows of int8 codes and their f32 scales, q in, out out
        nbytes = 2 * H * keys * (dh + 4) + 2 * n_q * H * dh * 4
        return max(nbytes / HBM_BYTES_PER_S, 4 * H * keys * dh / F32_FLOPS) * 1e3

    def measure(case, out, ref, fn, plain, bound):
        err = rel_err(out, ref)
        case.update(max_rel_err=err, max_abs_err=float((out - ref).abs().max()),
                    kernel_ms=time_ms(torch, fn, 200), plain_ms=time_ms(torch, plain, 20),
                    bound_ms=bound, library_ms=None, ok=err <= 1e-5)
        log(case)
        if not case["ok"]:
            failed.append(case)
        return case

    # batch 1: the stacked cache [L, H, n_ctx, Dh], a layer per call
    k8, ks = int8_cache(torch, (L, H, n_ctx, dh), g)
    v8, vs = int8_cache(torch, (L, H, n_ctx, dh), g)
    fresh = [t[3].clone() for t in (k8, ks, v8, vs)]
    for n_past in FLASH_NPAST:
        for t, f in zip((k8, ks, v8, vs), fresh):
            t[3].copy_(f)
        make_stale(k8[3], ks[3], n_past)
        make_stale(v8[3], vs[3], n_past)
        q = torch.randn((H, dh), device="cuda", generator=g)
        case = measure(
            {"case": "flash_decode_attention_stacked_int8", "n_past": n_past},
            att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, 3, n_past),
            att.flash_decode_attention_stacked_int8_plain(q, k8, v8, ks, vs, 3, n_past),
            lambda i: att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, i % L, n_past),
            lambda i: att.flash_decode_attention_stacked_int8_plain(q, k8, v8, ks, vs, i % L, n_past),
            bound_ms(n_past + 1, 1))
        if n_past == 511:
            case["launches_per_call"] = launches_per_call(
                torch, lambda i: att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, i % L, n_past))
            log({"case": "flash_decode_attention_stacked_int8_launches",
                 "launches_per_call": case["launches_per_call"]})
            if case["launches_per_call"] != 1:
                case["ok"] = False
                failed.append(case)
            summary["flash_decode_attention_stacked_int8"] = dict(
                case, bound_by="bytes", shape=f"H{H} Dh{dh} n_past{n_past} int8")
    del k8, ks, v8, vs, fresh

    # batched at B = 8 and 16, per-slot n_past; paged at B = 8
    for n_list in (BATCHED_NPASTS, BATCHED_NPASTS_16):
        B = len(n_list)
        n_pasts = torch.tensor(n_list, dtype=torch.int32, device="cuda")
        max_np, keys = max(n_list), sum(n + 1 for n in n_list)
        k8, ks = int8_cache(torch, (L, B, H, n_ctx, dh), g)
        v8, vs = int8_cache(torch, (L, B, H, n_ctx, dh), g)
        for b, n in enumerate(n_list):
            make_stale(k8[:, b], ks[:, b], n)
            make_stale(v8[:, b], vs[:, b], n)
        q = torch.randn((B, H, dh), device="cuda", generator=g)
        ref = att.flash_decode_attention_batched_int8_plain(q, k8, v8, ks, vs, 3, n_pasts, max_np)
        case = measure(
            {"case": "flash_decode_attention_batched_int8", "B": B, "n_pasts": n_list},
            att.flash_decode_attention_batched_int8(q, k8, v8, ks, vs, 3, n_pasts, max_np), ref,
            lambda i: att.flash_decode_attention_batched_int8(q, k8, v8, ks, vs, i % L, n_pasts, max_np),
            lambda i: att.flash_decode_attention_batched_int8_plain(q, k8, v8, ks, vs, i % L, n_pasts, max_np),
            bound_ms(keys, B))
        if B != MULTI_ROWS:  # B = 16: the batched kernel only
            del k8, ks, v8, vs
            continue
        summary["flash_decode_attention_batched_int8"] = dict(
            case, bound_by="bytes", shape=f"B{B} H{H} Dh{dh} n_ctx{n_ctx} int8")
        for page, n_pool in ((128, 17), (16, None)):
            live = [n // page + 1 for n in n_list]
            n_pool = n_pool or sum(live) + 1
            perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(page)).tolist()
            table = torch.full((B, n_ctx // page), 10**6, dtype=torch.int32)  # garbage beyond live pages
            for b in range(B):
                for c in range(live[b]):
                    table[b, c] = perm.pop()
            kp, vp, ksp, vsp = (to_pages(torch, t, table, live, n_pool, page) for t in (k8, v8, ks, vs))
            table = table.to("cuda")
            case = measure(
                {"case": "flash_decode_attention_paged_int8", "B": B, "n_pasts": n_list, "page": page,
                 "pages": n_pool},
                att.flash_decode_attention_paged_int8(q, kp, vp, ksp, vsp, table, 3, n_pasts, max_np), ref,
                lambda i: att.flash_decode_attention_paged_int8(q, kp, vp, ksp, vsp, table, i % L, n_pasts, max_np),
                lambda i: att.flash_decode_attention_paged_int8_plain(
                    q, kp, vp, ksp, vsp, table, i % L, n_pasts, max_np),
                bound_ms(keys, B))
            if page == 128:
                summary["flash_decode_attention_paged_int8"] = dict(
                    case, bound_by="bytes", shape=f"B{B} H{H} Dh{dh} n_ctx{n_ctx} int8 page{page}")
            del kp, vp, ksp, vsp
        del k8, ks, v8, vs
    return failed


# ---------------------------------------------------------------------------
# phase 3: 2-layer full-width parity, card vs CPU
# ---------------------------------------------------------------------------


def check_parity(torch) -> None:
    import dataclasses

    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib

    cfg = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2)
    tensors = dict(synthetic_tensors(cfg, seed=7))
    prompt = [1, 450, 17, 3000, 9, 222, 31000, 5]
    steps = [77, 12000, 345, 6]

    def run(device, c):
        params = model_lib.params_from_tensors(tensors, c, device=device)
        cache = model_lib.init_cache(c, device=device)
        logits, cache = model_lib.prefill(params, torch.tensor(prompt, device=device), 0, cache, c)
        out = [logits[-1].float().cpu()]
        for i, tok in enumerate(steps):
            lg, cache = model_lib.decode_step(params, torch.tensor(tok, device=device), len(prompt) + i, cache, c)
            out.append(lg.float().cpu())
        return out

    t0 = time.perf_counter()
    cpu = run("cpu", cfg)
    t_cpu = time.perf_counter() - t0
    f32 = run("cuda", dataclasses.replace(cfg, prefill_bf16=False))
    bf16 = run("cuda", cfg)
    dec = [rel_err(a, b) for a, b in zip(f32[1:], cpu[1:])]
    rec = {"case": "parity_7b_width_2_layers", "cpu_s": t_cpu,
           "prefill_f32_rel_err": rel_err(f32[0], cpu[0]),
           "prefill_bf16_rel_err": rel_err(bf16[0], cpu[0]),
           "decode_rel_err_max": max(dec),
           "decode_after_bf16_prefill_rel_err_max": max(rel_err(a, b) for a, b in zip(bf16[1:], cpu[1:])),
           "finite": all(bool(torch.isfinite(t).all()) for t in f32 + bf16)}
    # bf16 prefill bar: bf16 operands perturb each matmul output by ~2^-9
    # relative, and the next layer's 4-bit activation fake-quant turns that
    # into occasional whole-step flips (rms ~ sqrt(eps * step)), so bf16 and
    # f32 prefill differ by several percent at the logits (8.4 % measured
    # at this config on an H100 at 700 W).  The bar catches a broken path;
    # the exact check of the bf16 product itself is check_kernels'
    # prefill_linear case.
    rec["ok"] = (rec["finite"] and rec["decode_rel_err_max"] <= 2e-3
                 and rec["prefill_f32_rel_err"] <= 2e-3
                 and rec["prefill_bf16_rel_err"] <= BF16_PREFILL_BAR
                 and rec["decode_after_bf16_prefill_rel_err_max"] <= BF16_PREFILL_BAR)
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: 2-layer parity outside its bars")


@contextlib.contextmanager
def recording(record, tag):
    """While active, every Q4_0 matvec and multi-row product, every Q4_1
    matvec and every Q4_0 and Q4_1 activation fake-quantization (the Q4_1
    products of more than one row; the Q4_0 products of more than 32 rows
    and the T layout's phase-kernel products), and every product of the
    T layout's integer and multi-row wrappers, appends ``(tag[0], activation
    rows on the CPU)``
    to ``record`` (None: no recording), and every whole-stack call
    ``(tag[0], its quantizer inputs [L, 3D + F])``, so that two runs can be
    compared activation by activation."""
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.ops import quantized_matmul as qmm

    matvec, multi, fused = qmm.q4_0_matvec, qmm.q4_0_matmul_multi, model_lib.fused_layers_block
    matvec41, fq41, fq40 = qmm.q4_1_matvec, qmm.fake_quantize_q4_1, qmm.fake_quantize_q4_0
    int_t, multi_t = qmm.q4_0_int_matmul, qmm.q4_0_t_matmul_multi

    def fused_rec(*args, **kwargs):
        trace = []
        out = fused(*args, trace=trace, **kwargs)
        record.append((tag[0], trace[0]))
        return out

    if record is not None:
        qmm.q4_0_matvec = lambda x, w, **k: record.append((tag[0], x[None].cpu())) or matvec(x, w, **k)
        qmm.q4_0_matmul_multi = lambda x, w, **k: record.append((tag[0], x.cpu())) or multi(x, w, **k)
        qmm.q4_1_matvec = lambda x, w, **k: record.append((tag[0], x[None].cpu())) or matvec41(x, w, **k)
        qmm.fake_quantize_q4_1 = lambda x: record.append((tag[0], x.reshape(-1, x.shape[-1]).cpu())) or fq41(x)
        qmm.fake_quantize_q4_0 = lambda x: record.append((tag[0], x.reshape(-1, x.shape[-1]).cpu())) or fq40(x)
        qmm.q4_0_int_matmul = lambda x, w: record.append((tag[0], x.cpu())) or int_t(x, w)
        qmm.q4_0_t_matmul_multi = lambda x, w, **k: record.append((tag[0], x.cpu())) or multi_t(x, w, **k)
        model_lib.fused_layers_block = fused_rec
    try:
        yield
    finally:
        qmm.q4_0_matvec, qmm.q4_0_matmul_multi, model_lib.fused_layers_block = matvec, multi, fused
        qmm.q4_1_matvec, qmm.fake_quantize_q4_1, qmm.fake_quantize_q4_0 = matvec41, fq41, fq40
        qmm.q4_0_int_matmul, qmm.q4_0_t_matmul_multi = int_t, multi_t


def flip_counts(rec_cpu, rec_card, q4_1: bool = False):
    """Per recorded product: [rows] counts of 4-bit activation codes (Q4_0,
    or with ``q4_1`` Q4_1) that differ between the two runs."""
    from llama_swift_torch.ops.q4_matvec import quantize_activations_q4_0_int, quantize_activations_q4_1

    codes = quantize_activations_q4_1 if q4_1 else quantize_activations_q4_0_int
    return [(codes(xc)[0] != codes(xg)[0]).reshape(xc.shape).sum(-1) for (_, xc), (_, xg) in zip(rec_cpu, rec_card)]


def check_parity_int8(torch) -> None:
    """Batch-1 parity over an int8 cache at 7B width, 2 layers: an 8-token
    prefill and 4 decode steps (the int8 batch-1 flash kernel on the card,
    its plain version on the CPU).  With f32 activations (as the JAX
    package's int8 tests run) prefill and decode logits within 2e-3.  With
    the reference's 4-bit activations the same bar holds when no activation
    quantized differently on the two devices; the flips are counted either
    way (see ``check_batched_parity``).  Also counts the int8 codes that
    differ between the card's and the CPU's caches.  The f32-activation card
    run launches exactly the f32-activation kernels (the prefill's 8 rows on
    the multi-row one, each decode step on the matvec) and the int8 flash
    kernel, and no dequant."""
    import dataclasses

    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib

    base = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2, kv_cache_dtype="int8",
                               prefill_bf16=False)
    tensors = dict(synthetic_tensors(base, seed=7))
    params = {dev: model_lib.params_from_tensors(tensors, base, device=dev) for dev in ("cpu", "cuda")}
    prompt = [1, 450, 17, 3000, 9, 222, 31000, 5]
    steps = [77, 12000, 345, 6]

    def run(device, cfg, record):
        with recording(record, [None]):
            cache = model_lib.init_cache(cfg, device=device)
            logits, cache = model_lib.prefill(params[device], torch.tensor(prompt, device=device), 0, cache, cfg)
            out = [logits[-1].float().cpu()]
            for i, tok in enumerate(steps):
                lg, cache = model_lib.decode_step(params[device], torch.tensor(tok, device=device), len(prompt) + i,
                                                  cache, cfg)
                out.append(lg.float().cpu())
        return out, cache

    rec = {"case": "parity_int8_7b_width_2_layers"}
    for act in ("f32", "q4"):
        cfg = dataclasses.replace(base, quantize_activations=act == "q4")
        rec_cpu, rec_card = ([], []) if act == "q4" else (None, None)
        t0 = time.perf_counter()
        cpu, cpu_cache = run("cpu", cfg, rec_cpu)
        rec[f"{act}_act_cpu_s"] = time.perf_counter() - t0
        before = ops.launch_counts()
        card, card_cache = run("cuda", cfg, rec_card)
        if act == "f32":  # the f32-activation kernels, no dequant: the 8-row prefill takes the multi-row one
            per = 7 * cfg.n_layer + 1
            rec["f32_act_launches"] = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
            rec["f32_act_launches_ok"] = rec["f32_act_launches"] == {
                "q4_0_matmul_multi_f32": per, "q4_0_matvec_f32": per * len(steps),
                "flash_decode_attention_stacked_int8": cfg.n_layer * len(steps)}
        rec[f"{act}_act_prefill_rel_err"] = rel_err(card[0], cpu[0])
        rec[f"{act}_act_decode_rel_err_max"] = max(rel_err(a, b) for a, b in zip(card[1:], cpu[1:]))
        rec[f"{act}_act_codes_differing"] = sum(
            int((card_cache[k].cpu() != cpu_cache[k]).sum()) for k in ("k", "v"))
        rec[f"{act}_act_finite"] = all(bool(torch.isfinite(t).all()) for t in card)
        if act == "q4":
            rec["q4_act_flips"] = sum(int(f.sum()) for f in flip_counts(rec_cpu, rec_card))
    bar_ok = {act: rec[f"{act}_act_prefill_rel_err"] <= 2e-3 and rec[f"{act}_act_decode_rel_err_max"] <= 2e-3
              for act in ("f32", "q4")}
    rec["ok"] = (rec["f32_act_finite"] and rec["q4_act_finite"] and bar_ok["f32"] and rec["f32_act_launches_ok"]
                 and (bar_ok["q4"] or rec["q4_act_flips"] > 0))
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: int8 parity outside its bars")


def check_parity_fused(torch) -> None:
    """Batch-1 parity on fused wqkv/w13 params at 7B width, 2 layers: an
    8-token prefill (the multi-row kernel over wqkv and w13) and 4 decode
    steps (each one whole-stack launch and the output matvec on the card,
    their plain versions on the CPU), f32 and bf16 caches.  Logits within
    2e-3 when no 4-bit activation code differs between the devices; the
    flips are counted either way (see ``check_batched_parity``).  Each
    card decode step must launch exactly one whole-stack kernel and one
    matvec."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib

    base = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2, fuse_layer_matmuls=True,
                               prefill_bf16=False)
    tensors = dict(synthetic_tensors(base, seed=7))
    params = {dev: model_lib.params_from_tensors(tensors, base, device=dev) for dev in ("cpu", "cuda")}
    prompt = [1, 450, 17, 3000, 9, 222, 31000, 5]
    steps = [77, 12000, 345, 6]

    def run(device, cfg, record):
        with recording(record, [None]):
            cache = model_lib.init_cache(cfg, device=device)
            logits, cache = model_lib.prefill(params[device], torch.tensor(prompt, device=device), 0, cache, cfg)
            out = [logits[-1].float().cpu()]
            for i, tok in enumerate(steps):
                before = ops.launch_counts()
                lg, cache = model_lib.decode_step(params[device], torch.tensor(tok, device=device), len(prompt) + i,
                                                  cache, cfg)
                out.append(lg.float().cpu())
                after = ops.launch_counts()
                if device == "cuda":
                    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                    if delta != {"fused_layers_block": 1, "q4_0_matvec": 1}:
                        raise SystemExit(f"chip_smoke: fused decode step launched {delta}")
        return out

    rec = {"case": "parity_fused_7b_width_2_layers"}
    for kv in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        rec_cpu, rec_card = [], []
        t0 = time.perf_counter()
        cpu = run("cpu", cfg, rec_cpu)
        rec[f"{kv}_cpu_s"] = time.perf_counter() - t0
        card = run("cuda", cfg, rec_card)
        rec[f"{kv}_prefill_rel_err"] = rel_err(card[0], cpu[0])
        rec[f"{kv}_decode_rel_err_max"] = max(rel_err(a, b) for a, b in zip(card[1:], cpu[1:]))
        rec[f"{kv}_flips"] = sum(int(f.sum()) for f in flip_counts(rec_cpu, rec_card))
        rec[f"{kv}_finite"] = all(bool(torch.isfinite(t).all()) for t in card)
        within = rec[f"{kv}_prefill_rel_err"] <= 2e-3 and rec[f"{kv}_decode_rel_err_max"] <= 2e-3
        rec[f"{kv}_ok"] = rec[f"{kv}_finite"] and (within or rec[f"{kv}_flips"] > 0)
    rec["ok"] = rec["float32_ok"] and rec["bfloat16_ok"]
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: fused parity outside its bars")


def check_parity_q4_1(torch) -> None:
    """Q4_1 parity at 7B width, 2 layers, card vs CPU, f32 prefill products:
    an 8-token prefill and slot prefills of 3 slots (the Q4_1 dequant), 4
    batch-1 decode steps (the Q4_1 matvec, 15 launches a step) and 2
    ``forward_batched`` steps at B = 8 (the dequant again, 15 launches a
    step: there is no Q4_1 multi-row kernel).

    With f32 activations nothing is quantized, so every logit is within
    2e-3; each decode step is exactly 15 launches of the f32-activation Q4_1
    matvec and each batched step 15 dequant launches (more than one Q4_1
    row dequantizes, as in the JAX package).  With the reference's Q4_1 activations, an ulp-level difference
    between the devices (a dense f32 product summed in another order) can
    move one activation across a rounding step, and that flip moves the
    logits by percents (see ``check_batched_parity``).  So the card's decode
    and batched steps continue from copies of the CPU's caches (a flip in a
    prefill does not reach them), the flips are counted per output and
    along each chain (the decode steps; each slot's batched rows), every
    flip-free output must be within 2e-3, and a flip-free decode step and
    batched row must exist unless every output is within the bar.  The
    card's quantizer must give the CPU's codes on the card's own inputs
    (so a flip comes from its input, not from the rounding)."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.ops.q4_matvec import quantize_activations_q4_1

    base = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_1), n_layer=2, prefill_bf16=False)
    tensors = dict(synthetic_tensors(base, seed=7))
    params = {dev: model_lib.params_from_tensors(tensors, base, device=dev) for dev in ("cpu", "cuda")}
    prompts = [[1, 450, 17, 3000, 9, 222, 31000, 5], [1, 12, 99, 4000, 7], [1, 8, 2000, 77, 31, 6, 900, 14, 3, 70, 5]]
    decode_toks, step_toks = [77, 12000, 345, 6], [[77, 12000, 345, 0, 0, 0, 0, 0], [6, 31999, 2, 0, 0, 0, 0, 0]]
    B, S = 8, len(prompts)
    per_step = 7 * base.n_layer + 1

    def prefills(dev, cfg, tag):
        """Outputs [(name, logits)] of the prompt's prefill and the slot
        prefills, the batch-1 cache and the batched cache."""
        tag[0] = "prefill"
        cache = model_lib.init_cache(cfg, device=dev)
        lg, cache = model_lib.prefill(params[dev], torch.tensor(prompts[0], device=dev), 0, cache, cfg)
        outs = [("prefill", lg[-1].float().cpu())]
        bcache = model_lib.init_cache_batched(cfg, B, device=dev)
        for b, ids in enumerate(prompts):
            tag[0] = f"slot{b}"
            lg, bcache = model_lib.forward(params[dev], torch.tensor(ids, device=dev), 0, bcache, cfg, slot=b)
            outs.append((tag[0], lg[-1].float().cpu()))
        return outs, cache, bcache

    def steps(dev, cfg, cache, bcache, tag, deltas):
        """Outputs of the decode steps and the batched steps (active rows)."""
        outs = []
        for i, tok in enumerate(decode_toks):
            tag[0] = f"decode{i}"
            before = ops.launch_counts()
            lg, cache = model_lib.decode_step(params[dev], torch.tensor(tok, device=dev), len(prompts[0]) + i,
                                              cache, cfg)
            deltas.append({k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]})
            outs.append((tag[0], lg.float().cpu()))
        n_pasts = np.array([len(p) for p in prompts] + [0] * (B - S))
        for j, toks in enumerate(step_toks):
            tag[0] = f"batched{j}"
            before = ops.launch_counts()
            lg, bcache = model_lib.forward_batched(params[dev], torch.tensor(toks, device=dev), n_pasts, bcache, cfg)
            deltas.append({k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]})
            outs.append((tag[0], lg[:S].float().cpu()))
            n_pasts[:S] += 1
        return outs

    def on_card(cache):
        return {k: v.to("cuda") for k, v in cache.items()}

    rec = {"case": "parity_q4_1_7b_width_2_layers"}
    f32 = dataclasses.replace(base, quantize_activations=False)
    tag = [None]
    t0 = time.perf_counter()
    runs = {}
    f32_deltas = {"cpu": [], "cuda": []}
    for dev in ("cpu", "cuda"):
        outs, cache, bcache = prefills(dev, f32, tag)
        runs[dev] = outs + steps(dev, f32, cache, bcache, tag, f32_deltas[dev])
    rec["f32_act_cpu_and_card_s"] = time.perf_counter() - t0
    rec["f32_act_launches_per_step"] = f32_deltas["cuda"]
    f32_expect = [{"q4_1_matvec_f32": per_step, "flash_decode_attention": base.n_layer}] * len(decode_toks) + [
        {"q4_1_dequant": per_step, "flash_decode_attention_batched": base.n_layer}] * len(step_toks)
    rec["f32_act_rel_err_max"] = max(rel_err(c, r) for (_, c), (_, r) in zip(runs["cuda"], runs["cpu"]))

    rec_cpu, rec_card, deltas = [], [], []
    with recording(rec_cpu, tag):
        cpu, cache, bcache = prefills("cpu", base, tag)
        start = (on_card(cache), on_card(bcache))  # before the CPU's steps write them
        cpu += steps("cpu", base, cache, bcache, tag, [])
    with recording(rec_card, tag):
        card, _, _ = prefills("cuda", base, tag)
        card += steps("cuda", base, *start, tag, deltas)
    flips, first = {}, None  # output name -> flip count (batched steps: per active slot)
    for i, ((name, _), diff) in enumerate(zip(rec_cpu, flip_counts(rec_cpu, rec_card, q4_1=True))):
        f = diff[:S].tolist() if name.startswith("batched") else [int(diff.sum())]
        flips[name] = [a + b for a, b in zip(flips.get(name, [0] * len(f)), f)]
        if first is None and sum(f):
            first = [name, i, sum(f)]
    outputs, decode_flips, slot_flips = [], 0, [0] * S  # flips so far along each chain
    for (name, c), (_, r) in zip(card, cpu):
        if name.startswith("batched"):
            slot_flips = [a + b for a, b in zip(slot_flips, flips.get(name, [0] * S))]
            outputs += [[f"{name}/slot{b}", rel_err(c[b], r[b]), slot_flips[b]] for b in range(S)]
        else:
            n = flips.get(name, [0])[0]
            if name.startswith("decode"):
                decode_flips += n
                n = decode_flips
            outputs.append([name, rel_err(c, r), n])
    rec["q4_act_outputs"] = outputs  # [name, rel err, flips so far on its chain]
    rec["q4_act_first_flip"] = first  # [output, product index, flips]
    # the flips come from the inputs: on the card's own inputs, its quantizer gives the CPU's codes
    rec["card_quantizer_matches_cpu"] = all(
        torch.equal(quantize_activations_q4_1(x.cuda())[0].cpu(), quantize_activations_q4_1(x)[0]) for _, x in rec_card)
    rec["finite"] = all(bool(torch.isfinite(t).all()) for _, t in card + runs["cuda"])
    rec["launches_per_step"] = deltas
    expect = [{"q4_1_matvec": per_step, "flash_decode_attention": base.n_layer}] * len(decode_toks) + [
        {"q4_1_dequant": per_step, "flash_decode_attention_batched": base.n_layer}] * len(step_toks)
    clean = [o for o in outputs if o[2] == 0]
    all_within = all(o[1] <= 2e-3 for o in outputs)
    rec["ok"] = (rec["finite"] and deltas == expect and f32_deltas["cuda"] == f32_expect
                 and rec["f32_act_rel_err_max"] <= 2e-3
                 and rec["card_quantizer_matches_cpu"] and all(o[1] <= 2e-3 for o in clean)
                 and (all_within or all(any(o[0].startswith(k) for o in clean) for k in ("decode", "batched"))))
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: Q4_1 parity outside its bars")


# ---------------------------------------------------------------------------
# phase 3b: batched parity at 7B width, 2 layers, dense and paged caches
# ---------------------------------------------------------------------------


def check_batched_parity(torch, cache_dtype=None) -> None:
    """Slot prefills of 3 slots, then 4 ``forward_batched`` steps at B=8, in
    the dense and the paged cache (f32, or ``cache_dtype``), card vs CPU.

    With the reference's 4-bit activation quantization, an ulp-level
    difference between the devices (a norm or rope computed in another
    order) can move one activation across a rounding tie; that one step
    then changes the slot's logits by percents (7e-2 measured on an NVIDIA
    H100 80GB HBM3 at 700 W, see PERF.md).  So the bars are: card vs CPU
    within 2e-3 with f32 activations (no quantization, both modes); with
    quantized activations, within 2e-3 for every slot whose quantized
    activations came out the same on both devices (flips counted per slot;
    at least one slot must be flip-free unless every slot is within 2e-3:
    a flip in a row that never reaches the compared logits, such as the
    last layer's products at an earlier position, changes nothing); and the
    card's batched rows against batch-1 ``decode_step`` of the same slot
    state within 2e-3 (same device, so no flip).  The f32-activation card
    runs launch exactly the f32-activation multi-row kernel for every
    product and the mode's flash kernel for every step, and no dequant."""
    import dataclasses

    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib

    base = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2, prefill_bf16=False)
    tensors = dict(synthetic_tensors(base, seed=11))
    B, page, n_pages = 8, 128, 9
    prompts = [[1, 450, 17, 3000, 9, 222, 31000, 5], [1, 12, 99, 4000, 7], [1, 8, 2000, 77, 31, 6, 900, 14, 3, 70, 5]]
    steps = [[77, 12000, 345, 0, 0, 0, 0, 0], [6, 31999, 2, 0, 0, 0, 0, 0],
             [345, 17, 450, 0, 0, 0, 0, 0], [9, 9, 9, 0, 0, 0, 0, 0]]
    table = [5, 2, 7]  # one page per active slot, shuffled; the rest on scratch (n_pages - 1)
    S = len(prompts)
    params = {dev: model_lib.params_from_tensors(tensors, base, device=dev) for dev in ("cpu", "cuda")}

    def run(device, cfg, paged, record=None):
        """Logits [prefill of each slot] + [steps × active rows]; ``record``
        collects (slot or None, activation rows) of each multi-row product."""
        tag = [None]
        with recording(record, tag):
            if paged:
                cache = model_lib.init_cache_paged(cfg, n_pages, B, dtype=cache_dtype, page=page, device=device)
                cache["page_table"][:S, 0] = torch.tensor(table, dtype=torch.int32)
            else:
                cache = model_lib.init_cache_batched(cfg, B, dtype=cache_dtype, device=device)
            out = []
            for b, ids in enumerate(prompts):
                tag[0] = b
                lg, cache = model_lib.forward(params[device], torch.tensor(ids, device=device), 0, cache, cfg, slot=b)
                out.append(lg[-1:].float().cpu())
            n_pasts = np.array([len(p) for p in prompts] + [0] * (B - S))
            tag[0] = None
            for toks in steps:
                lg, cache = model_lib.forward_batched(params[device], torch.tensor(toks, device=device), n_pasts,
                                                      cache, cfg)
                out.append(lg[:S].float().cpu())  # idle slots' rows are not compared
                n_pasts[:S] += 1
        return out

    def slot_errs(card, cpu):
        """Max relative logit error per slot over its prefill and its rows of every step."""
        errs = [rel_err(card[b], cpu[b]) for b in range(S)]
        for c, r in zip(card[S:], cpu[S:]):
            errs = [max(e, rel_err(c[b], r[b])) for b, e in enumerate(errs)]
        return errs

    dtype_name = str(cache_dtype or torch.float32).split(".")[-1]
    rec = {"case": f"batched_parity_{dtype_name}_7b_width_2_layers", "B": B, "slots": S, "steps": len(steps)}
    f32 = dataclasses.replace(base, quantize_activations=False)
    int8 = "_int8" if cache_dtype == torch.int8 else ""
    for mode in ("dense", "paged"):
        t0 = time.perf_counter()
        cpu = run("cpu", f32, mode == "paged")
        rec[f"{mode}_cpu_s"] = time.perf_counter() - t0
        before = ops.launch_counts()
        card = run("cuda", f32, mode == "paged")
        # f32 activations: every product (3-11-row slot prefills, 8-row steps) on the f32 multi-row kernel
        rec[f"{mode}_f32_act_launches"] = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
        rec[f"{mode}_f32_act_launches_ok"] = rec[f"{mode}_f32_act_launches"] == {
            "q4_0_matmul_multi_f32": (S + len(steps)) * (7 * base.n_layer + 1),
            ("flash_decode_attention_paged" if mode == "paged" else "flash_decode_attention_batched") + int8:
                base.n_layer * len(steps)}
        rec[f"{mode}_f32_act_rel_err_max"] = max(slot_errs(card, cpu))
        rec[f"{mode}_finite"] = all(bool(torch.isfinite(t).all()) for t in card)
        rec_cpu, rec_card = [], []
        cpu = run("cpu", base, mode == "paged", rec_cpu)
        card = run("cuda", base, mode == "paged", rec_card)
        flips = [0] * S
        for (slot, _), diff in zip(rec_cpu, flip_counts(rec_cpu, rec_card)):
            for b in range(S):
                flips[b] += int(diff.sum() if slot == b else diff[b] if slot is None else 0)
        errs = slot_errs(card, cpu)
        rec[f"{mode}_q4_act_rel_err_per_slot"] = errs
        rec[f"{mode}_q4_act_flips_per_slot"] = flips
        # every flip-free slot within the bar; and a flip-free slot exists,
        # unless every slot is within the bar anyway (flips at rows whose
        # outputs never reach the compared logits change nothing)
        within = [e <= 2e-3 for e in errs]
        rec[f"{mode}_q4_act_ok"] = all(w for w, f in zip(within, flips) if f == 0) and (
            any(f == 0 for f in flips) or all(within))
    # the card's batched rows (multi-row kernel, batched flash) against
    # batch-1 decode (matvec, batch-1 flash) of the same slot state
    card = run("cuda", base, paged=False)
    errs = []
    for b, ids in enumerate(prompts):
        cache = model_lib.init_cache(base, dtype=cache_dtype, device="cuda")
        _, cache = model_lib.prefill(params["cuda"], torch.tensor(ids, device="cuda"), 0, cache, base)
        for s, toks in enumerate(steps):
            lg, cache = model_lib.decode_step(params["cuda"], torch.tensor(toks[b], device="cuda"), len(ids) + s,
                                              cache, base)
            errs.append(rel_err(card[S + s][b], lg.float().cpu()))
    rec["card_batched_vs_batch1_decode_rel_err_max"] = max(errs)
    rec["ok"] = rec["card_batched_vs_batch1_decode_rel_err_max"] <= 2e-3 and all(
        rec[f"{m}_finite"] and rec[f"{m}_f32_act_rel_err_max"] <= 2e-3 and rec[f"{m}_q4_act_ok"]
        and rec[f"{m}_f32_act_launches_ok"] for m in ("dense", "paged"))
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: batched parity outside its bars")


# ---------------------------------------------------------------------------
# phase 4: serve four requests through LlamaRunner on a 32-layer 7B file
# ---------------------------------------------------------------------------


def serve(torch, workdir: str, profile: bool) -> dict:
    """Phase 4: write the synthetic 7B file, load it twice (as it is, and
    with fused wqkv/w13 params) and serve four requests on the unfused
    runner; the file stays for the TP phase (``serve_tp``)."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig, RunnerConfig, SamplingConfig
    from llama_swift_torch.runtime.runner import LlamaRunner

    cfg = ModelConfig.llama_7b(ftype=GGMLType.Q4_0)
    path = os.path.join(workdir, "synthetic-7b-q4_0.bin")
    t0 = time.perf_counter()
    write_model(path, cfg, seed=2024)
    log({"case": "write_model", "seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path)})

    load_paths(torch, path)
    runner, fused_runner = LlamaRunner(path), LlamaRunner(path, fuse_layer_matmuls=True)
    for r in (runner, fused_runner):
        r.ensure_loaded()
        log({"case": "load", "fused": r.fuse_layer_matmuls, "seconds": r.stats["t_load_s"],
             "device_gib": torch.cuda.memory_allocated() / 2**30})
    # (name, config, KV cache dtype of runner.config for the request)
    requests = [
        ("greedy_device", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=1, top_k=1)), "float32"),
        ("sampled_device", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=2)), "float32"),
        ("sampled_host", RunnerConfig(num_tokens=32, device_sampling=False, sampling=SamplingConfig(seed=3)),
         "float32"),
        ("greedy_device_int8", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=4, top_k=1)), "int8"),
    ]
    ops.reset_launch_counts()  # the main path's run starts here
    per_request = run_requests(torch, runner, requests, PROMPTS + ENGINE_PROMPTS[3:], composed(runner.config.n_layer))
    counts = ops.launch_counts()  # read just after the main path's run
    if profile:
        profile_decode(torch, runner)
    return {"launches": counts, "requests": per_request, "runner": runner, "fused_runner": fused_runner,
            "path": path}


def composed(n_layer: int, n_mm: int = 7, matvec: str = "q4_0_matvec", dequant: str = "q4_0_dequant"):
    """``expected(kv_dtype, forwards)`` of a composed runner request: n_mm·L + 1
    products a forward on ``matvec`` and L of the cache's flash kernel, and
    n_mm·L + 1 ``dequant`` launches for the prefill."""
    def expected(kv_dtype, forwards):
        flash = "flash_decode_attention_stacked_int8" if kv_dtype == "int8" else "flash_decode_attention"
        return {matvec: (n_mm * n_layer + 1) * forwards, flash: n_layer * forwards, dequant: n_mm * n_layer + 1}
    return expected


def load_paths(torch, path: str) -> None:
    """The 7B file's load through the Python reader and through the native
    mapping (the runners' default), once each, from the page cache (the file
    was just written): the loader alone, and the loader plus the params on
    the card (what ``LlamaRunner.stats["t_load_s"]`` measures)."""
    from llama_swift_torch.formats import ggml
    from llama_swift_torch.models import llama as model_lib

    rec = {"case": "load_paths"}
    for name, native in (("reader", False), ("mapping", True)):
        t0 = time.perf_counter()
        mf = ggml.load_model_file(path, use_native=native)
        rec[f"{name}_file_s"] = time.perf_counter() - t0
        params = model_lib.params_from_tensors(mf.tensors, mf.config, device="cuda")
        torch.cuda.synchronize()
        rec[f"{name}_t_load_s"] = time.perf_counter() - t0
        rec[f"{name}_native_handle"] = mf.native_handle is not None
        if mf.native_handle is not None:
            mf.native_handle.close()
        del mf, params
        torch.cuda.empty_cache()
    log(rec)
    if not rec["mapping_native_handle"] or rec["reader_native_handle"]:
        raise SystemExit("chip_smoke: the 7B load did not take the path asked for")


def run_requests(torch, runner, requests, prompts, expected, **overrides) -> list:
    """Serve each request through ``runner.run_events`` with
    ``runner.config.kv_cache_dtype`` set for it (and ``overrides`` of the
    model config, such as ``quantize_activations=False``); each must
    complete its 32 tokens with exactly ``expected(kv_dtype, forwards)``
    launches (every other kernel 0).  Each record's ``_text`` (not logged)
    is the request's whole output."""
    from llama_swift_torch import ops
    from llama_swift_torch.runtime.events import EventKind

    model_cfg = runner.config
    per_request = []
    for (name, rcfg, kv_dtype), prompt in zip(requests, prompts):
        runner.config = dataclasses.replace(model_cfg, kv_cache_dtype=kv_dtype, **overrides)
        before = ops.launch_counts()
        t1 = time.perf_counter()
        events = list(runner.run_events(prompt, rcfg))
        wall = time.perf_counter() - t1
        after = ops.launch_counts()
        runner.config = model_cfg
        kinds = [e.kind for e in events]
        if kinds[-1] != EventKind.COMPLETED:
            raise SystemExit(f"chip_smoke: request {name} failed: {events[-1].error}")
        st = dict(runner.stats)
        forwards = st["generated_tokens"] - (0 if rcfg.device_sampling else 1)
        delta = {k: after[k] - before[k] for k in after}
        expect = {k: 0 for k in delta}
        expect.update(expected(kv_dtype, forwards))
        rec = {"case": "serve", "request": name, "fused": runner.fuse_layer_matmuls, "kv_cache": kv_dtype,
               **overrides, "prompt_tokens": st["prompt_tokens"], "generated_tokens": st["generated_tokens"],
               "t_prefill_s": st["t_prefill_s"], "t_decode_s": st["t_decode_s"],
               "decode_tok_per_s": st.get("decode_tok_per_s"), "wall_s": wall, "launches": delta,
               "expected_launches": expect,
               "text_tail": "".join(e.token for e in events if e.kind == EventKind.OUTPUT_TOKEN)[-60:]}
        log(rec)
        rec["_text"] = "".join(e.token for e in events if e.kind == EventKind.OUTPUT_TOKEN)
        if delta != expect or st["generated_tokens"] != rcfg.num_tokens:
            raise SystemExit(f"chip_smoke: request {name}: launches {delta} != expected {expect}")
        per_request.append(rec)
    return per_request


def serve_fused(torch, runner, profile: bool) -> dict:
    """Phase 4, fused: two requests on the fused params (greedy on an f32
    cache, sampled on a bf16 one), each decoded token one whole-stack
    launch plus the output matvec, each prefill 4·L + 1 dequant launches."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import RunnerConfig, SamplingConfig

    requests = [
        ("greedy_device_fused", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=5, top_k=1)), "float32"),
        ("sampled_device_fused_bf16", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=6)), "bfloat16"),
    ]
    n_layer = runner.config.n_layer
    ops.reset_launch_counts()  # the fused path's run starts here
    per_request = run_requests(
        torch, runner, requests, PROMPTS[:2],
        lambda kv, forwards: {"fused_layers_block": forwards, "q4_0_matvec": forwards,
                              "q4_0_dequant": 4 * n_layer + 1})
    counts = ops.launch_counts()  # read just after
    if profile:
        from llama_swift_torch.models import llama as model_lib

        cfg, params = runner.config, runner.params
        tok = torch.tensor(1, device="cuda")
        cache = model_lib.init_cache(cfg, device="cuda")
        profile_window(torch, "profile_fused_decode_8_steps",
                       lambda i: model_lib.decode_step(params, tok, i, cache, cfg))
        del cache
    return {"launches": counts, "requests": per_request}


def check_perplexity_of_text(torch, runner, readme: str) -> None:
    """``perplexity_of_text`` on the start of README.md (the text the
    perplexity tool scored) against ``perplexity`` of the same text
    tokenized, on the runner's Q4_1 params with the tool's exact-f32
    prefill: the same windows on the same kernels give the same ppl."""
    import dataclasses

    from llama_swift_torch.utils.perplexity import perplexity, perplexity_of_text

    with open(readme, encoding="utf-8") as f:
        text = f.read()[:4000]
    cfg = dataclasses.replace(runner.config, prefill_bf16=False)
    got = perplexity_of_text(runner.params, cfg, runner.vocab, text)
    want = perplexity(runner.params, cfg, np.asarray(runner.vocab.tokenize(text, bos=False)))
    rec = {"case": "perplexity_of_text_q4_1", "chars": len(text), **got, "tokenized_ppl": want["ppl"],
           "identical": got == want}
    rec["ok"] = (got["n_scored"] == want["n_scored"] > 0 and math.isfinite(got["ppl"])
                 and abs(got["ppl"] - want["ppl"]) <= 1e-6 * want["ppl"])
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: perplexity_of_text disagrees with the tokenized call")
    torch.cuda.empty_cache()


def serve_q4_1(torch, workdir: str, profile: bool) -> list:
    """Phase 5: a synthetic 32-layer 7B Q4_1 file (5.05 GB, written from a
    seed), scored by the port's perplexity tool (2 windows of 512 tokens of
    README.md: 225 Q4_1 dequant launches a window), then loaded plain and
    fused and removed; two requests through ``LlamaRunner`` (f32 and int8
    caches: 225 Q4_1 matvec launches a token, 225 dequant a prefill), one on
    the fused params (129 and 129; no whole-stack launch: that kernel reads
    Q4_0), and one engine wave (8 requests through 4 dense f32 slots, 16
    tokens each: 225 dequant launches a step and a chunk, no multi-row
    launch).  Returns the launch counts of each run."""
    import io

    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig, RunnerConfig, SamplingConfig
    from llama_swift_torch.runtime.runner import LlamaRunner
    from llama_swift_torch.tools import perplexity as ppl_tool

    cfg = ModelConfig.llama_7b(ftype=GGMLType.Q4_1)
    path = os.path.join(workdir, "synthetic-7b-q4_1.bin")
    t0 = time.perf_counter()
    write_model(path, cfg, seed=2025)
    log({"case": "write_model", "ftype": "q4_1", "seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path)})
    runs = []

    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)), "README.md")
    out = io.StringIO()
    ops.reset_launch_counts()  # the perplexity tool's run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = ppl_tool.main(["--model", path, "--text", readme, "--n-ctx", "512", "--max-windows", "2"])
    wall = time.perf_counter() - t0
    runs.append(ops.launch_counts())  # read just after
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    expect = {k: 0 for k in runs[-1]}
    expect["q4_1_dequant"] = (7 * cfg.n_layer + 1) * len(summary["window_s"])
    rec = {"case": "perplexity_q4_1", "wall_s": wall, **summary, "launches": runs[-1], "expected_launches": expect}
    log(rec)
    if code != 0 or runs[-1] != expect or summary["n_scored"] != 512 or not math.isfinite(summary["ppl"]):
        raise SystemExit("chip_smoke: the Q4_1 perplexity run failed its checks")
    torch.cuda.empty_cache()

    runner, fused_runner = LlamaRunner(path), LlamaRunner(path, fuse_layer_matmuls=True)
    for r in (runner, fused_runner):
        r.ensure_loaded()
        log({"case": "load", "ftype": "q4_1", "fused": r.fuse_layer_matmuls, "seconds": r.stats["t_load_s"],
             "device_gib": torch.cuda.memory_allocated() / 2**30})
    os.remove(path)
    n_layer = cfg.n_layer
    check_perplexity_of_text(torch, runner, readme)

    ops.reset_launch_counts()  # the runner's Q4_1 run starts here
    run_requests(torch, runner, [
        ("greedy_device_q4_1", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=7, top_k=1)), "float32"),
        ("sampled_device_q4_1_int8", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=8)), "int8"),
    ], PROMPTS[:2], composed(n_layer, 7, "q4_1_matvec", "q4_1_dequant"))
    runs.append(ops.launch_counts())  # read just after
    ops.reset_launch_counts()  # the fused Q4_1 run starts here
    run_requests(torch, fused_runner, [
        ("greedy_device_q4_1_fused", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=9, top_k=1)),
         "float32")], PROMPTS[2:], composed(n_layer, 4, "q4_1_matvec", "q4_1_dequant"))
    runs.append(ops.launch_counts())  # read just after
    ops.reset_launch_counts()  # the Q4_1 f32-activation run starts here
    run_requests(torch, runner, [
        ("greedy_device_q4_1_f32_acts", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=10, top_k=1)),
         "float32")], PROMPTS[2:], composed(n_layer, 7, "q4_1_matvec_f32", "q4_1_dequant"), quantize_activations=False)
    runs.append(ops.launch_counts())  # read just after
    profile_f32_decode(torch, runner, "profile_q4_1_f32_decode_8_steps")
    del fused_runner
    torch.cuda.empty_cache()
    runs.append(serve_engine(torch, runner, [("F_q4_1_dense_f32", 4, dict(cache_dtype=torch.float32),
                                              ENGINE_PROMPTS[:8], [None] * 8, "flash_decode_attention_batched")],
                             n_predict=16))
    if profile:
        from llama_swift_torch.models import llama as model_lib

        tok = torch.tensor(1, device="cuda")
        cache = model_lib.init_cache(runner.config, device="cuda")
        profile_window(torch, "profile_q4_1_decode_8_steps",
                       lambda i: model_lib.decode_step(runner.params, tok, i, cache, runner.config))
        cache = model_lib.init_cache_batched(runner.config, 4, device="cuda")
        toks = torch.ones(4, dtype=torch.int64, device="cuda")
        profile_window(torch, "profile_q4_1_engine_step_8_steps_B4", lambda i: model_lib.forward_batched(
            runner.params, toks, np.arange(4) * 8 + i, cache, runner.config))
        del cache
    return runs


ENGINE_PROMPTS = PROMPTS + [
    "The quick brown fox jumps over the lazy dog",
    "In the beginning",
    "def main():",
    "Four score and seven years ago",
    "Call me Ishmael.",
    "It was the best of times, it was the worst of times,",
    "Hello, world",
    "The capital of France is",
    "Water boils at",
    "Once more unto the breach, dear friends,",
    "A journey of a thousand miles",
    "for i in range(10):",
    "The answer to the question is",
    "She sells sea shells",
    "Under the sea",
    "To be or not to be",
    "In a hole in the ground there lived",
]


def engine_waves(torch) -> list:
    """Phase 4b's waves on the unfused params: (name, slots, cache,
    prompts, per-request seeds, the flash kernel of the wave)."""
    half_seeded = [None, 11, None, 12, None, 13, None, 14]
    return [
        ("A_dense_f32", 8, dict(cache_dtype=torch.float32), ENGINE_PROMPTS[:12],
         [None] * 12, "flash_decode_attention_batched"),
        ("B_paged_bf16", 8, dict(cache_dtype=torch.bfloat16, paged_pages=17, page=128), ENGINE_PROMPTS[:8],
         half_seeded, "flash_decode_attention_paged"),
        ("C_dense_int8", 16, dict(cache_dtype=torch.int8), ENGINE_PROMPTS[:20],
         [None] * 20, "flash_decode_attention_batched_int8"),
        ("D_paged_int8", 8, dict(cache_dtype=torch.int8, paged_pages=17, page=128), ENGINE_PROMPTS[12:20],
         half_seeded, "flash_decode_attention_paged_int8"),
    ]


def serve_engine(torch, runner, waves, n_predict: int = 32, **overrides) -> dict:
    """Waves through the continuous-batching Engine on the runner's 32-layer
    7B params (nothing written or loaded again), ``n_predict`` tokens a
    request, the runner's model config with ``overrides``: per decode step
    7·L + 1 multi-row launches on unfused params (the f32-activation kernel
    with ``quantize_activations=False``), 4·L + 1 on fused ones, and L of
    the wave's flash kernel; per prefill chunk as many dequant launches as
    multi-row ones per step.  On Q4_1 params every step dequantizes instead
    (no Q4_1 multi-row kernel)."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import SamplingConfig
    from llama_swift_torch.ops.q4_matvec import Q4_1Weight
    from llama_swift_torch.runtime.engine import Engine

    n_mm = 4 if "wqkv" in runner.params["layers_stacked"] else 7  # matmuls a layer
    q4_1 = isinstance(runner.params["layers_stacked"]["wo"], Q4_1Weight)
    cfg = dataclasses.replace(runner.config, **overrides)
    multi = "q4_0_matmul_multi" if cfg.quantize_activations else "q4_0_matmul_multi_f32"
    counts = {}
    for name, slots, kw, prompts, seeds, flash in waves:
        eng = Engine(runner.params, cfg, runner.vocab, max_slots=slots, prefill_bucket=64, seed=2024, **kw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # this wave's run starts here
        t0 = time.perf_counter()
        with eng:
            handles = [eng.submit(p, SamplingConfig(n_predict=n_predict, seed=sd)) for p, sd in zip(prompts, seeds)]
            outs = [list(h.tokens(timeout=300)) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()  # read just after
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        st = dict(eng.stats)
        n_layer = runner.config.n_layer  # n_mm matmuls a layer plus the output projection
        expect = {k: 0 for k in got}
        per = n_mm * n_layer + 1
        if q4_1:
            expect.update({"q4_1_dequant": per * (st["decode_steps"] + st["prefill_chunks"]),
                           flash: n_layer * st["decode_steps"]})
        else:
            expect.update({multi: per * st["decode_steps"], flash: n_layer * st["decode_steps"],
                           "q4_0_dequant": per * st["prefill_chunks"]})
        streams_ok = all(
            len(h.token_ids) == len(runner.vocab.tokenize(p, bos=True)) + n_predict
            and "".join(o[: len(runner.vocab.tokenize(p, bos=True))]) == "".join(
                runner.vocab.piece_str(t) for t in runner.vocab.tokenize(p, bos=True))
            for p, h, o in zip(prompts, handles, outs))
        ttft = sorted(st.get("ttft_s", []))
        rec = {"case": "engine_serve", "wave": name, "fused": n_mm == 4, "q4_1": q4_1, **overrides,
               "requests": len(prompts),
               "max_slots": slots,
               "decode_steps": st["decode_steps"], "device_sampled_steps": st["device_sampled_steps"],
               "prefill_chunks": st["prefill_chunks"], "tokens_generated": st["tokens_generated"],
               "wall_s": wall, "aggregate_tok_per_s": st["tokens_generated"] / wall,
               "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None, "ttft_max_s": ttft[-1] if ttft else None,
               "launches": got, "expected_launches": expect, "streams_ok": streams_ok}
        if eng.paged:
            rec["pages_free"] = len(eng._free_pages)
            rec["pages_ok"] = sorted(eng._free_pages) == list(range(16))
        log(rec)
        if not streams_ok or got != expect or st["tokens_generated"] != n_predict * len(prompts) \
                or not rec.get("pages_ok", True) or eng.dead is not None:
            raise SystemExit(f"chip_smoke: engine wave {name} failed its checks")
        del eng
        torch.cuda.empty_cache()
    return counts


def profile_f32_decode(torch, runner, name: str) -> None:
    """A profiled 8-step window of batch-1 decode with f32 activations on
    the runner's params (the device idle share of that path)."""
    from llama_swift_torch.models import llama as model_lib

    cfg = dataclasses.replace(runner.config, quantize_activations=False)
    tok = torch.tensor(1, device="cuda")
    cache = model_lib.init_cache(cfg, device="cuda")
    profile_window(torch, name, lambda i: model_lib.decode_step(runner.params, tok, i, cache, cfg))
    del cache


def serve_f32_acts(torch, runner) -> list:
    """On the 32-layer 7B Q4_0 params: one runner request with
    ``runner.config.quantize_activations = False`` (225 f32-activation
    matvec and 32 flash launches a token, 225 dequant for the 64-row
    prefill), engine wave G of wave A's shape with f32 activations (225
    f32-activation multi-row launches a step), profiled windows of both;
    then a seeded ``rng_impl="mt19937"`` host-sampled request served twice,
    which must stream the same tokens through the native sampler.  Each run
    is counted from 0; returns the counts of each."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import RunnerConfig, SamplingConfig
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.runtime.sampler import SamplerState

    n_layer, runs = runner.config.n_layer, []
    ops.reset_launch_counts()  # the f32-activation runner run starts here
    run_requests(torch, runner, [
        ("greedy_device_f32_acts", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=21, top_k=1)),
         "float32")], PROMPTS[:1], composed(n_layer, 7, "q4_0_matvec_f32"), quantize_activations=False)
    runs.append(ops.launch_counts())  # read just after
    profile_f32_decode(torch, runner, "profile_f32_decode_8_steps")
    runs.append(serve_engine(torch, runner, [("G_dense_f32_f32_acts", 8, dict(cache_dtype=torch.float32),
                                              ENGINE_PROMPTS[:12], [None] * 12, "flash_decode_attention_batched")],
                             quantize_activations=False))
    cfg = dataclasses.replace(runner.config, quantize_activations=False)
    cache = model_lib.init_cache_batched(cfg, 8, device="cuda")
    toks = torch.ones(8, dtype=torch.int64, device="cuda")
    profile_window(torch, "profile_f32_engine_step_8_steps_B8", lambda i: model_lib.forward_batched(
        runner.params, toks, np.arange(8) * 8 + i, cache, cfg))
    del cache

    sampling = SamplingConfig(seed=23, rng_impl="mt19937")
    native = SamplerState(sampling)._native is not None
    rcfg = RunnerConfig(num_tokens=32, device_sampling=False, sampling=sampling)
    ops.reset_launch_counts()  # the mt19937 host-sampled run starts here
    recs = run_requests(torch, runner, [("sampled_host_mt19937_a", rcfg, "float32"),
                                        ("sampled_host_mt19937_b", rcfg, "float32")], PROMPTS[1:2] * 2,
                        composed(n_layer))
    runs.append(ops.launch_counts())  # read just after
    rec = {"case": "mt19937_host_sampling", "native_sampler": native, "same_tokens": recs[0]["_text"] == recs[1]["_text"],
           "text_tail": recs[0]["text_tail"]}
    log(rec)
    if not (rec["native_sampler"] and rec["same_tokens"]):
        raise SystemExit("chip_smoke: the seeded mt19937 host-sampled requests differ or skipped the native sampler")
    return runs


# ---------------------------------------------------------------------------
# tensor parallelism (parallel/, serve.py) and the T layout
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def nccl_group_of_one(torch):
    """A real NCCL process group of one rank (tcp://127.0.0.1:<free port>)."""
    from llama_swift_torch.parallel.multihost import init_distributed, shutdown

    device = init_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, device="cuda")
    if torch.distributed.get_backend() != "nccl":
        raise SystemExit("chip_smoke: the card's process group is not NCCL")
    try:
        yield device
    finally:
        shutdown()


def tp_forward(torch, tensors, cfg, device, mesh, **build_kw):
    """(params, forward, cache) of the TP path on ``device`` over ``mesh``."""
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.parallel import tp as tp_lib

    params = tp_lib.shard_params_tp(model_lib.params_from_tensors(tensors, cfg, device=device, **build_kw), mesh)
    cache = tp_lib.shard_cache_tp(model_lib.init_cache(cfg, device=device), mesh)
    return params, tp_lib.make_tp_forward(cfg, params, cache), cache


@contextlib.contextmanager
def forcing(own, card_record):
    """While active, the i-th Q4_0 product input (every matvec, multi-row
    product, activation fake-quantization and T-layout integer or multi-row
    product, in ``recording``'s order) is
    appended to ``own`` (as ``recording`` appends it, tagged None) and
    replaced by the card's input in ``card_record[i]``, so
    that both devices quantize the same activations: no 4-bit code can flip
    between them, and the inputs themselves are compared instead."""
    from llama_swift_torch.ops import quantized_matmul as qmm

    matvec, multi, fq40 = qmm.q4_0_matvec, qmm.q4_0_matmul_multi, qmm.fake_quantize_q4_0
    int_t, multi_t = qmm.q4_0_int_matmul, qmm.q4_0_t_matmul_multi

    def take(x):
        i = len(own)
        own.append((None, x.reshape(-1, x.shape[-1]).cpu()))
        if i >= len(card_record) or card_record[i][1].shape != own[-1][1].shape:
            raise SystemExit(f"chip_smoke: product {i} has no card input of shape {tuple(own[-1][1].shape)}")
        return card_record[i][1].reshape(x.shape).to(device=x.device, dtype=x.dtype)

    qmm.q4_0_matvec = lambda x, w, **k: matvec(take(x), w, **k)
    qmm.q4_0_matmul_multi = lambda x, w, **k: multi(take(x), w, **k)
    qmm.fake_quantize_q4_0 = lambda x: fq40(take(x))
    qmm.q4_0_int_matmul = lambda x, w: int_t(take(x), w)
    qmm.q4_0_t_matmul_multi = lambda x, w, **k: multi_t(take(x), w, **k)
    try:
        yield
    finally:
        qmm.q4_0_matvec, qmm.q4_0_matmul_multi, qmm.fake_quantize_q4_0 = matvec, multi, fq40
        qmm.q4_0_int_matmul, qmm.q4_0_t_matmul_multi = int_t, multi_t


#: (name, fused, build arguments, activations, the T gates (MAX_INT_KERNEL_ROWS, MAX_MULTI_ROWS_T))
TP_CASES = [
    ("v_fused", True, dict(q4_layout="v"), "q4", (0, 0)),
    ("v_fused", True, dict(q4_layout="v"), "f32", (0, 0)),
    ("t", False, dict(shard_pad=128), "q4", (0, 0)),
    ("t", False, dict(shard_pad=128), "f32", (0, 0)),
    ("t_fused", True, dict(shard_pad=128), "q4", (0, 0)),
]
#: path A's gates: (a) every product on row 12; (b) decode on row 13
INT_TP_CASES = [
    ("t_int", False, dict(shard_pad=128), "q4", (64, 0)),
    ("t_multi", False, dict(shard_pad=128), "q4", (0, 32)),
    ("t_multi", False, dict(shard_pad=128), "f32", (0, 32)),
]


@contextlib.contextmanager
def t_gates(max_int: int, max_multi: int):
    """``ops/q4_matmul``'s two T gates raised while active, restored after."""
    from llama_swift_torch.ops import q4_matmul as qm

    saved = qm.MAX_INT_KERNEL_ROWS, qm.MAX_MULTI_ROWS_T
    qm.MAX_INT_KERNEL_ROWS, qm.MAX_MULTI_ROWS_T = max_int, max_multi
    try:
        yield
    finally:
        qm.MAX_INT_KERNEL_ROWS, qm.MAX_MULTI_ROWS_T = saved


def t_product_counts(fused: bool, n_layer: int, gates, n_rows: int) -> dict:
    """The launches of one T-layout forward of ``n_rows`` rows: every
    product on the wrapper that ``linear``'s gates pick (7·L + 1 products,
    4·L + 1 fused)."""
    n_mm = (4 if fused else 7) * n_layer + 1
    max_int, max_multi = gates
    if n_rows <= max_int:
        return {"q4_0_int_matmul": n_mm}
    if n_rows <= max_multi:
        return {"q4_0_t_matmul_multi": n_mm}
    return {"q4_0_matmul_t": n_mm}


def check_tp_parity(torch, cases=TP_CASES) -> None:
    """TP parity at 7B width, 2 layers, in a real NCCL group of one: the V
    layout (fused, fuse_shards=1) and the T layout (shard_pad=128, unfused
    and fused: on the card the default layout of such a build) through
    ``make_tp_forward`` on the card, against the same forward on the CPU
    without a group (the kernels' plain versions): the logits of a
    64-row prefill (9 prompt tokens, right-padded) and of 4 decode steps.
    With f32 activations within 1e-5.  With 4-bit activations the CPU runs
    on the card's product inputs (``forcing``), so no code flips between
    the devices; then the logits and every product's input (the prompt's
    rows) are within 2e-3 of the card's, with no exemption for flips.  On
    the T layout every card forward is exactly 7·L + 1 (4·L + 1 fused)
    launches of the wrapper the case's gates pick (``t_product_counts``:
    at the gates 0 the T kernel, prefill and decode alike; ``INT_TP_CASES``
    raise them as path A does, both devices under the same gates)."""
    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.parallel.mesh import make_mesh, single_device_mesh

    base = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2, prefill_bf16=False)
    tensors = dict(synthetic_tensors(base, seed=7))
    prompt, length = model_lib.pad_tokens([1, 450, 17, 3000, 9, 222, 31000, 5, 77], 64)
    steps = [77, 12000, 345, 6]

    def run(device, cfg, build_kw, record, force=None):
        out = []
        with recording(record, [None]) if force is None else forcing(record, force):
            if device == "cpu":  # the CPU's default layout is the logical one: ask for T
                params, fwd, cache = tp_forward(torch, tensors, cfg, "cpu", single_device_mesh(),
                                                **{"q4_layout": "t", **build_kw})
            else:
                params, fwd, cache = tp_forward(torch, tensors, cfg, device, make_mesh(), **build_kw)
            per = []
            logits, cache = fwd(params, torch.as_tensor(prompt.astype(np.int64), device=device), 0, cache)
            out.append(logits[:length].float().cpu())
            for i, tok in enumerate(steps):
                before = ops.launch_counts()
                logits, cache = fwd(params, torch.tensor([tok], device=device), length + i, cache)
                per.append({k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]})
                out.append(logits[0].float().cpu())
        return out, per

    rec = {"case": "tp_parity_7b_width_2_layers"}
    with nccl_group_of_one(torch) as device:
        for name, fused, build_kw, act, gates in cases:
            cfg = dataclasses.replace(base, fuse_layer_matmuls=fused, quantize_activations=act == "q4")
            rec_cpu, rec_card = ([], []) if act == "q4" else (None, None)
            key = f"{name}_{act}"
            before = ops.launch_counts()
            with t_gates(*gates):
                card, per = run(device, cfg, build_kw, rec_card)
                prefill = {k: v - before[k] for k, v in ops.launch_counts().items()}
                t0 = time.perf_counter()
                cpu, _ = run("cpu", cfg, build_kw, rec_cpu, force=rec_card)
                rec[f"{key}_cpu_s"] = time.perf_counter() - t0
            rec[f"{key}_prefill_rel_err"] = rel_err(card[0], cpu[0])
            rec[f"{key}_decode_rel_err_max"] = max(rel_err(a, b) for a, b in zip(card[1:], cpu[1:]))
            rec[f"{key}_finite"] = all(bool(torch.isfinite(t).all()) for t in card)
            bar = 2e-3 if act == "q4" else 1e-5
            ok = rec[f"{key}_prefill_rel_err"] <= bar and rec[f"{key}_decode_rel_err_max"] <= bar
            if act == "q4":  # the prompt's rows of every product input (no padding row reaches them)
                pairs = [(c[:length], g[:length]) for (_, c), (_, g) in zip(rec_cpu, rec_card)]
                rec[f"{key}_products"] = len(pairs)
                rec[f"{key}_input_rel_err_max"] = max(rel_err(c, g) for c, g in pairs)
                # the codes that would have flipped had the CPU quantized its own inputs
                rec[f"{key}_flips_held_off"] = sum(int(f.sum()) for f in flip_counts(
                    [(None, c) for c, _ in pairs], [(None, g) for _, g in pairs]))
                ok = ok and len(rec_cpu) == len(rec_card) and rec[f"{key}_input_rel_err_max"] <= bar
            if name.startswith("t"):  # every product on the gates' wrapper, the prefill's 64 rows too
                step = t_product_counts(fused, cfg.n_layer, gates, 1)
                first = t_product_counts(fused, cfg.n_layer, gates, len(prompt))
                rec[f"{key}_step_launches"] = per[0]
                ok = ok and all(p.get(k) == v and "q4_0_dequant" not in p for p in per for k, v in step.items())
                ok = ok and all(prefill[k] - sum(p.get(k, 0) for p in per) == v for k, v in first.items())
            rec[f"{key}_ok"] = ok and rec[f"{key}_finite"]
    rec["ok"] = all(v for k, v in rec.items() if k.endswith("_ok"))
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: TP parity outside its bars")


SERVE_LINE = re.compile(r"\[serve\] (\d+) tokens, ([\d.]+) tok/s decode, prefill ([\d.]+)s")


def t_forward_run(torch, fwd, params, cache, device, n_layer: int, n_tok: int, gates, name: str) -> dict:
    """The 32-layer T-layout TP forward: a 40-token prompt in the 64-row
    bucket and ``n_tok`` greedy tokens, the launch counters reset just
    before and read just after; exactly 7·L + 1 launches a forward of the
    wrapper that the T gates pick for its rows (``t_product_counts``), L
    flash launches a decoded token and nothing else.  Returns the counts."""
    from llama_swift_torch import ops
    from llama_swift_torch.models import llama as model_lib

    prompt, length = model_lib.pad_tokens(list(range(1, 41)), 64)
    ops.reset_launch_counts()  # the T path's run starts here
    t0 = time.perf_counter()
    logits, cache = fwd(params, torch.as_tensor(prompt.astype(np.int64), device=device), 0, cache)
    tok = logits[length - 1].argmax().reshape(1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks = []
    t0 = time.perf_counter()
    for i in range(n_tok):
        logits, cache = fwd(params, tok, length + i, cache)
        tok = logits[0].argmax().reshape(1)
        toks.append(tok)
    ids = torch.cat(toks).tolist()
    t_decode = time.perf_counter() - t0
    counts = ops.launch_counts()  # read just after
    expect = {k: 0 for k in counts}
    expect.update(t_product_counts(False, n_layer, gates, len(prompt)))
    for k, v in t_product_counts(False, n_layer, gates, 1).items():
        expect[k] += v * n_tok
    expect["flash_decode_attention"] = n_layer * n_tok
    rec = {"case": name, "gates": list(gates), "prefill_s": t_prefill, "decode_s": t_decode,
           "decode_tok_per_s": n_tok / t_decode, "launches": {k: v for k, v in counts.items() if v},
           "ids_tail": ids[-8:], "finite": bool(torch.isfinite(logits).all())}
    log(rec)
    if counts != expect or not rec["finite"] or len(ids) != n_tok:
        raise SystemExit(f"chip_smoke: T-layout TP forward {name}: launches {counts} != expected {expect}")
    return counts


def serve_tp_v(torch, path: str, n_layer: int, n_tok: int) -> dict:
    """``llama_swift_torch.serve.main`` on the 7B file at tp = 1 (see
    ``serve_tp``); returns its launch counts."""
    import io

    from llama_swift_torch import ops, serve as serve_mod

    ops.reset_launch_counts()  # the V serve path's run starts here
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_mod.main(["--model", path, "--tp", "1", "--coordinator", f"127.0.0.1:{free_port()}",
                             "--num-processes", "1", "--process-id", "0", "--n-tokens", "32", "--seed", "5"])
    counts = ops.launch_counts()  # read just after
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    m = SERVE_LINE.search(text)
    expect = {k: 0 for k in counts}
    expect.update({"q4_0_matvec": (4 * n_layer + 1) * n_tok, "flash_decode_attention": n_layer * n_tok,
                   "q4_0_dequant": 4 * n_layer + 1})
    rec = {"case": "serve_tp_v", "rc": rc, "wall_s": wall, "tokens": int(m.group(1)) if m else None,
           "decode_tok_per_s": float(m.group(2)) if m else None, "prefill_s": float(m.group(3)) if m else None,
           "launches": {k: v for k, v in counts.items() if v}, "text_tail": text[-160:]}
    log(rec)
    if rc != 0 or rec["tokens"] != n_tok or counts != expect:
        raise SystemExit(f"chip_smoke: serve.main: rc {rc}, launches {counts} != expected {expect}")
    torch.cuda.empty_cache()
    return counts


def serve_tp(torch, path: str, profile: bool, int_only: bool = False) -> list:
    """The TP serving paths on the 32-layer 7B Q4_0 file, each with the
    launch counters reset just before and read just after:

    * ``llama_swift_torch.serve.main`` in this process (its own NCCL group
      of one, tp = 1: the V layout, fused, as the JAX serve at tp = 1), 32
      sampled tokens: exactly 129 ``q4_0_matvec`` and 32
      ``flash_decode_attention`` launches a token and 129 ``q4_0_dequant``
      for the 64-row prefill;
    * the T layout (params with shard_pad=128: the card's default layout
      for a TP build) through ``make_tp_forward`` in a NCCL group of one: a
      64-row prefill and 32 greedy tokens, exactly 225 ``q4_0_matmul_t``
      launches a forward (prefill and decode alike) and 32 flash a token,
      no dequant; with ``--profile`` an 8-step window of its decode;
    * path A, the same T forward with 16 greedy tokens under raised gates:
      (a) ``MAX_INT_KERNEL_ROWS = 64``, 225 ``q4_0_int_matmul`` launches a
      forward, the 64-row prefill too; (b) ``MAX_MULTI_ROWS_T = 32``, 225
      ``q4_0_t_matmul_multi`` a decoded token and 225 ``q4_0_matmul_t`` for
      the prefill; the gates restored after each.

    ``int_only`` runs path A alone.  Returns each run's launch counts."""
    from llama_swift_torch.formats import ggml
    from llama_swift_torch.parallel.mesh import make_mesh

    runs = []
    n_layer, n_tok = 32, 32
    if not int_only:
        runs.append(serve_tp_v(torch, path, n_layer, n_tok))
    mf = ggml.load_model_file(path)
    cfg = mf.config
    with nccl_group_of_one(torch) as device:
        t0 = time.perf_counter()
        params, fwd, cache = tp_forward(torch, mf.tensors, cfg, device, make_mesh(), shard_pad=128)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if mf.native_handle is not None:
            mf.native_handle.close()
        del mf
        log({"case": "tp_t_load", "t_load_s": t_load})
        if not int_only:  # the gates at 0: serving's T path
            runs.append(t_forward_run(torch, fwd, params, cache, device, n_layer, n_tok, (0, 0), "serve_tp_t"))
            if profile:
                tok1 = torch.ones(1, dtype=torch.int64, device=device)
                profile_window(torch, "profile_tp_t_decode_8_steps",
                               lambda i: fwd(params, tok1, 40 + n_tok + i, cache))
        # path A: the same forward with the integer gates raised, 16 tokens each
        for name, gates in (("path_a_int_64", (64, 0)), ("path_a_multi_32", (0, 32))):
            with t_gates(*gates):
                runs.append(t_forward_run(torch, fwd, params, cache, device, n_layer, 16, gates, name))
        del params, cache
    torch.cuda.empty_cache()
    return runs


def decode_r4(torch, params, cfg, n_past: int = 127) -> dict:
    """Path B, the JAX package's "two kernels per layer" decode step, on the
    fused 32-layer 7B params: one token at ``n_past`` through L attention
    blocks and L FFN blocks; per layer the attention block, the caller's
    write of k_new/v_new at n_past into an f32 cache (history rows from a
    seed), the residual add, the FFN block, the residual add.  The counters
    are reset just before and read just after: exactly L launches of each
    block and nothing else.  The final x is held against the whole-stack
    kernel on the same inputs (a copy of the cache): within 5e-4 where no
    4-bit activation code differs (both traced), else the flips counted and
    held below ``FUSED_FLIP_LIMIT``; the rows written at n_past likewise.
    Times a step of each on the card.  Returns the blocks' launch counts."""
    from llama_swift_torch import ops
    from llama_swift_torch.ops import fused_layer as fl
    from llama_swift_torch.ops.q4_matvec import quantize_activations_q4_0_int

    st = params["layers_stacked"]
    L, H, D = cfg.n_layer, cfg.n_head, cfg.n_embd
    g = torch.Generator(device="cuda").manual_seed(127)
    kc = torch.randn((L, H, cfg.n_ctx, fl.HEAD_DIM), device="cuda", generator=g)
    vc = torch.randn((L, H, cfg.n_ctx, fl.HEAD_DIM), device="cuda", generator=g)
    x0 = torch.randn(D, device="cuda", generator=g)
    cos, sin = fl.rope_vectors(n_past, device="cuda")
    kw = dict(norm_type=cfg.norm_type, eps=cfg.norm_eps)

    def step(trace=None):
        x = x0
        for il in range(L):
            tr = [] if trace is not None else None
            delta, k_new, v_new = fl.fused_attn_block(x, st["attention_norm"][il], cos, sin, st["wqkv"], st["wo"],
                                                      kc, vc, il, n_past, trace=tr, **kw)
            kc[il, :, n_past], vc[il, :, n_past] = k_new, v_new
            x = x + delta
            x = x + fl.fused_ffn_block(x, st["ffn_norm"][il], st["w13"], st["w2"], il,
                                       fuse_shards=params.fuse_shards, trace=tr, **kw)
            if trace is not None:
                trace.append(torch.cat(tr))
        return x

    km, vm = kc.clone(), vc.clone()
    tr_b, tr_m = [], []
    ops.reset_launch_counts()  # path B's run starts here
    x_b = step(tr_b)
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # read just after
    expect = {k: 0 for k in counts}
    expect.update(fused_attn_block=L, fused_ffn_block=L)
    mega = lambda i: fl.fused_layers_block(  # noqa: E731
        x0, st["attention_norm"], st["ffn_norm"], st["wqkv"], st["wo"], st["w13"], st["w2"], km, vm, n_past, **kw)
    x_m = fl.fused_layers_block(x0, st["attention_norm"], st["ffn_norm"], st["wqkv"], st["wo"], st["w13"], st["w2"],
                                km, vm, n_past, trace=tr_m, **kw)
    flips = int((quantize_activations_q4_0_int(torch.stack(tr_b))[0]
                 != quantize_activations_q4_0_int(tr_m[0])[0]).sum())
    err = rel_err(x_b, x_m)
    kv_err = max(rel_err(a[:, :, n_past], b[:, :, n_past]) for a, b in ((kc, km), (vc, vm)))
    t0 = time.perf_counter()
    for _ in range(8):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 8 * 1e3
    blocks_ms, mega_ms = time_ms(torch, lambda i: step(), 5), time_ms(torch, mega, 10)
    rec = {"case": "path_b_r4_decode", "layers": L, "n_past": n_past, "launches": {k: v for k, v in counts.items()
                                                                                   if v},
           "max_rel_err": err, "max_abs_err": float((x_b - x_m).abs().max()), "kv_new_rel_err": kv_err,
           "q4_flips": flips, "blocks_step_ms": blocks_ms, "blocks_wall_ms": wall_ms, "megakernel_ms": mega_ms,
           "blocks_tok_per_s_device": 1e3 / blocks_ms, "megakernel_tok_per_s_device": 1e3 / mega_ms}
    rec["ok"] = counts == expect and bool(torch.isfinite(x_b).all()) and (
        (err <= 5e-4 and kv_err <= 5e-4) or 0 < flips <= FUSED_FLIP_LIMIT)
    log(rec)
    if not rec["ok"]:
        raise SystemExit(f"chip_smoke: path B (two kernels a layer) failed: {rec}")
    del kc, vc, km, vm
    torch.cuda.empty_cache()
    return counts


def decode_r4_from_file(torch, path: str) -> dict:
    """Path B on fused params loaded from the 7B file (``--only int``)."""
    from llama_swift_torch.formats import ggml
    from llama_swift_torch.models import llama as model_lib

    mf = ggml.load_model_file(path)
    cfg = dataclasses.replace(mf.config, fuse_layer_matmuls=True)
    params = model_lib.params_from_tensors(mf.tensors, cfg, device="cuda")
    if mf.native_handle is not None:
        mf.native_handle.close()
    del mf
    counts = decode_r4(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# dense-dequant params (params_from_tensors(dense_dequant=True)) and the aux modules
# ---------------------------------------------------------------------------


def check_parity_dense(torch) -> None:
    """Dense-dequant params at 7B width and 2 layers, bf16 on both devices:
    an 8-token prefill and 4 decode steps, card vs CPU within 2e-3 (the
    same bf16 weights, f32 products summed in other orders).  The card's
    load makes exactly one Q4_0 dequant launch a packed tensor (7·L + 2) and
    its forwards no launch of a Q4 kernel (decode: the flash kernel only)."""
    import dataclasses

    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig
    from llama_swift_torch.models import llama as model_lib

    cfg = dataclasses.replace(ModelConfig.llama_7b(ftype=GGMLType.Q4_0), n_layer=2)
    tensors = dict(synthetic_tensors(cfg, seed=17))
    prompt = [1, 450, 17, 3000, 9, 222, 31000, 5]
    steps = [77, 12000, 345, 6]

    def run(device):
        ops.reset_launch_counts()
        params = model_lib.params_from_tensors(tensors, cfg, device=device, param_dtype=torch.bfloat16,
                                               dense_dequant=True)
        load = ops.launch_counts()
        ops.reset_launch_counts()
        cache = model_lib.init_cache(cfg, device=device)
        logits, cache = model_lib.prefill(params, torch.tensor(prompt, device=device), 0, cache, cfg)
        out = [logits[-1].float().cpu()]
        for i, tok in enumerate(steps):
            lg, cache = model_lib.decode_step(params, torch.tensor(tok, device=device), len(prompt) + i, cache, cfg)
            out.append(lg.float().cpu())
        return out, load, ops.launch_counts()

    cpu, _, _ = run("cpu")
    card, load, fwd = run("cuda")
    errs = [rel_err(a, b) for a, b in zip(card, cpu)]
    want_load = {k: 0 for k in load}
    want_load["q4_0_dequant"] = 7 * cfg.n_layer + 2
    want_fwd = {k: 0 for k in fwd}
    want_fwd["flash_decode_attention"] = cfg.n_layer * len(steps)
    rec = {"case": "parity_dense_dequant_7b_width_2_layers", "param_dtype": "bfloat16",
           "prefill_rel_err": errs[0], "decode_rel_err_max": max(errs[1:]),
           "load_launches": {k: v for k, v in load.items() if v},
           "forward_launches": {k: v for k, v in fwd.items() if v},
           "finite": all(bool(torch.isfinite(t).all()) for t in card)}
    rec["ok"] = rec["finite"] and max(errs) <= 2e-3 and load == want_load and fwd == want_fwd
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: dense-dequant parity failed its checks")


def serve_dense(torch, path: str, workdir: str) -> dict:
    """The 32-layer 7B Q4_0 file loaded with ``dense_dequant=True`` (bf16,
    13.5 GB on the card; 226 dequant launches), a prompt prefilled and 32
    greedy tokens through ``greedy_decode_loop`` (32 flash launches a
    token, no Q4 kernel); counters reset just before the load and read just
    after the decode.  Then ``utils/profiling.trace`` around one decode
    step must write a non-empty trace.  Returns the launch counts."""
    from llama_swift_torch import ops
    from llama_swift_torch.formats import ggml
    from llama_swift_torch.models import llama as model_lib
    from llama_swift_torch.tokenizer import BOS_TOKEN_ID, Vocab
    from llama_swift_torch.utils import profiling

    n_tok = 32
    ops.reset_launch_counts()  # the dense-dequant path's run starts here
    t0 = time.perf_counter()
    mf = ggml.load_model_file(path)
    cfg = mf.config
    params = model_lib.params_from_tensors(mf.tensors, cfg, device="cuda", param_dtype=torch.bfloat16,
                                           dense_dequant=True)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    ids = [BOS_TOKEN_ID] + Vocab(mf.vocab).tokenize(PROMPTS[0])
    if mf.native_handle is not None:
        mf.native_handle.close()
    del mf
    cache = model_lib.init_cache(cfg, device="cuda")
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(params, torch.tensor(ids, device="cuda"), 0, cache, cfg)
    first = logits[-1].argmax()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, cache = model_lib.greedy_decode_loop(params, first, len(ids), cache, cfg, n_tok)
    toks = toks.cpu()
    t_decode = time.perf_counter() - t0
    counts = ops.launch_counts()  # read just after
    expect = {k: 0 for k in counts}
    expect.update(q4_0_dequant=7 * cfg.n_layer + 2, flash_decode_attention=cfg.n_layer * n_tok)
    trace_dir = os.path.join(workdir, "trace")
    with profiling.trace(trace_dir):
        lg, _ = model_lib.decode_step(params, toks[-1].to("cuda"), len(ids) + n_tok, cache, cfg)
        torch.cuda.synchronize()
    traces = [os.path.getsize(os.path.join(trace_dir, f)) for f in os.listdir(trace_dir)]
    rec = {"case": "serve_dense_dequant_7b", "param_dtype": "bfloat16", "t_load_s": t_load,
           "device_gib": torch.cuda.memory_allocated() / 2**30, "prompt_tokens": len(ids),
           "t_prefill_s": t_prefill, "decode_tokens": n_tok, "t_decode_s": t_decode,
           "decode_tok_per_s": n_tok / t_decode, "launches": {k: v for k, v in counts.items() if v},
           "trace_bytes": traces, "finite": bool(torch.isfinite(logits).all() and torch.isfinite(lg).all())}
    rec["ok"] = counts == expect and rec["finite"] and len(traces) == 1 and traces[0] > 0
    log(rec)
    if not rec["ok"]:
        raise SystemExit(f"chip_smoke: the dense-dequant 7B run failed its checks: {rec}")
    del params, cache
    torch.cuda.empty_cache()
    return counts


def check_aux(torch) -> None:
    """ggml ops (mul_mat, soft_max, rope, flash_attn) and one Adam run on
    the card against the CPU, within 1e-5 relative: the same f32
    arithmetic (matrix products in full f32, PyTorch's default) in other
    orders."""
    from llama_swift_torch.ops import ggml_compat as gc
    from llama_swift_torch.utils.optimize import opt

    g = torch.Generator().manual_seed(9)
    a, b = torch.randn(64, 256, generator=g), torch.randn(32, 256, generator=g)
    scores = gc.diag_mask_inf(torch.randn(4, 16, 24, generator=g), 8)
    x = torch.randn(24, 4, 64, generator=g)
    q, k, v = torch.randn(16, 4, 64, generator=g), torch.randn(24, 4, 64, generator=g), torch.randn(24, 4, 64,
                                                                                                    generator=g)
    target = torch.randn(128, generator=g)

    def adam(dev):
        t = target.to(dev)
        return opt(lambda z: ((z - t) ** 2).sum() + 0.1 * (z ** 4).sum(), torch.zeros(128, device=dev),
                   method="adam", n_iter=50, alpha=0.05, eps_f=0.0, eps_g=0.0).x

    cases = {
        "mul_mat": lambda d: gc.mul_mat(a.to(d), b.to(d)),
        "soft_max": lambda d: gc.soft_max(scores.to(d)),
        "rope": lambda d: gc.rope(x.to(d), 5, 64, 0),
        "rope_mode1": lambda d: gc.rope(x.to(d), 5, 64, 1),
        "flash_attn": lambda d: gc.flash_attn(q.to(d), k.to(d), v.to(d), True),
        "adam_50_steps": adam,
    }
    errs = {name: rel_err(fn("cuda").cpu(), fn("cpu")) for name, fn in cases.items()}
    rec = {"case": "aux_card_vs_cpu", "rel_err": errs, "ok": max(errs.values()) <= 1e-5}
    log(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: an aux op disagrees between the card and the CPU")


def profile_window(torch, name: str, step, n_steps: int = 8) -> None:
    """Device busy share and kernel time by name over ``n_steps`` calls of
    ``step(i)`` after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, n_steps + 1):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side kernel events only (op rows repeat their kernels' time)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    log({"case": name, "wall_ms_per_step": wall / n_steps * 1e3,
         "device_busy_ms_per_step": busy_s / n_steps * 1e3 if rows else None,
         "device_idle_share": 1 - busy_s / wall if rows else None,
         "launches_per_step": sum(r[2] for r in rows) / n_steps,
         "top_kernels_us_per_step": [[k, us / n_steps, n // n_steps] for us, k, n in rows[:12]]})


def profile_decode(torch, runner) -> None:
    """Batch-1 decode steps and engine decode steps: f32 cache at B = 8 as
    before, then an int8 batch-1 step and an int8 engine step at B = 16."""
    from llama_swift_torch.models import llama as model_lib

    cfg, params = runner.config, runner.params
    tok = torch.tensor(1, device="cuda")
    for name, dtype in (("profile_decode_8_steps", None), ("profile_decode_int8_8_steps", torch.int8)):
        cache = model_lib.init_cache(cfg, dtype=dtype, device="cuda")
        profile_window(torch, name, lambda i: model_lib.decode_step(params, tok, i, cache, cfg))
        del cache
    for name, B, dtype in (("profile_engine_step_8_steps_B8", 8, None),
                           ("profile_engine_step_int8_8_steps_B16", 16, torch.int8)):
        cache = model_lib.init_cache_batched(cfg, B, dtype=dtype, device="cuda")
        toks = torch.ones(B, dtype=torch.int64, device="cuda")
        n_pasts = np.arange(B) * 8  # slots at different positions
        profile_window(torch, name, lambda i: model_lib.forward_batched(params, toks, n_pasts + i, cache, cfg))
        del cache


# ---------------------------------------------------------------------------


KERNEL_META = {  # the port's kernel: (its source, the TPU kernel it replaces, at its def)
    "q4_0_matvec": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:276"),
    "flash_decode_attention": ("llama_swift_torch/csrc/flash_decode.cu", "llama_swift_tpu/ops/attention.py:229"),
    "q4_0_dequant": ("llama_swift_torch/csrc/q4_dequant.cu", "llama_swift_tpu/ops/q4_dequant_pallas.py:109"),
    "q4_0_matmul_multi": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:795"),
    "flash_decode_attention_batched": ("llama_swift_torch/csrc/flash_decode.cu",
                                       "llama_swift_tpu/ops/attention.py:498"),
    "flash_decode_attention_paged": ("llama_swift_torch/csrc/flash_decode.cu",
                                     "llama_swift_tpu/ops/attention.py:744"),
    "flash_decode_attention_stacked_int8": ("llama_swift_torch/csrc/flash_decode.cu",
                                            "llama_swift_tpu/ops/attention.py:277"),
    "flash_decode_attention_batched_int8": ("llama_swift_torch/csrc/flash_decode.cu",
                                            "llama_swift_tpu/ops/attention.py:544"),
    "flash_decode_attention_paged_int8": ("llama_swift_torch/csrc/flash_decode.cu",
                                          "llama_swift_tpu/ops/attention.py:789"),
    "fused_layers_block": ("llama_swift_torch/csrc/fused_layer.cu",
                           "llama_swift_tpu/ops/q4_fused_layer.py:709"),
    "q4_1_matvec": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:287"),
    "q4_1_dequant": ("llama_swift_torch/csrc/q4_dequant.cu", "llama_swift_tpu/ops/q4_dequant_pallas.py:73"),
    # f32 activations: the same TPU kernels fed unquantized rows (_prep_inputs*, quantize_acts=False)
    "q4_0_matvec_f32": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:276"),
    "q4_1_matvec_f32": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:287"),
    "q4_0_matmul_multi_f32": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:795"),
    "q4_0_matmul_t": ("llama_swift_torch/csrc/q4_matmul_t.cu", "llama_swift_tpu/ops/q4_matmul_pallas.py:424"),
    "q4_0_int_matmul": ("llama_swift_torch/csrc/q4_int_mma.cu", "llama_swift_tpu/ops/q4_matmul_pallas.py:196"),
    # the T multi-row product runs the V layout's multi-row and matvec kernels (one logical layout)
    "q4_0_t_matmul_multi": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_matmul_pallas.py:681"),
    "fused_attn_block": ("llama_swift_torch/csrc/fused_blocks.cu", "llama_swift_tpu/ops/q4_fused_layer.py:481"),
    "fused_ffn_block": ("llama_swift_torch/csrc/fused_blocks.cu", "llama_swift_tpu/ops/q4_fused_layer.py:320"),
    "stream_probe": ("llama_swift_torch/csrc/stream_probe.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:996"),
}

#: the kernels of the paths that ``--only q4_1|tp|int|bench`` run
ONLY_KERNELS = {
    "bench": ("q4_0_matvec", "q4_0_matvec_f32", "q4_0_matmul_t", "stream_probe"),
    "q4_1": ("q4_1_matvec", "q4_1_dequant", "q4_1_matvec_f32"),
    "tp": ("q4_0_matvec", "flash_decode_attention", "q4_0_dequant", "q4_0_matmul_t", "q4_0_int_matmul",
           "q4_0_t_matmul_multi"),
    "int": ("flash_decode_attention", "q4_0_matmul_t", "q4_0_int_matmul", "q4_0_t_matmul_multi", "fused_attn_block",
            "fused_ffn_block"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "q4_1", "tp", "int", "bench"], default=None,
                    help="kernels: build and kernel checks only; q4_1: those and the Q4_1 phases; "
                         "tp: those and the TP phases; int: those, the T integer paths' parity, "
                         "path B and path A; bench: those and the kernelbench path")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--log-dir", default=None, help="where to write the nvcc -Xptxas -v report")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from llama_swift_torch.ops import build

    card = card_line()
    log(card)
    log({"case": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    for stem in build.SOURCES:
        build.lib(stem)
    reg_lines = [ln.strip() for stem in build.SOURCES for ln in build.build_info.get(stem, "").splitlines()
                 if "registers" in ln or "spill" in ln]
    log({"case": "build", "seconds": time.perf_counter() - t0, "ptxas": reg_lines})
    from llama_swift_torch.native import bindings as native

    if not native.available():  # g++ is on every machine that builds CUDA
        raise SystemExit("chip_smoke: the native host library did not build")
    log({"case": "native", "library": os.path.relpath(native.loaded_path())})
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "ptxas.txt"), "w") as f:
            for stem in build.SOURCES:
                f.write(f"== {stem}\n{build.build_info.get(stem, '(cached build)')}\n")

    summary = check_kernels(torch)
    if args.only == "kernels":
        return 0
    runs = []
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.only in (None, "bench"):
            runs.append(run_kernelbench(torch))
        if args.only is None:
            check_parity(torch)
            check_parity_int8(torch)
            check_parity_fused(torch)
            check_batched_parity(torch)
            check_batched_parity(torch, torch.int8)
            served = serve(torch, workdir, args.profile)
            runs += [served["launches"], serve_engine(torch, served["runner"], engine_waves(torch))]
            runs += serve_f32_acts(torch, served["runner"])
            fused, path = served["fused_runner"], served["path"]
            del served
            torch.cuda.empty_cache()
            runs.append(serve_fused(torch, fused, args.profile)["launches"])
            runs.append(serve_engine(torch, fused, [("E_fused_dense_f32", 8, dict(cache_dtype=torch.float32),
                                                     ENGINE_PROMPTS[:12], [None] * 12,
                                                     "flash_decode_attention_batched")]))
            runs.append(decode_r4(torch, fused.params, fused.config))
            del fused
            torch.cuda.empty_cache()
            check_parity_dense(torch)
            runs.append(serve_dense(torch, path, workdir))
            check_aux(torch)
        if args.only in (None, "tp", "int"):
            check_tp_parity(torch, INT_TP_CASES if args.only == "int" else TP_CASES + INT_TP_CASES)
            if args.only in ("tp", "int"):
                from llama_swift_torch.config import GGMLType, ModelConfig

                path = os.path.join(workdir, "synthetic-7b-q4_0.bin")
                write_model(path, ModelConfig.llama_7b(ftype=GGMLType.Q4_0), seed=2024)
            if args.only == "int":
                runs.append(decode_r4_from_file(torch, path))
            runs += serve_tp(torch, path, args.profile, int_only=args.only == "int")
            os.remove(path)
        if args.only in (None, "q4_1"):
            check_parity_q4_1(torch)
            runs += serve_q4_1(torch, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: sum(r[k] for r in runs) for k in KERNEL_META}
    if args.only:  # the kernels of the paths that ran
        launches = {k: v for k, v in launches.items() if k in ONLY_KERNELS[args.only]}
    if not all(launches.values()):
        raise SystemExit(f"chip_smoke: a kernel of the serving paths never launched: {launches}")

    kernels = []
    for name in launches:
        (source, replaces), s = KERNEL_META[name], summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["kernel_ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"], "shape": s["shape"],
            **({"replaced_ms": s["replaced_ms"]} if "replaced_ms" in s else {}),
        })
    log({"kernels": kernels})
    log(card_line())
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
