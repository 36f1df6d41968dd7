#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``llama_swift_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # all phases; exits 0 only if all pass
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --profile       # adds a profiled decode window

Phases:

1. identify the card (name and power limit from nvidia-smi) and build the
   three CUDA kernels from ``llama_swift_torch/csrc`` (one nvcc each, in
   parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   7B shapes of the serving path, and time kernel, plain version, bound
   and (where one exists) a single PyTorch call computing the same function;
3. whole-path parity at full 7B width and 2 layers: card vs CPU (the
   kernels' plain versions), decode logits within 2e-3 relative (the repo's
   hardware parity bar, bench.py's ``--check``) with f32 prefill, and bf16
   prefill logits within 0.25 (see ``check_parity``);
4. serve three requests through ``LlamaRunner`` on a synthetic 32-layer 7B
   Q4_0 GGML file written from a seed, with the launch counters reset just
   before and read just after, and checked against 225 matvec and 32 flash
   launches per decoded token and 225 dequant launches per prefill;
5. print the kernel table as one JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.

There is no CPU mode: without a CUDA device the script exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
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
FLASH_NPAST = [0, 127, 128, 511]
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


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# synthetic 7B Q4_0 weights from a seed
# ---------------------------------------------------------------------------


def synthetic_tensors(cfg, seed: int):
    """(name, tensor) in loader naming: Q4_0 2-D weights with uniform random
    nibbles and scales sized so that W·x keeps the activation scale
    (``std(n-8) ≈ 4.6``); f32 norms near 1."""
    from llama_swift_torch.formats.ggml import expected_tensor_shapes
    from llama_swift_torch.formats.quant import Q4_0Tensor

    rng = np.random.default_rng(seed)
    for name, shape in expected_tensor_shapes(cfg).items():
        if len(shape) == 1:
            yield name, (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
            continue
        rows, cols = shape
        qs = rng.integers(0, 256, size=(rows, cols // 2), dtype=np.uint8)
        base = 1.0 if "tok_embeddings" in name else 1.0 / (4.6 * math.sqrt(cols))
        d = (base * rng.uniform(0.5, 1.5, size=(rows, cols // 32))).astype(np.float32)
        yield name, Q4_0Tensor(scales=d, qs=qs)


def vocab_pieces(n_vocab: int) -> list:
    pieces = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(32, 127)]
    pieces += [b" the", b"the", b"in", b"ing", b" a", b"on", b"er", b" s"]
    pieces += [f"<x{i}>".encode() for i in range(n_vocab - len(pieces))]
    return pieces


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


def check_kernels(torch) -> dict:
    """Returns {kernel name: summary at its representative shape}."""
    from llama_swift_torch.ops import attention as att
    from llama_swift_torch.ops import q4_dequant as dq
    from llama_swift_torch.ops import q4_matvec as mv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    summary = {}
    failed = []

    def rand_q4(n, out, in_dim):
        qs = torch.randint(0, 256, (n, out, in_dim // 2), dtype=torch.uint8, device=dev, generator=g)
        d = torch.rand((n, out, in_dim // 32), device=dev, generator=g) * (2.0 / (4.6 * math.sqrt(in_dim)))
        return mv.Q4_0Weight(qs, d)

    # matvec: enough weight copies that a round robin streams > 200 MB (cold L2)
    for out, in_dim in MATVEC_SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))
        w = rand_q4(n, out, in_dim)
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
            if dtype == torch.float32 and n_past == 511:
                summary["flash_decode_attention"] = dict(
                    case, bound_by="bytes", shape=f"H{H} Dh{dh} n_past{n_past} f32")
        del kc, vc

    # dequant 11008x4096 to bf16 and f32: bit-exact
    out, in_dim = 11008, 4096
    w = rand_q4(4, out, in_dim)
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


# ---------------------------------------------------------------------------
# phase 4: serve three requests through LlamaRunner on a 32-layer 7B file
# ---------------------------------------------------------------------------


def serve(torch, workdir: str, profile: bool) -> dict:
    from llama_swift_torch import ops
    from llama_swift_torch.config import GGMLType, ModelConfig, RunnerConfig, SamplingConfig
    from llama_swift_torch.runtime.events import EventKind
    from llama_swift_torch.runtime.runner import LlamaRunner

    cfg = ModelConfig.llama_7b(ftype=GGMLType.Q4_0)
    path = os.path.join(workdir, "synthetic-7b-q4_0.bin")
    t0 = time.perf_counter()
    write_model(path, cfg, seed=2024)
    log({"case": "write_model", "seconds": time.perf_counter() - t0, "bytes": os.path.getsize(path)})

    runner = LlamaRunner(path)
    requests = [
        ("greedy_device", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=1, top_k=1))),
        ("sampled_device", RunnerConfig(num_tokens=32, sampling=SamplingConfig(seed=2))),
        ("sampled_host", RunnerConfig(num_tokens=32, device_sampling=False, sampling=SamplingConfig(seed=3))),
    ]
    runner.ensure_loaded()
    os.remove(path)
    log({"case": "load", "seconds": runner.stats["t_load_s"],
         "device_gib": torch.cuda.memory_allocated() / 2**30})
    ops.reset_launch_counts()  # the main path's run starts here
    per_request = []
    for (name, rcfg), prompt in zip(requests, PROMPTS):
        before = ops.launch_counts()
        t1 = time.perf_counter()
        events = list(runner.run_events(prompt, rcfg))
        wall = time.perf_counter() - t1
        after = ops.launch_counts()
        kinds = [e.kind for e in events]
        if kinds[-1] != EventKind.COMPLETED:
            raise SystemExit(f"chip_smoke: request {name} failed: {events[-1].error}")
        st = dict(runner.stats)
        forwards = st["generated_tokens"] - (0 if rcfg.device_sampling else 1)
        delta = {k: after[k] - before[k] for k in after}
        expect = {"q4_0_matvec": 225 * forwards, "flash_decode_attention": 32 * forwards, "q4_0_dequant": 225}
        rec = {"case": "serve", "request": name, "prompt_tokens": st["prompt_tokens"],
               "generated_tokens": st["generated_tokens"], "t_prefill_s": st["t_prefill_s"],
               "t_decode_s": st["t_decode_s"], "decode_tok_per_s": st.get("decode_tok_per_s"),
               "wall_s": wall, "launches": delta, "expected_launches": expect,
               "text_tail": "".join(e.token for e in events if e.kind == EventKind.OUTPUT_TOKEN)[-60:]}
        log(rec)
        if delta != expect or st["generated_tokens"] != 32:
            raise SystemExit(f"chip_smoke: request {name}: launches {delta} != expected {expect}")
        per_request.append(rec)
    counts = ops.launch_counts()  # read just after the main path's run
    if profile:
        profile_decode(torch, runner)
    return {"launches": counts, "requests": per_request}


def profile_decode(torch, runner) -> None:
    """Device busy share and kernel time by name over 8 decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from llama_swift_torch.models import llama as model_lib

    cfg, params = runner.config, runner.params
    cache = model_lib.init_cache(cfg, device="cuda")
    tok = torch.tensor(1, device="cuda")
    model_lib.decode_step(params, tok, 0, cache, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, 9):
            model_lib.decode_step(params, tok, i, cache, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side kernel events only (op rows repeat their kernels' time)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    log({"case": "profile_decode_8_steps", "wall_ms_per_token": wall / 8 * 1e3,
         "device_busy_ms_per_token": busy_s / 8 * 1e3 if rows else None,
         "device_idle_share": 1 - busy_s / wall if rows else None,
         "top_kernels_us_per_token": [[k, us / 8, n // 8] for us, k, n in rows[:12]]})


# ---------------------------------------------------------------------------


KERNEL_META = {
    "q4_0_matvec": ("llama_swift_torch/csrc/q4_matvec.cu", "llama_swift_tpu/ops/q4_vpu_pallas.py:443"),
    "flash_decode_attention": ("llama_swift_torch/csrc/flash_decode.cu", "llama_swift_tpu/ops/attention.py:454"),
    "q4_0_dequant": ("llama_swift_torch/csrc/q4_dequant.cu", "llama_swift_tpu/ops/q4_dequant_pallas.py:145"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None)
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
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "ptxas.txt"), "w") as f:
            for stem in build.SOURCES:
                f.write(f"== {stem}\n{build.build_info.get(stem, '(cached build)')}\n")

    summary = check_kernels(torch)
    if args.only == "kernels":
        return 0
    check_parity(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        served = serve(torch, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": served["launches"][name], "max_abs_err": s["max_abs_err"],
            "ms": s["kernel_ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"], "shape": s["shape"],
        })
    log({"kernels": kernels})
    log(card_line())
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
