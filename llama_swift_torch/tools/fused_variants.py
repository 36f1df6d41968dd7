"""Time variants of the whole-stack kernel (``csrc/fused_layer.cu``) against
the kernel as it stands, on one card, at 7B width and 32 layers.

    python -m llama_swift_torch.tools.fused_variants [--layers 32] [--iters 20]

Each variant is the current source with a few lines replaced (``VARIANTS``),
built with the package's nvcc flags into ``llama_swift_torch/_build/
variants/`` and launched through the same wrapper.  Variants run in turns,
the current kernel first and last (a, b, ..., b, a), at n_past 7, 127 and
511 (f32 caches); each line reports the device time per token and the largest difference of
its output from the current kernel's.  Variants that drop work
(``no_products``, ``no_attention``, ``barriers_only``) compute wrong results
on purpose: they attribute time; ``no_prefetch`` drops the L2 prefetch of
the next product's first rows and ``blocks_per_sm_2`` changes the launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import torch

from ..ops import build
from ..ops import fused_layer as fl
from ..ops.q4_matvec import Q4_0Weight

_ROWS_LOOP = "  for (int r0 = blockIdx.x * NW + (threadIdx.x >> 5); r0 < out; r0 += 2 * stride) {"
_PREFETCH = '  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(p), "r"(bytes) : "memory");'
_LAYER_LOOP = "  for (int il = 0; il < a.L; ++il) {"
_ATTENTION = "    attention<T>(a, il, cs, sn, sm, tr ? tr + D : nullptr);\n"
_ATTENTION_BEGIN = "    attention_begin<T>(a, il, sm);  // x and the norm weights are done with the pass's memory\n"

#: name -> [(text of csrc/fused_layer.cu, its replacement)]
VARIANTS = {
    # every phase but the weight products: norms, quantization, staging
    # copies, attention, the gate blocks' arrivals and the grid barriers
    # (no product row is written: the results are wrong on purpose)
    "no_products": [(_ROWS_LOOP, "  if (out > 0) return;\n" + _ROWS_LOOP)],
    # the products without the L2 prefetch issued before each barrier
    "no_prefetch": [(_PREFETCH, "  (void)p, (void)bytes;")],
    # every phase but attention (phase B: its bulk copies, splits and combine)
    "no_attention": [(_ATTENTION, ""), (_ATTENTION_BEGIN, "")],
    # the five grid barriers of each layer and nothing else
    "barriers_only": [(_LAYER_LOOP, "  for (int il = 0; il < 5 * a.L; ++il) grid.sync();\n  if (a.L > 0) return;\n"
                       + _LAYER_LOOP)],
    "blocks_per_sm_2": [("constexpr int BLOCKS_PER_SM = 1;", "constexpr int BLOCKS_PER_SM = 2;")],
}


def variant_source(name: str, csrc_dir: str = build.CSRC_DIR) -> str:
    """``csrc/fused_layer.cu`` with variant ``name``'s replacements; raises
    unless each replaced text occurs exactly once."""
    with open(os.path.join(csrc_dir, "fused_layer.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not found once in fused_layer.cu")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> ctypes.CDLL:
    src = variant_source(name)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in build.SOURCES["fused_layer"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_ms(fn, iters: int) -> float:
    """Device time per call, the calls queued behind a sleep kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_variants: needs a CUDA device")
    libs = {"current": build.lib("fused_layer")}
    libs.update({name: build_variant(name) for name in VARIANTS})
    g = torch.Generator(device="cuda").manual_seed(7)
    L, H, F, n_ctx = args.layers, 32, 11008, 512
    D = H * fl.HEAD_DIM

    def q4(out, in_dim):  # scaled so that W·x keeps the activation scale
        qs = torch.randint(0, 256, (L, out, in_dim // 2), dtype=torch.uint8, device="cuda", generator=g)
        d = torch.rand((L, out, in_dim // 32), device="cuda", generator=g) * (2.0 / (4.6 * math.sqrt(in_dim)))
        return Q4_0Weight(qs, d)

    weights = [q4(3 * D, D), q4(D, D), q4(2 * F, D), q4(D, F)]
    norms = [1.0 + 0.05 * torch.randn((L, D), device="cuda", generator=g) for _ in range(2)]
    x = torch.randn(D, device="cuda", generator=g)
    kc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g)
    vc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device="cuda", generator=g)
    order = list(libs) + list(reversed(libs))
    try:
        for n_past in (7, 127, 511):
            ref = None
            for name in order:
                build._libs["fused_layer"] = libs[name]
                run = lambda: fl.fused_layers_block(x, *norms, *weights, kc, vc, n_past)  # noqa: E731
                y = run()
                ref = y if ref is None else ref
                print(json.dumps({"variant": name, "layers": L, "n_past": n_past, "ms": time_ms(run, args.iters),
                                  "max_abs_diff_vs_current": float((y - ref).abs().max())}), flush=True)
    finally:
        build._libs["fused_layer"] = libs["current"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
