"""Time variants of two kernels against the kernels as they stand, on one
card: the T layout's integer product (``q4_0_int_matmul``: the multi-row
kernel ``q4_0_matmul_multi_kernel<NT>`` of ``csrc/q4_matvec.cu`` at 33–64
rows) and the attention block (``fused_attn_block``: ``attn_block_kernel``
of ``csrc/fused_layer.cu``).

    python -m llama_swift_torch.tools.block_variants [--iters 100] [--variants terms_rounded,tile16k]

Each variant is the current source of its kernel with a few lines replaced
(``VARIANTS``), built with the package's nvcc flags into
``llama_swift_torch/_build/variants/`` and called through the package's own
wrapper (its library swapped in for the call).  Variants run in turns, the
current kernel first and last (a, b, ..., b, a); the integer product at
7B's four shapes and 33, 64 and 100 rows on a round robin of weight copies
that streams more than 200 MB (cold L2), with the current kernel also
without its cluster (``ks1``: the plan's splits forced to 1); the
attention block at 7B width (32 heads, 2 layers) at n_past 0, 127 and 511
on f32 and bf16 caches.  Each line reports the device time per call and
the largest difference from the current kernel's output.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import subprocess
from unittest import mock

import torch

from ..ops import build
from ..ops import fused_layer as fl
from ..ops import q4_matmul as qm
from ..ops import q4_matvec as mv
from .kernelbench import time_ms

SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
ROWS = [33, 64, 100]
NPASTS = [0, 127, 511]

_FMA = "              if constexpr (NT > 4) {  // ... but from 33 rows the product and the sum in one rounding"
_STAGES = "__host__ __device__ constexpr int mm_stages(int np) { return np == 32 ? 2 : 3; }"
_TILE = "constexpr int BLOCK_STAGE_BYTES = 32768;"
_BEGIN = "  block_attention_begin<T>(a, sm);  // x and the norm weights are done with the pass's memory\n"
_BEGUN = "        sm.outp, -1, nullptr, nullptr, item == blockIdx.x);"

#: name -> (source stem, [(text of csrc/<stem>.cu, its replacement)])
VARIANTS = {
    # 33-64 rows: each block's term rounded, then added, as at 1-32 rows (four f32 operations an output, not three)
    "terms_rounded": ("q4_matvec", [(_FMA, "              if constexpr (false) {")]),
    # 33-64 rows: two ring stages (97-129 KB a block) where the kernel holds three
    "stages2": ("q4_matvec", [(_STAGES, "__host__ __device__ constexpr int mm_stages(int np) { return np >= 32 ? 2 : 3; }")]),
    # the attention block's ring tiles of 16 KB (16 f32 or 32 bf16 rows, the whole-stack kernel's) and 48 KB
    "tile16k": ("fused_layer", [(_TILE, "constexpr int BLOCK_STAGE_BYTES = 16384;")]),
    "tile48k": ("fused_layer", [(_TILE, "constexpr int BLOCK_STAGE_BYTES = 49152;")]),
    # no K/V tile started during the wqkv product: phase B starts its copies after barrier 1
    "no_begin": ("fused_layer", [(_BEGIN, ""), (_BEGUN, "        sm.outp, -1, nullptr, nullptr, false);")]),
}


def variant_source(name: str, csrc_dir: str = build.CSRC_DIR) -> str:
    """The variant's source: its kernel's file with its replacements; raises
    unless each replaced text occurs exactly once."""
    stem, edits = VARIANTS[name]
    with open(os.path.join(csrc_dir, stem + ".cu")) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not found once in {stem}.cu")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """Compile every variant at once (one nvcc each); {name: library}."""
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        cu, so = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, name + ".so")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SOURCES[VARIANTS[name][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _no_cluster(out, in_dim, N, sms=132):
    """``int_matmul_plan`` with no cluster on its 33-64-row launches (the
    ``ks1`` variant puts it in ``q4_matmul``'s namespace for the call)."""
    plan = mv.int_matmul_plan(out, in_dim, N, sms)
    return mv.IntMatmulPlan(tuple((n0, rows, dataclasses.replace(p, splits=1) if rows > mv.MAX_MULTI_ROWS else p)
                                  for n0, rows, p in plan.launches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_variants: needs a CUDA device")
    names = [n for n in args.variants.split(",") if n]
    libs = build_variants(names)
    for stem in {VARIANTS[n][0] for n in names}:
        build.lib(stem)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "variants": names}), flush=True)

    def turns(stem, extra=()):
        mine = [n for n in names if VARIANTS[n][0] == stem]
        order = ["current", *extra, *mine]
        return order + order[::-1]

    def run_as(name, stem, fn):
        """fn() with the variant's library (or the current one) in the package's place."""
        lib = libs.get(name, build.lib(stem))
        with mock.patch.dict(build._libs, {stem: lib}):
            if name == "ks1":
                with mock.patch.object(qm, "int_matmul_plan", _no_cluster):
                    return fn()
            return fn()

    for out, in_dim in SHAPES:
        wbytes = out * in_dim // 2 + out * (in_dim // 32) * 4
        n = max(2, math.ceil(2e8 / wbytes))
        w = qm.Q4_0WeightT(torch.randint(0, 256, (n * out, in_dim // 2), dtype=torch.uint8, device="cuda",
                                         generator=g).reshape(n, out, -1),
                           (torch.rand((n, out, in_dim // 32), device="cuda", generator=g) / math.sqrt(in_dim)))
        for rows in ROWS:
            x = torch.randn((rows, in_dim), device="cuda", generator=g)
            ref = qm.q4_0_int_matmul(x, w.layer(0))
            for name in turns("q4_matvec", ("ks1",)):
                y = run_as(name, "q4_matvec", lambda: qm.q4_0_int_matmul(x, w.layer(0)))
                ms = run_as(name, "q4_matvec", lambda: time_ms(lambda i: qm.q4_0_int_matmul(x, w.layer(i % n)),
                                                                args.iters, dev))
                print(json.dumps({"kernel": "q4_0_int_matmul", "variant": name, "shape": f"{out}x{in_dim}",
                                  "rows": rows, "us": ms * 1e3, "bit_equal": bool(torch.equal(y, ref)),
                                  "max_diff_of_max": float((y - ref).abs().max() / ref.abs().max())}), flush=True)
        del w
        torch.cuda.empty_cache()

    H, L = 32, 2
    D = H * fl.HEAD_DIM
    wqkv, wo = (mv.Q4_0Weight(torch.randint(0, 256, (L, o, i // 2), dtype=torch.uint8, device="cuda", generator=g),
                              torch.rand((L, o, i // 32), device="cuda", generator=g) / math.sqrt(i))
                for o, i in [(3 * D, D), (D, D)])
    an = 1.0 + 0.05 * torch.randn((L, D), device="cuda", generator=g)
    x = torch.randn(D, device="cuda", generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn((L, H, 512, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        vc = torch.randn((L, H, 512, fl.HEAD_DIM), device="cuda", generator=g).to(dtype)
        for n_past in NPASTS:
            cos, sin = fl.rope_vectors(n_past, device="cuda")
            call = lambda i: fl.fused_attn_block(x, an[i % L], cos, sin, wqkv, wo, kc, vc, i % L, n_past)  # noqa: E731
            ref = call(1)[0]
            for name in turns("fused_layer"):
                y = run_as(name, "fused_layer", lambda: call(1)[0])
                ms = run_as(name, "fused_layer", lambda: time_ms(call, args.iters, dev))
                print(json.dumps({"kernel": "fused_attn_block", "variant": name, "cache": str(dtype).split(".")[-1],
                                  "n_past": n_past, "us": ms * 1e3, "bit_equal": bool(torch.equal(y, ref)),
                                  "max_diff_of_max": float((y - ref).abs().max() / ref.abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
