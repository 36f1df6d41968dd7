"""Time variants of the 4-bit-activation matvecs' kernel
(``q4_matvec_kernel<Block>`` in ``csrc/q4_matvec.cu``: ``q4_0_matvec`` and
``q4_1_matvec``) against the kernel as it stands, on one card, at LLaMA-7B's
shapes.

    python -m llama_swift_torch.tools.matvec_variants [--iters 200] [--variants ring2,warps8] [--kinds q4_0]

Each variant is the current source with a few lines replaced (``VARIANTS``:
the ring of weight blocks a lane keeps in flight, the warps of a block, the
blocks an SM, and the written-out contraction of the Q4_1 block term), built
with the package's nvcc flags into ``llama_swift_torch/_build/variants/``
and launched through its own C entry on a grid of ``blocks_per_sm`` blocks
an SM (fewer where the rows do not fill them).  Variants run in turns, the
current kernel first and last (a, b, ..., b, a), on a round robin of weight
copies that streams more than 200 MB (cold L2); each line reports the
device time per call, whether the output is the current kernel's bit for
bit, and the largest difference from it.
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
from ..ops import q4_matvec as mv
from .kernelbench import time_ms

SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096), (12288, 4096), (22016, 4096)]

_RING = "constexpr int MV_RING = 4;"
_WARPS = "constexpr int MV_WARPS = 32;"
_PER_SM = "constexpr int MV_BLOCKS_PER_SM = 1;"
_NX = "    const float nx = fmaf(s.x, nq, __fmul_rn(s.y, n));"
_TERM = "    return __fadd_rn(acc, fmaf(dm.y, s.z, __fmul_rn(dm.x, nx)));"
_QUANTIZE = "  quantize_x<Block>(xs, nb, xe, xo, meta);\n"
_BULK = "  const bool bulk = (reinterpret_cast<uintptr_t>(x) & 15) == 0;"
_FIRST = "  const int first = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;  // rows interleaved over the SMs"
_WLOAD = "      wq[u] = __ldcs(reinterpret_cast<const uint4*>(qs) + lo);  // streaming loads, as the stream probe's\n      wd[u] = __ldcs(sc + lo);\n"

#: name -> ([(text of csrc/q4_matvec.cu, its replacement)], warps a block, blocks an SM)
VARIANTS = {
    "ring2": ([(_RING, "constexpr int MV_RING = 2;")], 32, 1),
    "ring3": ([(_RING, "constexpr int MV_RING = 3;")], 32, 1),
    "ring6": ([(_RING, "constexpr int MV_RING = 6;")], 32, 1),
    "warps16_per_sm2": ([(_WARPS, "constexpr int MV_WARPS = 16;"), (_PER_SM, "constexpr int MV_BLOCKS_PER_SM = 2;")],
                        16, 2),
    "warps24": ([(_WARPS, "constexpr int MV_WARPS = 24;")], 24, 1),
    # the weights through L1 and the read-only path (__ldg)
    "ldg": ([(_WLOAD, "      wq[u] = __ldg(reinterpret_cast<const uint4*>(qs) + lo);\n      wd[u] = __ldg(sc + lo);\n")], 32, 1),
    # the nibbles without L1 allocation and with a 256-byte L2 prefetch hint
    "l2_256": ([(_WLOAD, "      asm(\"ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\" : \"=r\"(wq[u].x), "
                         "\"=r\"(wq[u].y), \"=r\"(wq[u].z), \"=r\"(wq[u].w) : \"l\"(reinterpret_cast<const uint4*>(qs) + lo));\n"
                         "      wd[u] = __ldcs(sc + lo);\n")], 32, 1),
    # block g on rows g * 32 + w + k * 32 * grid: blocks' rows differ by up to a row a warp
    "rows_by_block": ([(_FIRST, "  const int first = blockIdx.x * MV_WARPS + (threadIdx.x >> 5);")], 32, 1),
    # x's codes never written (the results are wrong on purpose): the time
    # of x's staging and quantization before the sums
    "no_quantize": ([(_QUANTIZE, "")], 32, 1),
    # x staged by plain loads, as where it is off 16-byte alignment
    "plain_x_loads": ([(_BULK, "  const bool bulk = false;")], 32, 1),
    # the Q4_1 term's other contractions (Q4_0 unchanged): the first
    # kernel's shows in the bits of an A/B call
    "q4_1_nx_min_first": ([(_NX, "    const float nx = fmaf(s.y, n, __fmul_rn(s.x, nq));")], 32, 1),
    "q4_1_term_d_first": ([(_TERM, "    return __fadd_rn(acc, fmaf(dm.x, nx, __fmul_rn(dm.y, s.z)));")], 32, 1),
}


def variant_source(name: str, csrc_dir: str = build.CSRC_DIR, source: str = "q4_matvec", variants=None) -> str:
    """``csrc/<source>.cu`` with variant ``name``'s replacements (of
    ``variants``, by default this tool's ``VARIANTS``); raises unless each
    replaced text occurs exactly once."""
    with open(os.path.join(csrc_dir, f"{source}.cu")) as f:
        src = f.read()
    for old, new in (VARIANTS if variants is None else variants)[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not found once in {source}.cu")
        src = src.replace(old, new)
    return src


def build_variants(names, source: str = "q4_matvec", variants=None, csrc_dir: str = build.CSRC_DIR) -> dict:
    """{name: loaded library} of the variants ``names`` of ``csrc_dir/<source>.cu``
    (see :func:`variant_source`), one nvcc process each, all started
    together; each library's C functions typed as ``build.SOURCES[source]``."""
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        cu, so = os.path.join(out_dir, f"{source}_{name}.cu"), os.path.join(out_dir, f"{source}_{name}.so")
        with open(cu, "w") as f:
            f.write(variant_source(name, csrc_dir, source, variants))
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc_dir, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{report}")
        print(json.dumps({"variant": name, "ptxas": [ln for ln in report.splitlines() if "_kernel" in ln
                                                     or "registers" in ln or "spill" in ln]}), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SOURCES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kinds", default="q4_0,q4_1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matvec_variants: needs a CUDA device")
    dev = torch.device("cuda")
    names = [n for n in args.variants.split(",") if n]
    libs = {"current": build.lib("q4_matvec"), **build_variants(names)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(11)
    order = list(libs) + list(reversed(libs))
    for kind in args.kinds.split(","):
        q4_1 = kind == "q4_1"
        for out, in_dim in SHAPES:
            wbytes = out * in_dim // 2 + out * (in_dim // 32) * (8 if q4_1 else 4)
            n = max(2, math.ceil(2e8 / wbytes))
            qs = torch.randint(0, 256, (n, out, in_dim // 2), dtype=torch.uint8, device=dev, generator=g)
            d = torch.rand((n, out, in_dim // 32), device=dev, generator=g) * (2.0 / (4.6 * math.sqrt(in_dim)))
            sc = torch.stack([d, -8.0 * d * (0.8 + 0.4 * torch.rand(d.shape, device=dev, generator=g))], -1) if q4_1 else d
            x = torch.randn(in_dim, device=dev, generator=g)
            ref = None
            for name in order:
                warps, per_sm = (mv.MV_WARPS, mv.MV_BLOCKS_PER_SM) if name == "current" else VARIANTS[name][1:]
                blocks = min(out, per_sm * sms)
                entry = getattr(libs[name], f"{kind}_matvec")
                y = torch.empty(out, device=dev)

                def run(i, entry=entry, blocks=blocks, y=y):
                    build.check(entry(qs[i % n].data_ptr(), sc[i % n].data_ptr(), x.data_ptr(), y.data_ptr(), out,
                                      in_dim, blocks, torch.cuda.current_stream().cuda_stream), kind)

                run(0)
                torch.cuda.synchronize()
                got = y.clone()
                ref = got if ref is None else ref
                print(json.dumps({"variant": name, "kind": kind, "out": out, "in": in_dim, "blocks": blocks,
                                  "us": time_ms(run, args.iters, dev) * 1e3,
                                  "bits_equal_current": bool(torch.equal(got, ref)),
                                  "max_abs_diff_vs_current": float((got - ref).abs().max())}), flush=True)
            del qs, d, sc
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
