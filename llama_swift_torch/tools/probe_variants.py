"""Time variants of the HBM stream probe (``stream_probe_kernel`` in
``csrc/stream_probe.cu``) against the kernel as it stands, on one card, at
kernelbench's five shapes, and split a launch's fixed part.

    python -m llama_swift_torch.tools.probe_variants [--iters 200] [--variants warps16,tma_ring_s4_16k]
        [--shapes attn,qkv] [--parent DIR]

Each variant is the current source with a few lines replaced (``VARIANTS``),
built through ``tools/matvec_variants.build_variants`` into
``llama_swift_torch/_build/variants/``, and launched through its C entry on
the grid its ``VARIANTS`` entry names:

* the kernel with other constants (warps a block, loads a lane in flight),
  its warp sum by a butterfly of shuffles, its loads with a 256-byte L2
  prefetch;
* the designs it was chosen against: (c) a persistent grid of one or two
  blocks an SM, each on one contiguous span of whole rows read through a
  ring of bulk copies (TMA) in shared memory, at 2, 4 and 8 stages of 8, 16
  and 32 KB, with and without an L2 evict-first hint (``ring_plan``); (b)
  the same grid reading by a register ring of streaming loads across a
  warp's rows (row 1's structure); one bulk copy a block on the hardware's
  grid (``tma_rows``);
* a programmatic dependent launch (``griddepcontrol``: the next launch's
  blocks start while this one ends), recorded only: no product launches
  that way;
* the fixed-part split's two kernels: ``empty`` (the grid returns at once)
  and ``write_only`` (each warp writes its row's output and reads nothing).

``--parent DIR`` also builds ``DIR/stream_probe.cu`` as it is (an older
tree's ``csrc``, whose entry takes no block count) as the variant
``parent``.  Variants run in turns, the parent first and last, then the
current kernel (a, b, ..., b, a), each queued behind a sleep kernel and
timed with CUDA events (``kernelbench.time_ms``) on a round robin of copies
that streams more than 200 MB (the L2 holds 50 MB).  Each line reports the
device time per call, the rate of the nibble bytes and whether every row's
sum is the plain version's; a last line per shape splits the current
kernel's time (:func:`fixed_split`).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import math
import subprocess

import torch

from ..ops import build
from ..ops import q4_matvec as mv
from . import kernelbench as kb
from .matvec_variants import build_variants

_INCLUDE = "#include <stdint.h>\n"
_WARPS = "constexpr int PROBE_WARPS = 8;"
_LOADS = "constexpr int PROBE_LOADS = 4;"
_LANE = "  const int lane = threadIdx.x & 31;\n"
_GUARD = "  if (row >= rows) return;\n"
_LOAD = "__ldcs(p + k0 + u * 32)"
_SUM = "  acc = __reduce_add_sync(0xffffffffu, acc);  // redux.sync: the warp's sum in one instruction\n"
_GRID = "blocks != (rows + PROBE_WARPS - 1) / PROBE_WARPS"
_ARGS = "static_cast<const uint4*>(qs), static_cast<uint32_t>(bias), static_cast<float*>(out), rows, in_dim / 32"
_LAUNCH = ("  stream_probe_kernel<<<blocks, PROBE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(\n"
           f"      {_ARGS});\n")
_END = "}  // namespace\n"
_STREAM = "static_cast<cudaStream_t>(stream)"

# The kernels of the designs the probe was chosen against, inserted before the end of the source's namespace.
_KERNELS = r"""
__device__ __forceinline__ uint32_t warp_sum_u(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// An L2 policy that evicts the lines it touches first, and a bulk copy under it.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void bulk_load_evict_first(void* dst, const void* src, uint32_t bytes, uint64_t* b,
                                                      uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)), "l"(policy)
      : "memory");
}

// (c) the persistent grid of bulk copies: block g on one contiguous span of whole rows (the blocks' rows
// differ by one at most); a ring of `stages` slots of `stage_bytes` in shared memory, each completing on its
// own mbarrier; thread 0 issues the first `stages` copies before anything else; a stage holds as many whole
// rows as fit, or one piece of a row wider than a slot; the warps sum each stage from shared memory (a row
// by one warp, or by G warps whose sums meet in shared memory), one __syncthreads a stage, after which
// thread 0 refills the slot.
constexpr int RING_WARPS = 8;

// Shared memory of a launch: the ring, a barrier a slot, the warps' sums
// twice (ring_plan computes the same).
__host__ __device__ constexpr size_t ring_smem_bytes(int stages, int stage_bytes) {
  return static_cast<size_t>(stages) * stage_bytes + static_cast<size_t>(stages) * sizeof(uint64_t) +
         2 * RING_WARPS * sizeof(uint32_t);
}

// qs [rows][rv] as 16-byte vectors (rv = in/32), out [rows] f32; `stages`
// slots of `stage_bytes` (a multiple of 16) in dynamic shared memory.
template <bool EVICT_FIRST>
__global__ void __launch_bounds__(RING_WARPS * 32)
probe_tma_ring_kernel(const uint4* __restrict__ qs, uint32_t bias, float* __restrict__ out, int rows, int rv,
                    int stages, int stage_bytes) {
  extern __shared__ uint4 ring[];
  const int slot_vecs = stage_bytes / 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(stages) * slot_vecs);
  uint32_t* wsum = reinterpret_cast<uint32_t*>(full + stages);  // [2][RING_WARPS]
  const int base = rows / static_cast<int>(gridDim.x), extra = rows % static_cast<int>(gridDim.x);
  const int g = blockIdx.x;
  const int r0 = g * base + min(g, extra), n = base + (g < extra ? 1 : 0);  // this block's rows [r0, r0 + n)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a stage: R whole rows (pieces == 1), or piece q of one row (pv vectors, the last shorter)
  const int pieces = rv <= slot_vecs ? 1 : (rv + slot_vecs - 1) / slot_vecs;
  const int R = pieces == 1 ? slot_vecs / rv : 1;
  const int pv = (rv + pieces - 1) / pieces;
  const int ns = pieces == 1 ? (n + R - 1) / R : n * pieces;  // stages of this block
  const uint4* span = qs + static_cast<size_t>(r0) * rv;
  // stage s: its first vector in the span, its rows and its vectors a row
  auto stage = [&](int s, size_t& off, int& srows, int& svecs) {
    if (pieces == 1) {
      off = static_cast<size_t>(s) * R * rv;
      srows = min(R, n - s * R);
      svecs = rv;
    } else {
      const int q = s % pieces;
      off = static_cast<size_t>(s / pieces) * rv + static_cast<size_t>(q) * pv;
      srows = 1;
      svecs = min(pv, rv - q * pv);
    }
  };
  const uint64_t policy = EVICT_FIRST ? evict_first_policy() : 0;
  auto issue = [&](int s) {  // thread 0: copy stage s into its slot
    size_t off;
    int srows, svecs;
    stage(s, off, srows, svecs);
    const uint32_t bytes = static_cast<uint32_t>(srows) * svecs * 16;
    uint64_t* bar = full + s % stages;
    mbar_expect(bar, bytes);
    if constexpr (EVICT_FIRST)
      bulk_load_evict_first(ring + static_cast<size_t>(s % stages) * slot_vecs, span + off, bytes, bar, policy);
    else
      bulk_load(ring + static_cast<size_t>(s % stages) * slot_vecs, span + off, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(stages, ns); ++s) issue(s);
  }
  __syncthreads();  // the barriers' init
  const uint32_t row_bias = bias * static_cast<uint32_t>(rv) * 4u;
  uint32_t racc = 0;  // thread 0: the partial sum of a row that spans stages
  for (int s = 0; s < ns; ++s) {
    size_t off;
    int srows, svecs;
    stage(s, off, srows, svecs);
    const int row0 = r0 + (pieces == 1 ? s * R : s / pieces);
    mbar_wait(full + s % stages, (s / stages) & 1);
    const uint4* st = ring + static_cast<size_t>(s % stages) * slot_vecs;
    uint32_t* ws = wsum + (s & 1) * RING_WARPS;
    const int G = srows >= RING_WARPS ? 1 : RING_WARPS / srows;  // warps a row
    if (G == 1) {
      for (int j = warp; j < srows; j += RING_WARPS) {  // a whole row a warp
        uint32_t acc = 0;
        for (int v = lane; v < svecs; v += 32) acc += add4(st[j * svecs + v]);
        acc = warp_sum_u(acc);
        if (lane == 0) out[row0 + j] = __int2float_rn(static_cast<int>(acc + row_bias));
      }
    } else {  // row j by warps jG .. jG + G - 1, 512-byte chunks in turn
      const int j = warp / G, part = warp % G;
      uint32_t acc = 0;
      if (j < srows)
        for (int v = part * 32 + lane; v < svecs; v += G * 32) acc += add4(st[j * svecs + v]);
      acc = warp_sum_u(acc);
      if (lane == 0) ws[warp] = acc;
    }
    __syncthreads();  // the slot is read, the warps' sums are written
    if (threadIdx.x == 0 && s + stages < ns) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reads before the copy's writes
      issue(s + stages);
    }
    if (G > 1 && static_cast<int>(threadIdx.x) < srows) {
      const int j = threadIdx.x;
      uint32_t tot = 0;
      for (int p = 0; p < G; ++p) tot += ws[j * G + p];
      if (pieces == 1) {
        out[row0 + j] = __int2float_rn(static_cast<int>(tot + row_bias));
      } else {
        racc += tot;
        if (s % pieces == pieces - 1) {
          out[row0] = __int2float_rn(static_cast<int>(racc + row_bias));
          racc = 0;
        }
      }
    }
  }
}


// (b) the persistent grid read by plain loads: warp w of a block walks the block's rows w, w + WARPS, ... as
// one stream, a ring of U 16-byte streaming loads a lane in flight across rows (row 1's structure).
template <int WARPS, int U>
__global__ void __launch_bounds__(WARPS * 32)
probe_ring_kernel(const uint4* __restrict__ qs, uint32_t bias, float* __restrict__ out, int rows, int rv) {
  const int base = rows / static_cast<int>(gridDim.x), extra = rows % static_cast<int>(gridDim.x);
  const int g = blockIdx.x;
  const int r0 = g * base + min(g, extra), n = base + (g < extra ? 1 : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= n) return;
  const int kb = (rv + 31) / 32;                    // slots a row
  const int T = ((n - 1 - warp) / WARPS + 1) * kb;  // slots of this warp's rows
  int lt = 0, lrow = r0 + warp, lk = 0;             // the load cursor, U slots ahead
  uint4 buf[U];
  auto fetch = [&](int u) {
    if (lt < T && lk * 32 + lane < rv) buf[u] = __ldcs(qs + static_cast<size_t>(lrow) * rv + lk * 32 + lane);
    ++lt;
    if (++lk == kb) {
      lk = 0;
      lrow += WARPS;
    }
  };
#pragma unroll
  for (int u = 0; u < U; ++u) fetch(u);
  uint32_t acc = 0;
  int row = r0 + warp, k = 0;
  for (int t = 0; t < T; t += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < T) {
        if (k * 32 + lane < rv) acc += add4(buf[u]);
        fetch(u);
        if (++k == kb) {
          acc = warp_sum_u(acc);
          if (lane == 0) out[row] = __int2float_rn(static_cast<int>(acc + bias * static_cast<uint32_t>(rv) * 4u));
          acc = 0;
          k = 0;
          row += WARPS;
        }
      }
    }
  }
}

// One bulk copy a block on the hardware's grid: block b reads its TILE bytes of whole rows (rows no wider)
// into shared memory, its W warps sum them.
template <int W, int TILE>
__global__ void __launch_bounds__(W * 32)
probe_tma_rows_kernel(const uint4* __restrict__ qs, uint32_t bias, float* __restrict__ out, int rows, int rv) {
  __shared__ __align__(128) uint4 tile[TILE / 16];
  __shared__ uint64_t bar;
  const int R = TILE / 16 / rv;
  const int row0 = blockIdx.x * R, n = min(R, rows - row0);
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar, n * rv * 16);
    bulk_load_evict_first(tile, qs + static_cast<size_t>(row0) * rv, n * rv * 16, &bar, evict_first_policy());
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n; j += W) {
    uint32_t acc = 0;
    for (int v = lane; v < rv; v += 32) acc += add4(tile[j * rv + v]);
    acc = warp_sum_u(acc);
    if (lane == 0) out[row0 + j] = __int2float_rn(static_cast<int>(acc + bias * static_cast<uint32_t>(rv) * 4u));
  }
}
"""

# loads without L1 allocation and with a 256-byte L2 prefetch, defined before the kernel
_LD_L2_256 = r"""
__device__ __forceinline__ uint4 ld_l2_256(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}"""

_PDL_LAUNCH = f"""  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(PROBE_WARPS * 32);
  cfg.stream = {_STREAM};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, stream_probe_kernel, {_ARGS});
"""
_LAUNCH_DEPENDENTS = '  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'
_WAIT = '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Design (c)'s launch, a persistent grid: ``blocks`` blocks of
    ``RING_WARPS`` (8) warps, block g on the contiguous rows ``block_rows(g)``
    (the blocks' rows differ by one at most); a ring of ``stages`` slots of
    ``stage_bytes`` in ``smem_bytes`` of shared memory a block (with a
    barrier a slot and the warps' sums twice).  A stage holds
    ``rows_per_stage`` whole rows (``pieces == 1``) or one of a row's
    ``pieces`` pieces of at most ``piece_bytes`` (the last shorter).  Design
    (b) takes its grid (one 16-byte slot: no ring)."""

    out: int
    row_bytes: int
    blocks: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    rows_per_stage: int
    pieces: int
    piece_bytes: int

    def block_rows(self, g: int) -> range:
        base, extra = divmod(self.out, self.blocks)
        r0 = g * base + min(g, extra)
        return range(r0, r0 + base + (g < extra))

    def stage_spans(self, g: int) -> list:
        """(byte offset in qs, bytes) of block g's stages, in order."""
        rows = self.block_rows(g)
        if self.pieces == 1:
            return [(r * self.row_bytes, min(self.rows_per_stage, rows.stop - r) * self.row_bytes)
                    for r in range(rows.start, rows.stop, self.rows_per_stage)]
        return [(r * self.row_bytes + q * self.piece_bytes, min(self.piece_bytes, self.row_bytes - q * self.piece_bytes))
                for r in rows for q in range(self.pieces)]


RING_WARPS, RING_MAX_STAGES = 8, 16


@functools.lru_cache(maxsize=None)
def ring_plan(out: int, in_dim: int, sms: int = 132, *, stages: int = 4, stage_bytes: int = 16384,
              blocks_per_sm: int = 1) -> RingPlan:
    """Plan of design (c) on a card of ``sms`` SMs: at most
    ``blocks_per_sm`` blocks an SM, never more blocks than rows; rows no
    wider than a slot go whole, as many as fit, into a stage, a wider row
    into the fewest pieces that fit.  Raises where the ring does not fit a
    block's or an SM's shared memory (227 KB a block, 228 KB an SM)."""
    if out < 1 or in_dim < 32 or in_dim % 32:
        raise ValueError(f"ring_plan: out {out}, in dim {in_dim}: the in dim must be a multiple of 32")
    if not 1 <= stages <= RING_MAX_STAGES or stage_bytes < 16 or stage_bytes % 16 or blocks_per_sm < 1:
        raise ValueError(f"ring_plan: {stages} stages of {stage_bytes} bytes, {blocks_per_sm} blocks an SM")
    smem = stages * stage_bytes + stages * 8 + 2 * RING_WARPS * 4
    if smem > mv.SMEM_PER_BLOCK or blocks_per_sm * (smem + 1024) > mv.SMEM_PER_SM:
        raise ValueError(f"ring_plan: {smem} bytes of shared memory a block do not fit {blocks_per_sm} an SM")
    row_bytes = in_dim // 2
    pieces = -(-row_bytes // stage_bytes)
    piece_vecs = -(-(row_bytes // 16) // pieces)
    return RingPlan(out=out, row_bytes=row_bytes, blocks=min(out, blocks_per_sm * sms), stages=stages,
                    stage_bytes=stage_bytes, smem_bytes=smem,
                    rows_per_stage=stage_bytes // row_bytes if pieces == 1 else 1, pieces=pieces,
                    piece_bytes=16 * piece_vecs)


def _plan_grid(warps: int = mv.PROBE_WARPS):
    """The kernel's grid (``probe_plan``), or that of a variant built with
    ``warps`` warps a block: a block per ``warps`` rows."""
    return lambda out, in_dim, sms: mv.probe_plan(out, in_dim).blocks if warps == mv.PROBE_WARPS else -(-out // warps)


def _ring_grid(**kw):
    return lambda out, in_dim, sms: ring_plan(out, in_dim, sms, **kw).blocks


def _insert(launch: str, grid) -> tuple:
    """A variant on one of ``_KERNELS``: ``launch`` in place of the probe's."""
    return ([(_INCLUDE, _INCLUDE + '\n#include "async_copy.cuh"\n'), (_END, _KERNELS + _END),
             (_GRID, "blocks < 1 || blocks > rows"), (_LAUNCH, launch)], grid)


def _tma_ring(stages: int, kib: int, per_sm: int = 1, evict_first: bool = True) -> tuple:
    ef = str(evict_first).lower()
    launch = (f"  const size_t smem = ring_smem_bytes({stages}, {kib * 1024});\n"
              "  if (smem > 48 * 1024)\n"
              f"    cudaFuncSetAttribute(probe_tma_ring_kernel<{ef}>, cudaFuncAttributeMaxDynamicSharedMemorySize, "
              "static_cast<int>(smem));\n"
              f"  probe_tma_ring_kernel<{ef}><<<blocks, RING_WARPS * 32, smem, {_STREAM}>>>({_ARGS}, {stages}, "
              f"{kib * 1024});\n")
    return _insert(launch, _ring_grid(stages=stages, stage_bytes=kib * 1024, blocks_per_sm=per_sm))


def _ring(warps: int, u: int, per_sm: int) -> tuple:
    launch = f"  probe_ring_kernel<{warps}, {u}><<<blocks, {warps * 32}, 0, {_STREAM}>>>({_ARGS});\n"
    return _insert(launch, _ring_grid(stages=1, stage_bytes=16, blocks_per_sm=per_sm))


def _tma_rows(warps: int, kib: int) -> tuple:
    r = f"({kib * 1024} / (in_dim / 2))"
    launch = (f"  probe_tma_rows_kernel<{warps}, {kib * 1024}><<<(rows + {r} - 1) / {r}, {warps * 32}, 0, "
              f"{_STREAM}>>>({_ARGS});\n")
    variant = _insert(launch, _plan_grid())
    return [r for r in variant[0] if r[0] != _GRID], variant[1]


#: name -> ([(text of csrc/stream_probe.cu, its replacement)], grid(out, in_dim, sms) -> blocks)
VARIANTS = {
    # the kernel with other constants, the warp sum by shuffles, other loads
    **{f"warps{w}": ([(_WARPS, f"constexpr int PROBE_WARPS = {w};")], _plan_grid(warps=w)) for w in (4, 16, 32)},
    **{f"loads{u}": ([(_LOADS, f"constexpr int PROBE_LOADS = {u};")], _plan_grid()) for u in (2, 8)},
    "shuffles": ([(_SUM, "  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);\n")],
                 _plan_grid()),
    "l2_256": ([(_LOADS, _LOADS + _LD_L2_256), (_LOAD, "ld_l2_256(p + k0 + u * 32)")], _plan_grid()),
    # (c) the persistent grid of bulk copies (8 stages of 32 KB exceed a block's 227 KB: refused by its plan)
    **{f"tma_ring_s{st}_{kib}k": _tma_ring(st, kib) for st in (2, 4, 8) for kib in (8, 16, 32)},
    **{f"tma_ring_s{st}_{kib}k_x2": _tma_ring(st, kib, 2) for st, kib in ((2, 16), (2, 32), (4, 16), (8, 8))},
    "tma_ring_s4_16k_no_hint": _tma_ring(4, 16, evict_first=False),
    # (b) the persistent grid of plain loads: w warps a block, u loads a lane, x blocks an SM
    **{f"ring_w{w}_u{u}_x{x}": _ring(w, u, x) for w, u, x in ((32, 4, 1), (32, 8, 1), (16, 8, 2), (8, 4, 8))},
    # one bulk copy a block of 2 or 4 warps, on the hardware's grid
    **{f"tma_rows_w{w}_{kib}k": _tma_rows(w, kib) for w, kib in ((2, 8), (4, 16))},
    # programmatic dependent launch: the outputs wait for the previous launch; or every read does
    "pdl": ([(_LANE, _LAUNCH_DEPENDENTS + _LANE), (_SUM, _WAIT + _SUM), (_LAUNCH, _PDL_LAUNCH)], _plan_grid()),
    "pdl_wait_first": ([(_LANE, _LAUNCH_DEPENDENTS + _WAIT + _LANE), (_LAUNCH, _PDL_LAUNCH)], _plan_grid()),
    # the fixed-part split: the grid alone, and the grid writing its outputs
    "empty": ([(_LANE, "  if (rows > 0) return;\n" + _LANE)], _plan_grid()),
    "write_only": ([(_GUARD, _GUARD + "  if (lane == 0) out[row] = __int2float_rn(static_cast<int>(bias));\n"
                             "  if (rows > 0) return;\n")], _plan_grid()),
}

#: the parent tree's C entry (no block count)
_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def launcher(lib, qs: torch.Tensor, out: torch.Tensor, blocks: int | None):
    """``run(i)``: one launch of ``lib``'s entry on copy ``i % len(qs)`` of
    ``qs`` [n, rows, in/2] on ``blocks`` blocks (None: the parent's entry,
    which takes none), every row's sum into ``out``, bias ``i``."""
    rows, in_dim = qs.shape[1], qs.shape[2] * 2

    def run(i):
        stream = torch.cuda.current_stream().cuda_stream
        grid = () if blocks is None else (blocks,)
        build.check(lib.stream_probe(qs[i % len(qs)].data_ptr(), i, out.data_ptr(), rows, in_dim, *grid, stream),
                    "stream_probe variant")

    return run


def fixed_split(shapes: dict) -> dict:
    """{shape: µs of the gap, ramp, first byte and streaming} from
    {shape: {"bytes", "empty", "write_only", "probe"}} (µs a launch behind a
    sleep kernel): the gap is the empty grid's time a launch, the ramp what
    writing the outputs adds, the streaming the nibble bytes at the
    marginal rate (the slope of the probe's time over the bytes, least
    squares across the shapes), and the first byte what is left."""
    xs = [s["bytes"] for s in shapes.values()]
    ys = [s["probe"] for s in shapes.values()]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    var = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var if var else 0.0  # µs a byte
    out = {}
    for name, s in shapes.items():
        streaming = s["bytes"] * slope
        out[name] = {"gap_us": s["empty"], "ramp_us": s["write_only"] - s["empty"],
                     "first_byte_us": s["probe"] - s["write_only"] - streaming, "streaming_us": streaming,
                     "probe_us": s["probe"], "marginal_gbps": 1e-3 / slope if slope else None,
                     "intercept_us": my - slope * mx}
    return out


def _build(names) -> dict:
    """The variants' libraries, all built together; where one fails, each
    alone, a line for each that fails (its compiler output) and no library."""
    try:
        return build_variants(names, "stream_probe", VARIANTS)
    except RuntimeError:
        libs = {}
        for name in names:
            try:
                libs.update(build_variants([name], "stream_probe", VARIANTS))
            except RuntimeError as e:
                print(json.dumps({"variant": name, "build_failed": str(e)[-3000:]}), flush=True)
        return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(kb.SHAPES))
    ap.add_argument("--parent", default=None, help="an older tree's csrc directory, built as the variant 'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_variants: needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = [n for n in args.variants.split(",") if n]
    names += [n for n in ("empty", "write_only") if n not in names]  # the split's kernels
    libs = {}
    if args.parent:
        libs.update(build_variants(["parent"], "stream_probe", {"parent": ([], None)}, csrc_dir=args.parent))
        libs["parent"].stream_probe.argtypes = _PARENT_ARGS
    libs["current"] = build.lib("stream_probe")
    libs.update(_build(names))
    order = list(libs) + list(reversed(libs))
    names = [n for n in names if n in libs]
    g = torch.Generator(device=dev).manual_seed(17)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms, "variants": list(libs)}), flush=True)
    split_in = {}
    for shape in args.shapes.split(","):
        out, in_dim = kb.SHAPES[shape]
        nib = out * in_dim // 2
        n = max(2, math.ceil(kb.SWEEP_BYTES / nib))
        qs = torch.randint(0, 256, (n, out, in_dim // 2), dtype=torch.uint8, device=dev, generator=g)
        ref = mv.stream_probe_plain(qs[0], 0, all_rows=True)
        y = torch.empty(out, dtype=torch.float32, device=dev)
        times = {}
        for name in order:
            try:
                blocks = None if name == "parent" else (VARIANTS[name][1] if name in VARIANTS else _plan_grid())(
                    out, in_dim, sms)
            except ValueError as e:  # the ring does not fit
                if name not in times:
                    print(json.dumps({"variant": name, "shape": shape, "skipped": str(e)}), flush=True)
                times[name] = None
                continue
            run = launcher(libs[name], qs, y, blocks)
            y.fill_(float("nan"))
            run(0)
            torch.cuda.synchronize()
            exact = bool(torch.equal(y, ref))
            us = kb.time_ms(run, args.iters, dev) * 1e3
            times.setdefault(name, []).append(us)
            print(json.dumps({"variant": name, "shape": shape, "out": out, "in": in_dim, "blocks": blocks, "us": us,
                              "gbps": nib / us / 1e3, "bits_equal_plain": exact}), flush=True)
        split_in[shape] = {"bytes": nib, **{k: min(times[k]) for k in ("empty", "write_only")},
                           "probe": min(times["current"])}
        del qs
        torch.cuda.empty_cache()
    for shape, parts in fixed_split(split_in).items():
        print(json.dumps({"fixed_split": shape, **parts}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
