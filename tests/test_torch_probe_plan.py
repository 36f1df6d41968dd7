"""The stream probe's launch plan (``ops/q4_matvec.probe_plan``), the order
invariance that lets a kernel split a row anywhere, and the probe's variant
tool (``tools/probe_variants.py``) with the plan of the persistent design
it was chosen against (``ring_plan``), on the CPU: no ``nvcc``, no card,
no JAX kernel.

* ``probe_plan`` covers every row exactly once in contiguous spans of
  ``PROBE_WARPS`` rows a block, no more blocks than rows, at kernelbench's
  five shapes and at small, ragged and wide rows.
* ``ring_plan`` (design (c): a persistent grid of bulk copies) covers
  every row exactly once in contiguous spans, the blocks' rows differ by
  one at most, no more blocks than rows or than 132 × the blocks an SM,
  every stage is a 16-byte multiple of at most a slot; its ring fits a
  block's and an SM's shared memory (227 KB, 228 KB), or the plan raises.
* A CPU mirror of that design's sums (each stage's rows or a row's pieces,
  then the bias times a row's words) equals the plain version bit for
  bit, and (hypothesis) the plain version's bits do not change under any
  permutation of a row's words or any split of a row into parts whose
  wrapped sums are added: why no kernel of the probe needs a mirror of its
  order.
* Each variant's replaced text occurs once in the source, its grid is a
  plan's; the fixed-part split's arithmetic.

The kernel and the variants are held against the plain version on the card
by tests/test_torch_cuda.py, chip_smoke.py and the tool itself.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llama_swift_torch.ops import build
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.tools import kernelbench as kb
from llama_swift_torch.tools import matvec_variants as mvv
from llama_swift_torch.tools import probe_variants as pv

SOURCE = os.path.join(build.CSRC_DIR, "stream_probe.cu")

#: kernelbench's five shapes, then small, ragged and wide rows (the last two wider than a 16 KB slot)
SHAPES = [*kb.SHAPES.values(), (128, 32), (384, 352), (128, 11008), (256, 65536), (4352, 4096), (128, 40000)]


def _check_ring_plan(p: pv.RingPlan, out: int, in_dim: int, sms: int, per_sm: int) -> None:
    assert p.row_bytes == in_dim // 2
    assert 1 <= p.blocks <= min(out, sms * per_sm)
    spans = [p.block_rows(g) for g in range(p.blocks)]
    assert [r for s in spans for r in s] == list(range(out))  # every row once, block after block
    sizes = [len(s) for s in spans]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert p.stage_bytes % 16 == 0 and 1 <= p.stages <= pv.RING_MAX_STAGES
    assert p.smem_bytes == p.stages * p.stage_bytes + 8 * p.stages + 8 * pv.RING_WARPS
    assert p.smem_bytes <= mv.SMEM_PER_BLOCK and per_sm * (p.smem_bytes + 1024) <= mv.SMEM_PER_SM
    for g, rows in enumerate(spans):
        stages = p.stage_spans(g)
        at = rows.start * p.row_bytes
        for off, nbytes in stages:  # one contiguous byte span, stage after stage
            assert off == at and off % 16 == 0 and nbytes % 16 == 0 and 0 < nbytes <= p.stage_bytes
            at += nbytes
        assert at == rows.stop * p.row_bytes
        if p.pieces == 1:
            assert p.rows_per_stage * p.row_bytes <= p.stage_bytes < (p.rows_per_stage + 1) * p.row_bytes
        else:  # a row wider than a slot: the fewest pieces, which differ by 16 bytes at most
            assert p.row_bytes > p.stage_bytes and p.rows_per_stage == 1
            assert p.pieces == -(-p.row_bytes // p.stage_bytes)
            pieces = [n for _, n in stages[: p.pieces]]
            assert max(pieces) - min(pieces) <= 16


@pytest.mark.parametrize("out,in_dim", SHAPES)
def test_probe_plan_covers_every_row_once(out, in_dim):
    """The kernel's grid: block g on rows g·PROBE_WARPS + w, every row
    once, block after block, all blocks full (the wrapper takes out % 128
    == 0), no more blocks than rows."""
    p = mv.probe_plan(out, in_dim)
    assert p.row_bytes == in_dim // 2 and p.warps == mv.PROBE_WARPS and p.loads == mv.PROBE_LOADS
    spans = [p.block_rows(g) for g in range(p.blocks)]
    assert [r for s in spans for r in s] == list(range(out))
    assert {len(s) for s in spans} == {p.warps} and p.blocks <= out


@pytest.mark.parametrize("out,in_dim", SHAPES)
@pytest.mark.parametrize("ring", [{}, dict(stages=2, stage_bytes=8192, blocks_per_sm=2), dict(stages=8)])
def test_ring_plan_covers_every_row_once(out, in_dim, ring):
    p = pv.ring_plan(out, in_dim, **ring)
    _check_ring_plan(p, out, in_dim, 132, ring.get("blocks_per_sm", 1))


@pytest.mark.parametrize("sms", [1, 7, 114, 132])
def test_ring_plan_at_other_sm_counts(sms):
    for out, in_dim in SHAPES:
        _check_ring_plan(pv.ring_plan(out, in_dim, sms), out, in_dim, sms, 1)


def test_ring_plan_puts_a_4096_squared_share_in_flight_at_once():
    """At 4096² a block's whole share is in the first copies thread 0
    issues; at the widest 7B shapes the ring refills."""
    p = pv.ring_plan(4096, 4096)
    assert p.blocks == 132 and max(len(p.stage_spans(g)) for g in range(p.blocks)) <= p.stages
    assert len(pv.ring_plan(32000, 4096).stage_spans(0)) > p.stages


def test_plan_refusals():
    for plan in (mv.probe_plan, pv.ring_plan):
        with pytest.raises(ValueError):
            plan(128, 48)  # in % 32
        with pytest.raises(ValueError):
            plan(0, 4096)
    with pytest.raises(ValueError):
        pv.ring_plan(4096, 4096, stages=8, stage_bytes=32768)  # 256 KB: above a block's 227 KB
    with pytest.raises(ValueError):
        pv.ring_plan(4096, 4096, stages=4, stage_bytes=32768, blocks_per_sm=2)  # two do not fit an SM
    with pytest.raises(ValueError):
        pv.ring_plan(4096, 4096, stage_bytes=1000)  # not a multiple of 16
    with pytest.raises(ValueError):
        pv.ring_plan(4096, 4096, stages=pv.RING_MAX_STAGES + 1, stage_bytes=1024)


def _ring_mirror(qs: torch.Tensor, bias: int, plan: pv.RingPlan) -> torch.Tensor:
    """Design (c)'s sums on the CPU, stage by stage as the plan cuts each
    block's span: a stage's whole rows, or a row's piece added to the sum
    the row carries across stages; the bias times the row's words last;
    unsigned 32-bit throughout."""
    words = qs.contiguous().view(torch.int32).numpy().view(np.uint32).reshape(-1)
    out = np.full(plan.out, np.nan, np.float32)
    rwords = plan.row_bytes // 4
    with np.errstate(over="ignore"):
        for g in range(plan.blocks):
            acc = {}
            for off, nbytes in plan.stage_spans(g):
                w0, nw = off // 4, nbytes // 4
                rows = 1 if plan.pieces > 1 else nw // rwords
                for j in range(rows):
                    part = words[w0 + j * (nw // rows): w0 + (j + 1) * (nw // rows)].sum(dtype=np.uint32)
                    row = w0 // rwords + j
                    acc[row] = np.uint32(acc.get(row, np.uint32(0)) + part)
            for row, s in acc.items():
                out[row] = np.uint32(s + np.uint32(bias & 0xFFFFFFFF) * np.uint32(rwords)).view(np.int32)
    return torch.from_numpy(out)


@pytest.mark.parametrize("out,in_dim,ring", [
    (128, 32, {}), (384, 352, {}), (256, 4096, dict(stage_bytes=1024)), (128, 11008, dict(stages=2, stage_bytes=2048)),
    (256, 65536, {}), (300, 1024, dict(stage_bytes=1536)),
])
@pytest.mark.parametrize("bias", [0, -7, 2**31 - 1])
def test_ring_sum_order_mirror_equals_plain(out, in_dim, ring, bias):
    """Design (c)'s split of rows over blocks, stages and pieces, mirrored
    on the CPU at few SMs (so blocks hold many rows), gives the plain
    version's bits, the bias folded in as bias times the words."""
    rng = np.random.default_rng(out + in_dim)
    qs = torch.from_numpy(rng.integers(0, 256, size=(out, in_dim // 2), dtype=np.uint8))
    plan = pv.ring_plan(out, in_dim, 5, **ring)
    assert torch.equal(_ring_mirror(qs, bias, plan), mv.stream_probe_plain(qs, bias, all_rows=True))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), vecs=st.integers(1, 48), bias=st.integers(-(2**31), 2**31 - 1),
       cuts=st.lists(st.integers(0, 192), max_size=6))
def test_plain_bits_do_not_depend_on_the_order_of_a_row(seed, vecs, bias, cuts):
    """Permuting a row's words, or adding the wrapped sums of any split of
    the row, gives the plain version's bits: the kernel may split a row
    over lanes, warps, stages and blocks as it likes."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-(2**31), 2**31, size=(4, vecs * 4), dtype=np.int64).astype(np.int32)
    ref = mv.stream_probe_plain(torch.from_numpy(words.view(np.uint8)), bias, all_rows=True)
    perm = np.stack([rng.permutation(r) for r in words])
    assert torch.equal(mv.stream_probe_plain(torch.from_numpy(perm.view(np.uint8)), bias, all_rows=True), ref)
    bounds = sorted({0, vecs * 4, *[c for c in cuts if c < vecs * 4]})
    u = words.view(np.uint32)
    b = np.uint32(bias & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        parts = [(u[:, lo:hi] + b).sum(axis=1, dtype=np.uint32) for lo, hi in zip(bounds, bounds[1:])]
        tot = np.sum(parts, axis=0, dtype=np.uint32)
        folded = u.sum(axis=1, dtype=np.uint32) + b * np.uint32(vecs * 4)  # the kernel's bias, added last
    assert torch.equal(torch.from_numpy(tot.view(np.int32).astype(np.float32)), ref)
    assert torch.equal(torch.from_numpy(folded.view(np.int32).astype(np.float32)), ref)


def test_wrapper_on_cpu_takes_the_plain_version_and_keeps_its_checks():
    qs = torch.randint(0, 256, (256, 64), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    before = mv.stream_probe.launches
    assert torch.equal(mv.stream_probe(qs, 3), mv.stream_probe_plain(qs, 3))
    assert torch.equal(mv.stream_probe(qs, 3, all_rows=True), mv.stream_probe_plain(qs, 3, all_rows=True))
    assert mv.stream_probe.launches == before  # the plain version counts no launch
    for bad in (qs[:200], qs[:, :56], qs.to(torch.int8), qs[None]):
        with pytest.raises(ValueError):
            mv.stream_probe(bad, 0)


@pytest.mark.parametrize("name", sorted(pv.VARIANTS))
def test_probe_variant_source_differs_only_by_its_replacements(name):
    with open(SOURCE) as f:
        src = f.read()
    for old, _ in pv.VARIANTS[name][0]:
        assert src.count(old) == 1, (name, old)
    out = mvv.variant_source(name, source="stream_probe", variants=pv.VARIANTS)
    for old, new in pv.VARIANTS[name][0]:
        src = src.replace(old, new)
    assert out == src and out != open(SOURCE).read()


@pytest.mark.parametrize("name", sorted(pv.VARIANTS))
def test_probe_variant_grids(name):
    """A variant's grid at kernelbench's shapes: the adopted grid's block
    count (or that of its warps), or design (c)'s plan, which refuses 8
    stages of 32 KB (above a block's 227 KB)."""
    grid = pv.VARIANTS[name][1]
    for out, in_dim in kb.SHAPES.values():
        if name == "tma_ring_s8_32k":
            with pytest.raises(ValueError):
                grid(out, in_dim, 132)
            continue
        blocks = grid(out, in_dim, 132)
        assert 1 <= blocks <= out
        if name.startswith(("tma_ring", "ring_")):
            assert blocks == min(out, 132 * (2 if name.endswith("_x2") else int(name.rsplit("_x", 1)[-1])
                                              if name.startswith("ring_") else 1))
        else:
            assert blocks == -(-out // (int(name[5:]) if name.startswith("warps") else mv.PROBE_WARPS))


def test_probe_constants_match_the_source():
    with open(SOURCE) as f:
        src = f.read()
    assert f"constexpr int PROBE_WARPS = {mv.PROBE_WARPS};" in src
    assert f"constexpr int PROBE_LOADS = {mv.PROBE_LOADS};" in src
    assert f"constexpr int RING_WARPS = {pv.RING_WARPS};" in pv._KERNELS


def test_fixed_split_adds_up():
    """gap + ramp + first byte + streaming is the probe's time; the
    streaming is the bytes at the fitted marginal rate."""
    rate = 3.2e6  # bytes a µs
    shapes = {name: {"bytes": b, "empty": 1.5, "write_only": 2.25, "probe": 3.0 + b / rate}
              for name, b in [("a", 8e6), ("b", 2.5e7), ("c", 6.5e7)]}
    split = pv.fixed_split(shapes)
    for name, s in split.items():
        parts = s["gap_us"] + s["ramp_us"] + s["first_byte_us"] + s["streaming_us"]
        assert parts == pytest.approx(shapes[name]["probe"])
        assert s["marginal_gbps"] == pytest.approx(rate / 1e3)
        assert s["first_byte_us"] == pytest.approx(0.75)
        assert s["intercept_us"] == pytest.approx(3.0)
