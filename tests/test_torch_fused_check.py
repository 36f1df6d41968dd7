"""``llama_swift_torch/utils/fused_check.py``, the bar that holds the
whole-stack kernel to its plain version, on the CPU at 2 layers, 2 heads,
n_ff 768: the plain version passes against itself; a "kernel" that flips
one code at a rounding boundary (the plain version with one attention-norm
weight moved by 2e-4 of a step across it) passes through the forced run,
and the same move by 0.2 of a step fails; a wrong x, a written stale row and
a run that does not repeat fail; the bf16 K/V rule and the forced run's
catch of a wrong quantizer input."""

import math

import pytest
import torch

from llama_swift_torch.ops import fused_layer as fl
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.ops.norms import norm
from llama_swift_torch.utils import fused_check as fc

L, H, F, N_CTX, N_PAST = 2, 2, 768, 64, 20
D = H * fl.HEAD_DIM


def _inputs(dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    ws = []
    for out, in_dim in [(3 * D, D), (D, D), (2 * F, D), (D, F)]:
        qs = torch.randint(0, 256, (L, out, in_dim // 2), dtype=torch.uint8, generator=g)
        ws.append(mv.Q4_0Weight(qs, torch.rand((L, out, in_dim // 32), generator=g) / math.sqrt(in_dim)))
    norms = tuple(1.0 + 0.05 * torch.randn((L, D), generator=g) for _ in range(2))
    x = torch.randn(D, generator=g)
    kc = torch.randn((L, H, N_CTX, fl.HEAD_DIM), generator=g).to(dtype)
    vc = torch.randn((L, H, N_CTX, fl.HEAD_DIM), generator=g).to(dtype)
    kc[:, :, N_PAST:] = 1e4  # stale rows: N_PAST is written first, beyond it never read
    vc[:, :, N_PAST:] = -1e4
    return x, norms, ws, kc, vc


def _across_boundary(x, an, steps):
    """(element i, attention norms of the plain, of the "kernel"): layer 0's
    normed value at i (not its 32-block's largest) put ``steps`` of a
    quantization step below, resp. above, the rounding boundary over it."""
    h = norm(x.float(), an[0], "layernorm", 1e-5)
    blk = h[:32].abs()
    d = blk.max() / torch.full_like(blk.max(), 7.0)
    i = int(((h[:32] / d).abs() - 3.2).abs().argmin())  # a value about 3 steps from 0, far below the largest
    b = math.floor(float(h[i] / d)) + 0.5
    out = []
    for s in (-steps, steps):
        a = an.clone()
        a[0, i] = an[0, i] * float((b + s) * d / h[i])
        out.append(a)
    return i, out[0], out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_against_itself_passes(dtype):
    x, norms, ws, kc, vc = _inputs(dtype)
    rec = fc.fused_case(x, norms, ws, kc, vc, N_PAST)
    assert rec["ok"] and rec["q4_flips"] == 0 and rec["max_rel_err"] == 0.0
    assert rec["repeats_bit_for_bit"] and rec["stale_rows_kept"] and "forced" not in rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flip_at_a_boundary_passes_through_the_forced_run(dtype):
    x, (an, fn), ws, kc, vc = _inputs(dtype)
    i, an_plain, an_kernel = _across_boundary(x, an, 1e-4)

    def kernel(x, an_, fn_, *rest, trace=None):
        return fl.fused_layers_block_plain(x, an_kernel, fn_, *rest, trace=trace)

    rec = fc.fused_case(x, (an_plain, fn), ws, kc, vc, N_PAST, kernel=kernel)
    ff = rec["first_flip"]
    assert (ff["layer"], ff["segment"], ff["index"]) == (0, "h", i)
    assert ff["gap"] <= fc.FLIP_GAP and ff["at_boundary"]
    assert ff["plain_steps"] < ff["boundary"] < ff["card_steps"]
    assert rec["q4_flips"] >= 1 and rec["forced"]["ok"] and rec["ok"]


def test_flip_far_from_a_boundary_fails():
    x, (an, fn), ws, kc, vc = _inputs(torch.float32)
    _, an_plain, an_kernel = _across_boundary(x, an, 0.1)

    def kernel(x, an_, fn_, *rest, trace=None):
        return fl.fused_layers_block_plain(x, an_kernel, fn_, *rest, trace=trace)

    rec = fc.fused_case(x, (an_plain, fn), ws, kc, vc, N_PAST, kernel=kernel)
    assert rec["q4_flips"] >= 1 and rec["first_flip"]["gap"] > fc.FLIP_GAP
    assert not rec["first_flip"]["at_boundary"] and not rec["ok"]


def test_wrong_x_fails():
    x, norms, ws, kc, vc = _inputs(torch.float32)

    def kernel(*args, trace=None):
        return fl.fused_layers_block_plain(*args, trace=trace) * 1.01

    rec = fc.fused_case(x, norms, ws, kc, vc, N_PAST, kernel=kernel)
    assert rec["q4_flips"] == 0 and rec["max_rel_err"] > fc.X_BAR and not rec["ok"]


def test_written_stale_row_fails():
    x, norms, ws, kc, vc = _inputs(torch.float32)

    def kernel(*args, trace=None):
        args[7][:, :, N_PAST + 1] = 0.0  # the K cache beyond n_past
        return fl.fused_layers_block_plain(*args, trace=trace)

    rec = fc.fused_case(x, norms, ws, kc, vc, N_PAST, kernel=kernel)
    assert not rec["stale_rows_kept"] and not rec["ok"]


def test_unrepeatable_run_fails():
    x, norms, ws, kc, vc = _inputs(torch.float32)
    calls = []

    def kernel(*args, trace=None):
        calls.append(1)
        return fl.fused_layers_block_plain(*args, trace=trace) + 1e-7 * len(calls)

    rec = fc.fused_case(x, norms, ws, kc, vc, N_PAST, kernel=kernel)
    assert not rec["repeats_bit_for_bit"] and not rec["ok"]


def test_kv_rows_bf16_step_with_its_floor():
    b = torch.tensor([4.0, -2.0, 3.3e-6, 1.0]).to(torch.bfloat16)
    one_step = b.float() + torch.tensor([4.0 * 2.0**-7, 0.0, 0.0, 0.0])
    assert fc.kv_rows_ok([(one_step.to(torch.bfloat16), b)])[0]
    noise = b.float() + torch.tensor([0.0, 0.0, 4.5e-8, 0.0])  # below 2^-13 of the row's max: its floor
    assert fc.kv_rows_ok([(noise.to(torch.bfloat16), b)])[0]
    two_steps = b.float() + torch.tensor([0.0, 0.0, 0.0, 2.0**-5])
    ok, worst = fc.kv_rows_ok([(b, b), (two_steps.to(torch.bfloat16), b)])
    assert not ok and (worst["kv"], worst["index"]) == ("v", 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forced_run_agrees_on_a_true_trace_and_catches_a_wrong_gate(dtype):
    x, norms, ws, kc, vc = _inputs(dtype)
    tr = []
    out = fl.fused_layers_block_plain(x, *norms, *ws, kc, vc, N_PAST, trace=tr)
    rec = fc.forced_check(x, norms, ws, kc, vc, N_PAST, tr[0], out)
    assert rec["ok"] and max(rec["inputs_rel_err"].values()) == 0.0 and rec["x_rel_err"] == 0.0
    bad = tr[0].clone()
    bad[1, 3 * D:] *= 1.01  # layer 1's gate
    rec = fc.forced_check(x, norms, ws, kc, vc, N_PAST, bad, out)
    assert not rec["ok"] and rec["inputs_rel_err"]["gate"] > fc.X_BAR
