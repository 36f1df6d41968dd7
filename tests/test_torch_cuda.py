"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes (row counts that are not a multiple of a block's rows,
in-dims that are not a multiple of a warp's blocks, several head dims).

These tests need a CUDA device and skip without one: a CUDA kernel has no
CPU mode.  They import nothing of JAX, so on a machine with a card they run
as ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
chip_smoke.py holds the same kernels at 7B shapes.
"""

import math

import pytest
import torch

from llama_swift_torch import ops
from llama_swift_torch.ops import attention as att
from llama_swift_torch.ops import q4_dequant as dq
from llama_swift_torch.ops import q4_matvec as mv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _q4(out, in_dim, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    qs = torch.randint(0, 256, (out, in_dim // 2), dtype=torch.uint8, device=device, generator=g)
    d = torch.rand((out, in_dim // 32), device=device, generator=g) / math.sqrt(in_dim)
    return mv.Q4_0Weight(qs, d), g


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("out,in_dim", [(8, 32), (1000, 352), (256, 4096), (77, 11008)])
def test_matvec_kernel_matches_plain(cuda, out, in_dim):
    w, g = _q4(out, in_dim, cuda)
    x = torch.randn(in_dim, device=cuda, generator=g)
    before = mv.q4_0_matvec.launches
    y = mv.q4_0_matvec(x, w)
    torch.cuda.synchronize()
    assert mv.q4_0_matvec.launches == before + 1
    assert _rel(y, mv.q4_0_matvec_plain(x, w)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n_past", [0, 63, 64, 200])
def test_flash_kernel_matches_plain(cuda, dtype, dh, n_past):
    g = torch.Generator(device=cuda).manual_seed(n_past)
    L, H, n_ctx = 3, 4, 256
    kc = torch.randn((L, H, n_ctx, dh), device=cuda, generator=g).to(dtype)
    vc = torch.randn((L, H, n_ctx, dh), device=cuda, generator=g).to(dtype)
    kc[1, :, n_past + 1 :] = 1e4  # stale slots beyond n_past
    q = torch.randn((H, dh), device=cuda, generator=g)
    out = att.flash_decode_attention(q, kc, vc, 1, n_past)
    assert _rel(out, att.flash_decode_attention_plain(q, kc, vc, 1, n_past)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_kernel_bit_exact(cuda, dtype):
    w, _ = _q4(300, 4096, cuda)
    assert torch.equal(dq.q4_0_dequant(w, dtype), dq.dequantize_q4_0(w, dtype))


def test_wrappers_raise_on_bad_inputs(cuda):
    w, g = _q4(64, 256, cuda)
    with pytest.raises(ValueError):
        mv.q4_0_matvec(torch.randn(128, device=cuda), w)  # wrong in dim
    with pytest.raises(ValueError):
        mv.q4_0_matvec(torch.randn(256, device=cuda, dtype=torch.float16), w)
    kc = torch.zeros((1, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        att.flash_decode_attention(torch.zeros((2, 128), device=cuda), kc, kc, 0, 16)  # n_past >= n_ctx
    with pytest.raises(ValueError):
        dq.q4_0_dequant(w, torch.float16)


def test_counters_reset(cuda):
    w, g = _q4(64, 256, cuda)
    ops.reset_launch_counts()
    mv.q4_0_matvec(torch.randn(256, device=cuda, generator=g), w)
    assert ops.launch_counts() == {"q4_0_matvec": 1, "flash_decode_attention": 0, "q4_0_dequant": 0}
