"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes (row counts that are not a multiple of a block's rows,
in-dims that are not a multiple of a warp's blocks, several head dims,
multi-row counts on both sides of the kernel's row templates, per-slot
n_pasts on both sides of a 64-key split, page sizes 16 and 128, int8 caches
with stale codes and scales beyond each n_past; Q4_1 weights; the T
layout's integer products on both sides of the 8-row MMA tiles and of the
64-row launch; the two-kernels-per-layer blocks at n_past on both sides of a
64-key split; batch-1 flash decode at the edges of its splits and at n_ctx
2048, LLaMA's context; calls repeated bit for bit, since the batch-1 kernel
combines through a cluster and the whole-stack kernel through arrival
counters).

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
    with pytest.raises(ValueError):
        mv.q4_0_matmul_multi(torch.randn((33, 256), device=cuda), w)  # more rows than the kernel takes
    q = torch.zeros((2, 2, 128), device=cuda)
    kb = torch.zeros((1, 2, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        att.flash_decode_attention_batched(q, kb, kb, 0, torch.zeros(2, dtype=torch.int64, device=cuda), 3)
    pool = torch.zeros((3, 1, 2, 16, 128), device=cuda)
    table = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # max_n_past beyond the table's pages
        att.flash_decode_attention_paged(q, pool, pool, table, 0, torch.zeros(2, dtype=torch.int32, device=cuda), 16)


def test_counters_reset(cuda):
    w, g = _q4(64, 256, cuda)
    ops.reset_launch_counts()
    mv.q4_0_matvec(torch.randn(256, device=cuda, generator=g), w)
    counts = ops.launch_counts()
    assert counts.pop("q4_0_matvec") == 1
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("B", [2, 5, 32])
@pytest.mark.parametrize("out,in_dim", [(77, 352), (1000, 4096), (300, 11008)])
def test_matmul_multi_kernel_matches_plain(cuda, B, out, in_dim):
    """Row counts on both sides of the kernel's row templates; out not a
    multiple of a block's 8 rows."""
    w, g = _q4(out, in_dim, cuda, seed=B)
    x = torch.randn((B, in_dim), device=cuda, generator=g)
    before = mv.q4_0_matmul_multi.launches
    y = mv.q4_0_matmul_multi(x, w)
    torch.cuda.synchronize()
    assert mv.q4_0_matmul_multi.launches == before + 1
    assert y.shape == (B, out)
    assert _rel(y, mv.q4_0_matmul_multi_plain(x, w)) <= 1e-5
    assert _rel(y[B - 1], mv.q4_0_matvec(x[B - 1].contiguous(), w)) <= 1e-5


def _batched_case(cuda, dtype, dh, n_pasts, n_ctx=256, L=2, H=4, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    B = len(n_pasts)
    kc = torch.randn((L, B, H, n_ctx, dh), device=cuda, generator=g)
    vc = torch.randn((L, B, H, n_ctx, dh), device=cuda, generator=g)
    for b, n in enumerate(n_pasts):  # stale data beyond each slot's n_past
        kc[:, b, :, n + 1 :] = 1e4
        vc[:, b, :, n + 1 :] = -1e4
    q = torch.randn((B, H, dh), device=cuda, generator=g)
    return q, kc.to(dtype), vc.to(dtype), torch.tensor(n_pasts, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n_pasts", [[0, 63], [64, 0, 255, 130, 63], [200] * 5 + [1, 2]])
def test_flash_batched_kernel_matches_plain(cuda, dtype, dh, n_pasts):
    q, kc, vc, np_ = _batched_case(cuda, dtype, dh, n_pasts)
    out = att.flash_decode_attention_batched(q, kc, vc, 1, np_, max(n_pasts))
    ref = att.flash_decode_attention_batched_plain(q, kc, vc, 1, np_, max(n_pasts))
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("n_pasts", [[0, 63, 64, 255], [127, 128, 5]])
def test_flash_paged_kernel_matches_plain_and_dense(cuda, dtype, page, n_pasts):
    """A shuffled page table with garbage (out-of-range ids) beyond each
    slot's live pages; the paged kernel equals the dense batched one."""
    q, kc, vc, np_ = _batched_case(cuda, dtype, 128, n_pasts, seed=page)
    L, B, H, n_ctx, dh = kc.shape
    mp = n_ctx // page
    live = [n // page + 1 for n in n_pasts]
    P = sum(live) + 1
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(page)).tolist()
    table = torch.full((B, mp), 10**6, dtype=torch.int32)
    kp = torch.zeros((P, L, H, page, dh), dtype=dtype, device=cuda)
    vp = torch.zeros_like(kp)
    for b in range(B):
        for c in range(live[b]):
            pid = ids.pop()
            table[b, c] = pid
            kp[pid] = kc[:, b, :, c * page : (c + 1) * page]
            vp[pid] = vc[:, b, :, c * page : (c + 1) * page]
    table = table.to(cuda)
    for il in range(L):
        out = att.flash_decode_attention_paged(q, kp, vp, table, il, np_, max(n_pasts))
        ref = att.flash_decode_attention_paged_plain(q, kp, vp, table, il, np_, max(n_pasts))
        dense = att.flash_decode_attention_batched(q, kc, vc, il, np_, max(n_pasts))
        torch.cuda.synchronize()
        assert _rel(out, ref) <= 1e-5
        assert _rel(out, dense) <= 1e-5


def _int8(shape, cuda, seed):
    """Codes and row scales of a seeded f32 tensor, by the port's own write."""
    from llama_swift_torch.models.llama import quantize_kv

    g = torch.Generator(device=cuda).manual_seed(seed)
    return quantize_kv(torch.randn(shape, device=cuda, generator=g))


def _stale_int8(codes, scale, n):
    codes[..., n + 1 :, :] = 127  # stale codes and huge scales beyond n_past
    scale[..., n + 1 :, :] = 1e3


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n_past", [0, 63, 64, 200])
def test_flash_stacked_int8_kernel_matches_plain(cuda, dh, n_past):
    L, H, n_ctx = 3, 4, 256
    k8, ks = _int8((L, H, n_ctx, dh), cuda, n_past)
    v8, vs = _int8((L, H, n_ctx, dh), cuda, n_past + 1)
    _stale_int8(k8[1], ks[1], n_past)
    _stale_int8(v8[1], vs[1], n_past)
    q = torch.randn((H, dh), device=cuda, generator=torch.Generator(device=cuda).manual_seed(9))
    before = att.flash_decode_attention_stacked_int8.launches
    out = att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, 1, n_past)
    ref = att.flash_decode_attention_stacked_int8_plain(q, k8, v8, ks, vs, 1, n_past)
    torch.cuda.synchronize()
    assert att.flash_decode_attention_stacked_int8.launches == before + 1
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("n_pasts", [[0, 63], [64, 0, 255, 130, 63], [200] * 5 + [1, 2]])
def test_flash_batched_int8_kernel_matches_plain(cuda, dh, n_pasts):
    L, B, H, n_ctx = 2, len(n_pasts), 4, 256
    k8, ks = _int8((L, B, H, n_ctx, dh), cuda, B)
    v8, vs = _int8((L, B, H, n_ctx, dh), cuda, B + 1)
    for b, n in enumerate(n_pasts):
        _stale_int8(k8[:, b], ks[:, b], n)
        _stale_int8(v8[:, b], vs[:, b], n)
    q = torch.randn((B, H, dh), device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    out = att.flash_decode_attention_batched_int8(q, k8, v8, ks, vs, 1, np_, max(n_pasts))
    ref = att.flash_decode_attention_batched_int8_plain(q, k8, v8, ks, vs, 1, np_, max(n_pasts))
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("n_pasts", [[0, 63, 64, 255], [127, 128, 5]])
def test_flash_paged_int8_kernel_matches_plain_and_dense(cuda, page, n_pasts):
    """Scale pools under the same shuffled page ids as the code pools;
    garbage ids beyond each slot's live pages."""
    L, B, H, n_ctx, dh = 2, len(n_pasts), 4, 256, 128
    k8, ks = _int8((L, B, H, n_ctx, dh), cuda, page)
    v8, vs = _int8((L, B, H, n_ctx, dh), cuda, page + 1)
    live = [n // page + 1 for n in n_pasts]
    P = sum(live) + 1
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(page)).tolist()
    table = torch.full((B, n_ctx // page), 10**6, dtype=torch.int32)
    pools = [torch.zeros((P, L, H, page) + t.shape[-1:], dtype=t.dtype, device=cuda) for t in (k8, v8, ks, vs)]
    for b in range(B):
        for c in range(live[b]):
            pid = ids.pop()
            table[b, c] = pid
            for pool, t in zip(pools, (k8, v8, ks, vs)):
                pool[pid] = t[:, b, :, c * page : (c + 1) * page]
    table = table.to(cuda)
    q = torch.randn((B, H, dh), device=cuda, generator=torch.Generator(device=cuda).manual_seed(4))
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    for il in range(L):
        out = att.flash_decode_attention_paged_int8(q, *pools, table, il, np_, max(n_pasts))
        ref = att.flash_decode_attention_paged_int8_plain(q, *pools, table, il, np_, max(n_pasts))
        dense = att.flash_decode_attention_batched_int8(q, k8, v8, ks, vs, il, np_, max(n_pasts))
        torch.cuda.synchronize()
        assert _rel(out, ref) <= 1e-5
        assert _rel(out, dense) <= 1e-5


def test_int8_wrappers_raise_on_bad_inputs(cuda):
    q = torch.zeros((2, 128), device=cuda)
    k8 = torch.zeros((1, 2, 16, 128), dtype=torch.int8, device=cuda)
    s = torch.zeros((1, 2, 16, 1), device=cuda)
    with pytest.raises(ValueError):  # f32 caches given to the int8 kernel
        att.flash_decode_attention_stacked_int8(q, k8.float(), k8.float(), s, s, 0, 3)
    with pytest.raises(ValueError):  # scales of the wrong shape
        att.flash_decode_attention_stacked_int8(q, k8, k8, s[..., 0], s[..., 0], 0, 3)
    with pytest.raises(ValueError):  # int8 caches given to the float kernel
        att.flash_decode_attention(q, k8, k8, 0, 3)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_forward_batched_int8_card_matches_cpu(cuda, paged):
    """A 2-layer, 128-dim-head Q4_0 model with f32 activations and f32
    prefill products: slot prefills and forward_batched over an int8 cache on
    the card (the int8 batched or paged kernel) against the CPU (their plain
    versions), logits within the repo's 2e-3 bar.  (bf16 prefill operands
    move the stored K/V by ~2^-9, and the int8 codes turn that into whole
    code steps.)"""
    import numpy as np

    from llama_swift_torch.config import ModelConfig
    from llama_swift_torch.formats.quant import Q4_0Tensor
    from llama_swift_torch.models import llama as model_lib

    cfg = ModelConfig(n_vocab=512, n_embd=256, n_mult=256, n_head=2, n_layer=2, n_rot=128, n_ctx=256,
                      quantize_activations=False, prefill_bf16=False, kv_cache_dtype="int8")
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v)
               for k, v in model_lib.random_params(cfg, seed=11).items()}
    prompts = [[1, 17, 300, 42, 99], [1, 260, 7], [1, 5, 6, 7, 8, 9, 10, 11, 12]]
    steps = [[4, 6, 9, 0], [77, 3, 210, 0], [5, 411, 2, 0]]

    def run(device):
        params = model_lib.params_from_tensors(tensors, cfg, device=device, param_dtype=torch.float32)
        if paged:
            cache = model_lib.init_cache_paged(cfg, 8, 4, page=64, device=device)
            cache["page_table"][:3, 0] = torch.tensor([4, 2, 0], dtype=torch.int32)
            cache["page_table"][2, 1] = 5
        else:
            cache = model_lib.init_cache_batched(cfg, 4, device=device)
        out = []
        for b, ids in enumerate(prompts):
            lg, cache = model_lib.forward(params, torch.tensor(ids, device=device), 0, cache, cfg, slot=b)
            out.append(lg.cpu())
        n_pasts = np.array([len(p) for p in prompts] + [0])
        for toks in steps:
            lg, cache = model_lib.forward_batched(params, torch.tensor(toks, device=device), n_pasts, cache, cfg)
            out.append(lg[:3].cpu())
            n_pasts[:3] += 1
        return out

    kernel = att.flash_decode_attention_paged_int8 if paged else att.flash_decode_attention_batched_int8
    before = kernel.launches
    f32_before, dq_before = mv.q4_0_matmul_multi_f32.launches, dq.q4_0_dequant.launches
    card = run(cuda)
    assert kernel.launches == before + len(steps) * cfg.n_layer
    # every product of 3-9 rows (slot prefills, batched steps) takes the
    # f32-activation multi-row kernel; none dequantizes
    per_forward = 7 * cfg.n_layer + 1
    assert mv.q4_0_matmul_multi_f32.launches == f32_before + (len(prompts) + len(steps)) * per_forward
    assert dq.q4_0_dequant.launches == dq_before
    for c, r in zip(card, run("cpu")):
        assert _rel(c, r) <= 2e-3


def _fused_inputs(device, L, H, F, n_ctx, dtype, seed):
    from llama_swift_torch.ops import fused_layer as fl

    D = H * fl.HEAD_DIM
    ws = [_q4(L * out, in_dim, device, seed + i)[0] for i, (out, in_dim) in
          enumerate([(3 * D, D), (D, D), (2 * F, D), (D, F)])]
    ws = [mv.Q4_0Weight(w.qs.reshape(L, -1, w.qs.shape[-1]), w.d.reshape(L, -1, w.d.shape[-1])) for w in ws]
    g = torch.Generator(device=device).manual_seed(seed)
    norms = [1.0 + 0.05 * torch.randn((L, D), device=device, generator=g) for _ in range(2)]
    x = torch.randn(D, device=device, generator=g)
    kc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device=device, generator=g).to(dtype)
    vc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), device=device, generator=g).to(dtype)
    return x, norms, ws, kc, vc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_past", [0, 63, 64, 200])
def test_fused_layers_kernel_matches_plain(cuda, dtype, n_past):
    """The whole-stack kernel against its plain version at 2 heads, n_ff 768
    (24 blocks: fewer than a warp's lanes), stale rows beyond n_past.  Where
    no 4-bit activation code differs between the two (their quantizer
    inputs are traced), x and the new K/V agree within 5e-4, the bar of the
    JAX package's fused tests (bf16 K/V: within one bf16 step); a flipped
    code moves the result by one quantization step, so then the first flip
    must sit at a rounding boundary and the plain arithmetic on the kernel's
    own quantizer inputs must agree with it (``utils/fused_check``, the bar
    chip_smoke.py holds too).  The check launches the kernel twice, the
    second time to see it repeat bit for bit."""
    from llama_swift_torch.ops import fused_layer as fl

    x, (an, fn), ws, kc, vc = _fused_inputs(cuda, 2, 2, 768, 256, dtype, seed=n_past)
    kc[:, :, n_past:] = 1e4
    vc[:, :, n_past:] = -1e4
    before = fl.fused_layers_block.launches
    _fused_matches_plain(x, an, fn, ws, kc, vc, n_past)
    assert fl.fused_layers_block.launches == before + 2


def test_fused_layers_grid_and_bad_inputs(cuda):
    from llama_swift_torch.ops import fused_layer as fl

    assert fl.grid_blocks(32, 11008) >= torch.cuda.get_device_properties(0).multi_processor_count
    x, (an, fn), ws, kc, vc = _fused_inputs(cuda, 1, 2, 768, 64, torch.float32, seed=1)
    with pytest.raises(ValueError):  # n_past beyond the cache
        fl.fused_layers_block(x, an, fn, *ws, kc, vc, 64)
    with pytest.raises(ValueError):  # an int8 cache takes the composed path
        fl.fused_layers_block(x, an, fn, *ws, kc.to(torch.int8), vc.to(torch.int8), 3)
    with pytest.raises(ValueError):  # a non-contiguous stack
        fl.fused_layers_block(x, an, fn, ws[0], ws[1], mv.Q4_0Weight(ws[2].qs.transpose(1, 2), ws[2].d), ws[3],
                              kc, vc, 3)


def _q41(out, in_dim, device, seed=0):
    """Random nibbles, d as in _q4, m ≈ −8·d·U(0.8, 1.2) (values centred near
    zero, as real Q4_1 weights are)."""
    w, g = _q4(out, in_dim, device, seed)
    m = -8.0 * w.d * (0.8 + 0.4 * torch.rand(w.d.shape, device=device, generator=g))
    return mv.Q4_1Weight(w.qs, torch.stack([w.d, m], dim=-1).contiguous()), g


@pytest.mark.parametrize("out,in_dim", [(8, 32), (1000, 352), (256, 4096), (77, 11008)])
def test_q4_1_matvec_kernel_matches_plain(cuda, out, in_dim):
    """The kernel's integer form (d_x·Σn·q + m_x·Σn per block) against the
    plain version's f32 sum of n·x̂, within 1e-5 of max |y|."""
    w, g = _q41(out, in_dim, cuda)
    x = torch.randn(in_dim, device=cuda, generator=g)
    before = mv.q4_1_matvec.launches
    y = mv.q4_1_matvec(x, w)
    torch.cuda.synchronize()
    assert mv.q4_1_matvec.launches == before + 1
    assert _rel(y, mv.q4_1_matvec_plain(x, w)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q4_1_dequant_kernel_bit_exact(cuda, dtype):
    w, _ = _q41(300, 4096, cuda)
    before = dq.q4_1_dequant.launches
    dense = dq.q4_1_dequant(w, dtype)
    assert dq.q4_1_dequant.launches == before + 1
    assert torch.equal(dense, dq.dequantize_q4_1(w, dtype))
    assert torch.equal(dense.cpu(), dq.dequantize_q4_1(mv.Q4_1Weight(w.qs.cpu(), w.dm.cpu()), dtype))


def test_q4_1_quantizer_divides_on_card(cuda):
    """Block ranges r where r·(1/15) and r/15 round apart: the card's plain
    quantizer divides, as the CPU and the kernel's pre-pass do."""
    import numpy as np

    r = np.random.default_rng(0).uniform(0.5, 8.0, 4096).astype(np.float32)
    r = r[r * np.float32(1.0 / 15.0) != r / np.float32(15.0)][:32]
    assert len(r) == 32
    x = torch.from_numpy(r)[:, None] * torch.linspace(0.0, 1.0, 32)  # block b spans [0, r_b]
    q_cpu, d_cpu, m_cpu = mv.quantize_activations_q4_1(x.reshape(-1))
    q, d, m = mv.quantize_activations_q4_1(x.to(cuda).reshape(-1))
    assert torch.equal(d.cpu(), d_cpu) and torch.equal(q.cpu(), q_cpu) and torch.equal(m.cpu(), m_cpu)


def test_q4_1_wrappers_raise_on_bad_inputs(cuda):
    w, _ = _q41(64, 256, cuda)
    with pytest.raises(ValueError):
        mv.q4_1_matvec(torch.randn(128, device=cuda), w)  # wrong in dim
    with pytest.raises(ValueError):  # d and m as two planes instead of (d, m) pairs
        mv.q4_1_matvec(torch.randn(256, device=cuda), mv.Q4_1Weight(w.qs, w.dm.transpose(-1, -2)))
    with pytest.raises(ValueError):
        dq.q4_1_dequant(w, torch.float16)


# f32 activations: the Q4_0 and Q4_1 matvecs and the Q4_0 multi-row matmul on
# unquantized rows, at ragged shapes (rows not a multiple of a block's rows,
# in-dims not a multiple of a warp's blocks or of a staged chunk), against
# their plain versions within 1e-5 of max |y|


@pytest.mark.parametrize("out,in_dim", [(8, 32), (1000, 352), (256, 4096), (77, 11008), (12288, 4096)])
def test_f32_matvec_kernels_match_plain(cuda, out, in_dim):
    w, g = _q41(out, in_dim, cuda)
    w0 = mv.Q4_0Weight(w.qs, w.d.contiguous())
    x = torch.randn(in_dim, device=cuda, generator=g)
    before = (mv.q4_0_matvec_f32.launches, mv.q4_1_matvec_f32.launches, mv.q4_0_matvec.launches)
    y0 = mv.q4_0_matvec(x, w0, quantize_acts=False)
    y1 = mv.q4_1_matvec(x, w, quantize_acts=False)
    torch.cuda.synchronize()
    assert (mv.q4_0_matvec_f32.launches, mv.q4_1_matvec_f32.launches, mv.q4_0_matvec.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert _rel(y0, mv.q4_0_matvec_f32_plain(x, w0)) <= 1e-5
    assert _rel(y1, mv.q4_1_matvec_plain(x, w, quantize_acts=False)) <= 1e-5


@pytest.mark.parametrize("B", [2, 5, 8, 17, 32])
@pytest.mark.parametrize("out,in_dim", [(77, 352), (1000, 4096), (300, 11008)])
def test_f32_matmul_multi_kernel_matches_plain(cuda, B, out, in_dim):
    w, g = _q4(out, in_dim, cuda)
    x = torch.randn((B, in_dim), device=cuda, generator=g)
    before = mv.q4_0_matmul_multi_f32.launches
    y = mv.q4_0_matmul_multi(x, w, quantize_acts=False)
    torch.cuda.synchronize()
    assert mv.q4_0_matmul_multi_f32.launches == before + 1
    assert _rel(y, mv.q4_0_matmul_multi_f32_plain(x, w)) <= 1e-5


def test_f32_wrappers_raise_on_bad_inputs(cuda):
    w, g = _q41(64, 256, cuda)
    w0 = mv.Q4_0Weight(w.qs, w.d.contiguous())
    with pytest.raises(ValueError):
        mv.q4_0_matvec_f32(torch.randn(128, device=cuda), w0)  # wrong in dim
    with pytest.raises(ValueError):
        mv.q4_1_matvec_f32(torch.randn(256, device=cuda, dtype=torch.float16), w)
    with pytest.raises(ValueError):
        mv.q4_0_matmul_multi_f32(torch.randn((33, 256), device=cuda), w0)  # too many rows
    with pytest.raises(ValueError):
        mv.q4_0_matmul_multi_f32(torch.randn((256, 4), device=cuda).t(), w0)  # not contiguous
    with pytest.raises(ValueError):  # x on the card, the weight on the CPU
        mv.q4_0_matvec_f32(torch.randn(256, device=cuda), mv.Q4_0Weight(w0.qs.cpu(), w0.d.cpu()))


@pytest.mark.parametrize("rows", [1, 33, 64])
@pytest.mark.parametrize("out,in_dim", [(77, 352), (1000, 4096), (300, 11008)])
def test_q4_0_matmul_t_kernel_matches_plain(cuda, rows, out, in_dim):
    """The T-layout kernel (ragged out tiles and in chunks, each row
    template's edge) against its plain version; a bad input raises."""
    from llama_swift_torch.ops import q4_matmul as qm

    w, g = _q4(out, in_dim, cuda, seed=rows)
    w = qm.Q4_0WeightT(w.qs, w.d)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    before = qm.q4_0_matmul_t.launches
    y = qm.q4_0_matmul_t(x, w)
    torch.cuda.synchronize()
    assert qm.q4_0_matmul_t.launches == before + 1
    assert _rel(y, qm.q4_0_matmul_t_plain(x, w)) <= 1e-5
    with pytest.raises(ValueError):
        qm.q4_0_matmul_t(torch.randn((65, in_dim), device=cuda), w)
    with pytest.raises(ValueError):
        qm.q4_0_matmul_t(x[:, :-32].contiguous(), w)


@pytest.mark.parametrize("rows", [1, 7, 8, 33, 64, 100])
@pytest.mark.parametrize("out,in_dim", [(16, 32), (77, 352), (1000, 4096), (300, 11008)])
def test_q4_0_int_matmul_kernel_matches_plain(cuda, rows, out, in_dim):
    """The int8 mma kernel (row 12): a single 16-row block first, then
    ragged out tiles, in-dims that are not a multiple of the 8 warps'
    blocks, N on both sides of an 8-row tile and beyond one 64-row launch;
    within 1e-5 of max |y| (exact integer block dots, f32 sums in another
    order); bad inputs raise."""
    from llama_swift_torch.ops import q4_matmul as qm

    w, g = _q4(out, in_dim, cuda, seed=rows + out)
    w = qm.Q4_0WeightT(w.qs, w.d)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    before = qm.q4_0_int_matmul.launches
    y = qm.q4_0_int_matmul(x, w)
    torch.cuda.synchronize()
    assert qm.q4_0_int_matmul.launches == before + 1
    assert _rel(y, qm.q4_0_int_matmul_plain(x, w)) <= 1e-5
    with pytest.raises(ValueError):
        qm.q4_0_int_matmul(x[:, :-32].contiguous(), w)  # wrong in dim
    with pytest.raises(ValueError):
        qm.q4_0_int_matmul(x.double(), w)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("rows", [1, 2, 8, 32])
def test_q4_0_t_matmul_multi_matches_plain(cuda, rows, quantize):
    """Row 13's wrapper over the matvec (B = 1) and the multi-row kernels,
    quantized or on f32 rows, counted as its own launch only."""
    from llama_swift_torch.ops import q4_matmul as qm

    w, g = _q4(300, 4096, cuda, seed=rows)
    w = qm.Q4_0WeightT(w.qs, w.d)
    x = torch.randn((rows, 4096), device=cuda, generator=g)
    ops.reset_launch_counts()
    y = qm.q4_0_t_matmul_multi(x, w, quantize_acts=quantize)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("q4_0_t_matmul_multi") == 1 and set(counts.values()) == {0}
    assert _rel(y, qm.q4_0_t_matmul_multi_plain(x, w, quantize_acts=quantize)) <= 1e-5
    with pytest.raises(ValueError):
        qm.q4_0_t_matmul_multi(torch.randn((33, 4096), device=cuda), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_past", [0, 63, 64, 200])
def test_fused_blocks_match_plain(cuda, dtype, n_past):
    """The attention and FFN blocks against their plain versions at 2
    heads, n_ff 768, stale rows at and beyond n_past (never read): the cache
    unchanged, k_new/v_new within 1e-5 (bf16: one bf16 step), the deltas
    within 5e-4 where no 4-bit activation code differs (traced)."""
    from llama_swift_torch.ops import fused_layer as fl

    x, (an, fn), (wqkv, wo, w13, w2), kc, vc = _fused_inputs(cuda, 2, 2, 768, 256, dtype, seed=n_past)
    kc[:, :, n_past:] = 1e4
    vc[:, :, n_past:] = -1e4
    k0, v0 = kc.clone(), vc.clone()
    cos, sin = fl.rope_vectors(n_past, device=cuda)
    tr_k, tr_p = [], []
    before = (fl.fused_attn_block.launches, fl.fused_ffn_block.launches)
    delta, k_new, v_new = fl.fused_attn_block(x, an[1], cos, sin, wqkv, wo, kc, vc, 1, n_past, trace=tr_k)
    fdelta = fl.fused_ffn_block(x, fn[1], w13, w2, 1, trace=tr_k)
    torch.cuda.synchronize()
    assert (fl.fused_attn_block.launches, fl.fused_ffn_block.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(kc, k0) and torch.equal(vc, v0)
    ref, k_ref, v_ref = fl.fused_attn_block_plain(x, an[1], cos, sin, wqkv, wo, kc, vc, 1, n_past, trace=tr_p)
    fref = fl.fused_ffn_block_plain(x, fn[1], w13, w2, 1, trace=tr_p)
    for a, b in ((k_new, k_ref), (v_new, v_ref)):
        if dtype == torch.bfloat16:
            assert bool(((a - b).abs() <= b.abs() * 2.0**-7).all())
        else:
            assert _rel(a, b) <= 1e-5
    for (got, want), tk, tp in zip(((delta, ref), (fdelta, fref)), tr_k, tr_p):
        flips = int((mv.quantize_activations_q4_0_int(tk)[0] != mv.quantize_activations_q4_0_int(tp)[0]).sum())
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 5e-4 or 0 < flips <= 8, (_rel(got, want), flips)


def test_fused_blocks_grid_and_bad_inputs(cuda):
    from llama_swift_torch.ops import fused_layer as fl

    n_attn, n_ffn = fl.block_grids(32, 11008)
    assert min(n_attn, n_ffn) >= torch.cuda.get_device_properties(0).multi_processor_count
    x, (an, fn), (wqkv, wo, w13, w2), kc, vc = _fused_inputs(cuda, 1, 2, 768, 64, torch.float32, seed=1)
    cos, sin = fl.rope_vectors(3, device=cuda)
    with pytest.raises(ValueError):  # n_past beyond the cache
        fl.fused_attn_block(x, an[0], cos, sin, wqkv, wo, kc, vc, 0, 64)
    with pytest.raises(ValueError):  # an int8 cache: the JAX block has no scales
        fl.fused_attn_block(x, an[0], cos, sin, wqkv, wo, kc.to(torch.int8), vc.to(torch.int8), 0, 3)
    with pytest.raises(ValueError):  # a layer beyond the stack
        fl.fused_ffn_block(x, fn[0], w13, w2, 1)
    with pytest.raises(ValueError):  # the weight on the CPU
        fl.fused_ffn_block(x, fn[0], mv.Q4_0Weight(w13.qs.cpu(), w13.d.cpu()), w2, 0)


@pytest.mark.parametrize("bias", [0, -7, 2**31 - 1])
@pytest.mark.parametrize("out,in_dim", [(128, 32), (384, 352), (256, 4096), (128, 11008)])
def test_stream_probe_kernel_bit_equal_to_plain(cuda, out, in_dim, bias):
    """Every row's wrapped int32 sum, rounded once to f32, equal to the
    plain version (in-dims on both sides of a warp's four 512-byte loads)."""
    g = torch.Generator(device=cuda).manual_seed(out + in_dim)
    qs = torch.randint(0, 256, (out, in_dim // 2), dtype=torch.uint8, device=cuda, generator=g)
    before = mv.stream_probe.launches
    rows = mv.stream_probe(qs, bias, all_rows=True)
    torch.cuda.synchronize()
    assert mv.stream_probe.launches == before + 1
    assert torch.equal(rows, mv.stream_probe_plain(qs, bias, all_rows=True))
    assert torch.equal(mv.stream_probe(qs, bias), rows[::128])
    with pytest.raises(ValueError):
        mv.stream_probe(qs[:, 1:], bias)  # not 16-byte aligned


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_dense_dequant_params_on_card_equal_cpu(cuda, kind):
    """params_from_tensors(dense_dequant=True): the card's leaves equal the
    CPU's (bf16), one dequant launch a packed tensor, and a decode step on
    them launches no Q4 kernel."""
    import numpy as np

    from llama_swift_torch.config import ModelConfig
    from llama_swift_torch.formats.quant import Q4_0Tensor, Q4_1Tensor
    from llama_swift_torch.models import llama as model_lib

    cfg = ModelConfig(n_vocab=256, n_embd=256, n_mult=256, n_head=2, n_layer=2, n_ctx=64)
    cls = Q4_0Tensor if kind == "q4_0" else Q4_1Tensor
    rng = np.random.default_rng(0)
    tensors = {}
    for name, shape in model_lib.expected_tensor_shapes(cfg).items():
        if len(shape) == 1:
            tensors[name] = np.ones(shape, np.float32)
        else:
            tensors[name] = cls.quantize((rng.standard_normal(shape) * 0.05).astype(np.float32))
    ops.reset_launch_counts()
    params = model_lib.params_from_tensors(tensors, cfg, device=cuda, dense_dequant=True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {f"{kind}_dequant": 7 * cfg.n_layer + 2}
    ref = model_lib.params_from_tensors(tensors, cfg, device="cpu", param_dtype=torch.bfloat16, dense_dequant=True)
    for name in ("tok_embeddings", "output"):
        assert torch.equal(params[name].cpu(), ref[name])
    for name, t in params["layers_stacked"].items():
        assert torch.equal(t.cpu(), ref["layers_stacked"][name]), name
    ops.reset_launch_counts()
    cache = model_lib.init_cache(cfg, device=cuda)
    logits, _ = model_lib.decode_step(params, torch.tensor(5, device=cuda), 0, cache, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert {k: v for k, v in ops.launch_counts().items() if v} == {"flash_decode_attention": cfg.n_layer}


# ---------------------------------------------------------------------------
# batch-1 flash decode (one launch a call) and the whole-stack kernel
# ---------------------------------------------------------------------------


def _flash_stacked(kind, L, H, n_ctx, dh, n_past, cuda, seed):
    """(q, call, plain) over a seeded stacked cache of ``kind`` with stale
    rows beyond n_past in layer 1 (int8: codes 127 and scales 1e3)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((H, dh), device=cuda, generator=g)
    if kind == "int8":
        k8, ks = _int8((L, H, n_ctx, dh), cuda, seed + 1)
        v8, vs = _int8((L, H, n_ctx, dh), cuda, seed + 2)
        _stale_int8(k8[1], ks[1], n_past)
        _stale_int8(v8[1], vs[1], n_past)
        return (lambda: att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, 1, n_past),
                lambda: att.flash_decode_attention_stacked_int8_plain(q, k8, v8, ks, vs, 1, n_past))
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[kind]
    kc = torch.randn((L, H, n_ctx, dh), device=cuda, generator=g).to(dtype)
    vc = torch.randn((L, H, n_ctx, dh), device=cuda, generator=g).to(dtype)
    kc[1, :, n_past + 1 :] = 1e4
    vc[1, :, n_past + 1 :] = -1e4
    return (lambda: att.flash_decode_attention(q, kc, vc, 1, n_past),
            lambda: att.flash_decode_attention_plain(q, kc, vc, 1, n_past))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_ctx,n_past", [(256, 63), (256, 64), (256, 65), (2048, 2047), (2048, 1000)])
def test_flash_split_edges_and_long_context(cuda, kind, n_ctx, n_past):
    """Batch-1 flash decode on both sides of a 64-key boundary and at the
    last position of a 2048-key context (8 splits of 256 keys, each a ring
    of tiles), 32 heads of 128 dims, against the plain version."""
    call, plain = _flash_stacked(kind, 2, 32, n_ctx, 128, n_past, cuda, seed=n_past)
    assert _rel(call(), plain()) <= 1e-5


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("dh", [32, 256, 1024])
def test_flash_head_dims_at_the_edges(cuda, kind, dh):
    """Batch-1 flash decode at head dims whose rows are the narrowest (int8
    32: 32 bytes) and widest (f32 1024: 4 KB, a 4-row tile) the kernel
    takes, over several tiles a split."""
    call, plain = _flash_stacked(kind, 2, 2, 1024, dh, 900, cuda, seed=dh)
    assert _rel(call(), plain()) <= 1e-5


def test_flash_int8_value_scales_across_ring_wraps(cuda):
    """Batch-1 int8 flash decode where each split's ring of tiles wraps
    (8192 keys: 8 splits of 1024, 128-row tiles in 5 stages) and the V row
    scales of alternate tiles differ by 1000x, so a value weighted by the
    scale left in its ring stage by an earlier tile, or read before its copy
    lands, moves the output far beyond 1e-5.  Twenty calls, each against the
    plain version."""
    n_ctx, n_past = 8192, 8191
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 128), device=cuda, generator=g)
    k8, ks = _int8((1, 2, n_ctx, 128), cuda, 6)
    v8, vs = _int8((1, 2, n_ctx, 128), cuda, 7)
    tile_odd = (torch.arange(n_ctx, device=cuda) // 128) % 2 == 1
    vs[..., tile_odd, :] *= 1e3  # scales [1, 2, n_ctx, 1]
    ref = att.flash_decode_attention_stacked_int8_plain(q, k8, v8, ks, vs, 0, n_past)
    for _ in range(20):
        assert _rel(att.flash_decode_attention_stacked_int8(q, k8, v8, ks, vs, 0, n_past), ref) <= 1e-5


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_past", [0, 127, 511])
def test_flash_calls_repeat_bit_for_bit(cuda, kind, n_past):
    """Two consecutive calls on the same inputs give the same bits: the
    splits combine in a fixed order and leave no state behind."""
    call, _ = _flash_stacked(kind, 2, 32, 512, 128, n_past, cuda, seed=7 + n_past)
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _fused_matches_plain(x, an, fn, ws, kc, vc, n_past):
    """The bar chip_smoke.py holds the whole-stack kernel to
    (``utils/fused_check.fused_case``)."""
    from llama_swift_torch.utils.fused_check import fused_case

    rec = fused_case(x, (an, fn), ws, kc, vc, n_past)
    assert rec["ok"], rec


@pytest.mark.parametrize("n_past", [0, 100, 300])
def test_fused_layers_four_layers_bf16(cuda, n_past):
    """Four layers at 4 heads, n_ff 1024, on a bf16 cache against the plain
    version (the same bar as the 2-layer case)."""
    x, (an, fn), ws, kc, vc = _fused_inputs(cuda, 4, 4, 1024, 512, torch.bfloat16, seed=40 + n_past)
    kc[:, :, n_past:] = 1e4
    vc[:, :, n_past:] = -1e4
    _fused_matches_plain(x, an, fn, ws, kc, vc, n_past)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_past", [5, 200])
def test_fused_layers_calls_repeat_bit_for_bit(cuda, dtype, n_past):
    """Two consecutive whole-stack calls on cloned inputs agree bit for bit
    (x and the caches): the arrival counters are zeroed by each launch and
    no atomic touches a float sum."""
    from llama_swift_torch.ops import fused_layer as fl

    x, (an, fn), ws, kc, vc = _fused_inputs(cuda, 2, 8, 1024, 256, dtype, seed=3 + n_past)
    kc2, vc2 = kc.clone(), vc.clone()
    first = fl.fused_layers_block(x, an, fn, *ws, kc, vc, n_past)
    second = fl.fused_layers_block(x, an, fn, *ws, kc2, vc2, n_past)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
