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
counters; the six flash kernels at head dims that are no multiple of 32;
both dequants bit-exact and the multi-row product at the 7B, 13B and 65B
shapes, the latter with exact half-step ties in every row's codes; the two
f32-activation products on the bf16 tensor cores at those shapes, at every
row count, with one-hot x for their K order, repeated bit for bit, with x
off 16-byte alignment and at every share of tiles over a cluster; the
paged and the dense batched kernels at B = 1, 8, 16 (pages of 16 and 128)
and n_ctx 512 and 2048 with NaN in every row no live key names, one kernel
a call, the batched kernel at every plan its variant tool times; the f32
Q4_0 and Q4_1 matvecs at LLaMA's shapes, bit-equal to their lane
orders; the two 4-bit-activation matvecs at LLaMA's shapes, odd row
counts, in-dim 32 and the largest taken, bit-equal to their lane orders,
one kernel a call with no scratch, x off 16-byte alignment, blocks of
exact ties and flat blocks, the in-dim cap refused; the T layout's integer
product bit-equal to the multi-row product at 2-32 rows of the 7B shapes,
two kernels a call of at most 64 rows by CUDA-graph nodes, its plan's
shared memory the kernel's; the attention block's split plan the C
query's, and the block at 40 and 64 heads, one kernel a call; the stream
probe at row counts 132 blocks do not divide, rows wider than a ring slot
and an offset view, bit-equal, one kernel a call by CUDA-graph nodes;
causal prefill attention within 1e-5 of max|V| at N up to 2560, n_past up
to 1000 and head dims 16-256 on f32 and bf16 planes, where single-pass TF32
misses that bar, with NaN past n_past + N unread, and a tiny model's
prefill on it, one launch a layer).

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
    quantizer divides, as the CPU and the matvec kernel's quantizer do."""
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


@pytest.mark.parametrize("rows", [2, 8, 16, 32])
@pytest.mark.parametrize("out,in_dim", [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)])
def test_q4_0_int_matmul_bit_equal_to_multi_row(cuda, rows, out, in_dim):
    """Row 12 at 2–32 rows is row 6's launch: bit-equal to
    ``q4_0_matmul_multi`` at the 7B shapes."""
    from llama_swift_torch.ops import q4_matmul as qm

    w, g = _q4(out, in_dim, cuda, seed=rows + out)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    assert torch.equal(qm.q4_0_int_matmul(x, qm.Q4_0WeightT(w.qs, w.d)), mv.q4_0_matmul_multi(x, w))


@pytest.mark.parametrize("rows", [1, 33, 40, 57, 64, 65, 100, 130])
@pytest.mark.parametrize("out,in_dim", [(77, 352), (4096, 4096), (11008, 4096), (4096, 11008)])
def test_q4_0_int_matmul_launches_and_repeats(cuda, rows, out, in_dim):
    """Row 12 beyond row 6's rows: within 1e-5 of max |y|, a second call
    bit-equal, and two kernels (the pre-pass and the product) for each call
    of at most 64 rows of ``int_matmul_plan``, counted as CUDA-graph nodes
    (chip_smoke.graph_kernels)."""
    from chip_smoke import graph_kernels
    from llama_swift_torch.ops import q4_matmul as qm

    w, g = _q4(out, in_dim, cuda, seed=rows + out)
    w = qm.Q4_0WeightT(w.qs, w.d)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    y = qm.q4_0_int_matmul(x, w)
    assert _rel(y, qm.q4_0_int_matmul_plain(x, w)) <= 1e-5
    assert torch.equal(y, qm.q4_0_int_matmul(x, w))
    plan = mv.int_matmul_plan(out, in_dim, rows, torch.cuda.get_device_properties(0).multi_processor_count)
    assert graph_kernels(torch, lambda: qm.q4_0_int_matmul(x, w)) == 2 * len(plan.launches)


def test_int_matmul_plan_smem_matches_the_kernel(cuda):
    from llama_swift_torch.ops import build

    lib = build.lib("q4_matvec")
    for B in range(1, mv.MAX_INT_LAUNCH_ROWS + 1):
        assert lib.q4_0_matmul_multi_smem_bytes(B) == mv.int_matmul_plan(4096, 4096, B).launches[0][2].smem


def test_q4_0_int_matmul_refuses_rows_beyond_a_launch(cuda):
    """The C entry takes 1..64 rows a call (the wrapper cuts more), and
    row 6's entry 1..32."""
    from llama_swift_torch.ops import build

    lib = build.lib("q4_matvec")
    w, g = _q4(64, 256, cuda)
    x = torch.randn((65, 256), device=cuda, generator=g)
    xq = torch.empty((72, 256), dtype=torch.int8, device=cuda)
    bd = torch.empty((8, 72, 2), dtype=torch.int32, device=cuda)
    y = torch.empty((65, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(), bd.data_ptr(), y.data_ptr())
    assert lib.q4_0_int_matmul(*ptrs, 64, 256, 65, 1, stream) != 0
    assert lib.q4_0_int_matmul(*ptrs, 64, 256, 0, 1, stream) != 0
    assert lib.q4_0_matmul_multi(*ptrs, 64, 256, 33, 1, stream) != 0
    assert lib.q4_0_int_matmul(*ptrs, 64, 256, 64, 3, stream) != 0  # a cluster of 3
    torch.cuda.synchronize()


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


def test_attn_block_plan_matches_the_kernel(cuda):
    """The attention block's splits and keys a split, from its C query,
    are ``attn_block_plan``'s on this card."""
    from llama_swift_torch.ops import build
    from llama_swift_torch.ops import fused_layer as fl

    lib = build.lib("fused_layer")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for H in (1, 2, 32, 40, 52, 64):
        for n_past in (0, 1, 15, 16, 17, 63, 64, 127, 200, 511, 1000, 2047):
            got = (lib.fused_attn_block_splits(H, n_past), lib.fused_attn_block_split_keys(H, n_past))
            assert got == fl.attn_block_plan(H, n_past, sms), (H, n_past)


@pytest.mark.parametrize("H", [40, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_past", [0, 17, 511])
def test_attn_block_at_wide_heads(cuda, H, dtype, n_past):
    """The attention block at 13B's and 65B's head counts (3 and 2 splits a
    head on 132 SMs), one layer, stale rows at and beyond n_past: the cache
    unchanged, one kernel a call (CUDA-graph nodes), a second call
    bit-equal, k_new/v_new and delta under the bars of
    ``test_fused_blocks_match_plain``."""
    from chip_smoke import graph_kernels
    from llama_swift_torch.ops import fused_layer as fl
    from llama_swift_torch.utils import fused_check

    x, (an, _), (wqkv, wo, _, _), kc, vc = _fused_inputs(cuda, 1, H, 256, 512, dtype, seed=H + n_past)
    kc[:, :, n_past:] = 1e4
    vc[:, :, n_past:] = -1e4
    k0, v0 = kc.clone(), vc.clone()
    cos, sin = fl.rope_vectors(n_past, device=cuda)
    tr_k, tr_p = [], []
    got = fl.fused_attn_block(x, an[0], cos, sin, wqkv, wo, kc, vc, 0, n_past, trace=tr_k)
    torch.cuda.synchronize()
    assert torch.equal(kc, k0) and torch.equal(vc, v0)
    again = fl.fused_attn_block(x, an[0], cos, sin, wqkv, wo, kc, vc, 0, n_past)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert graph_kernels(torch, lambda: fl.fused_attn_block(x, an[0], cos, sin, wqkv, wo, kc, vc, 0, n_past)) == 1
    delta, k_new, v_new = got
    ref, k_ref, v_ref = fl.fused_attn_block_plain(x, an[0], cos, sin, wqkv, wo, kc, vc, 0, n_past, trace=tr_p)
    pairs = ((k_new, k_ref), (v_new, v_ref))
    if dtype == torch.bfloat16:  # chip_smoke's bar for the same rows, as the cache holds them
        assert fused_check.kv_rows_ok(tuple((a.to(dtype), b.to(dtype)) for a, b in pairs))[0]
    else:
        assert max(_rel(a, b) for a, b in pairs) <= 1e-5
    flips = int((mv.quantize_activations_q4_0_int(tr_k[0])[0] != mv.quantize_activations_q4_0_int(tr_p[0])[0]).sum())
    assert bool(torch.isfinite(delta).all())
    assert _rel(delta, ref) <= 5e-4 or 0 < flips <= 8, (_rel(delta, ref), flips)


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


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bias", [0, -7, 2**31 - 1])
@pytest.mark.parametrize("out,in_dim", [(128, 32), (384, 352), (256, 4096), (128, 11008), (4352, 4096),
                                        (32000, 4096), (128, 65536)])
def test_stream_probe_kernel_bit_equal_to_plain(cuda, out, in_dim, bias, stacked):
    """Every row's wrapped int32 sum, rounded once to f32, equal to the
    plain version: in-dims below and above a 16 KB ring slot (128×65536:
    two pieces a row), row counts that 132 blocks do not divide (4352,
    32000), and ``qs[1]`` of a stacked ``[3, out, in/2]`` (an offset view,
    as kernelbench and chip_smoke.py take it); a second call bit-equal, one
    kernel node a call in a CUDA graph (chip_smoke.graph_kernels)."""
    from chip_smoke import graph_kernels

    g = torch.Generator(device=cuda).manual_seed(out + in_dim)
    qs = torch.randint(0, 256, (3 if stacked else 1, out, in_dim // 2), dtype=torch.uint8, device=cuda, generator=g)
    qs = qs[1] if stacked else qs[0]
    before = mv.stream_probe.launches
    rows = mv.stream_probe(qs, bias, all_rows=True)
    torch.cuda.synchronize()
    assert mv.stream_probe.launches == before + 1
    assert torch.equal(rows, mv.stream_probe_plain(qs, bias, all_rows=True))
    assert torch.equal(mv.stream_probe(qs, bias), rows[::128])
    assert torch.equal(mv.stream_probe(qs, bias, all_rows=True), rows)
    assert graph_kernels(torch, lambda: mv.stream_probe(qs, bias, all_rows=True)) == 1
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


# ---------------------------------------------------------------------------
# head dims, the dequants and the multi-row product at LLaMA shapes
# ---------------------------------------------------------------------------


def _kind_cache(kind, shape, cuda, seed):
    """(cache, row scales or None) of ``kind``, seeded; int8 by the port's write."""
    if kind == "int8":
        return _int8(shape, cuda, seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, device=cuda, generator=g).to(getattr(torch, kind)), None


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dh", [16, 18, 48, 80, 128])
def test_six_flash_kernels_at_head_dims(cuda, kind, dh):
    """Batch 1 (every slot's plane), batched and paged flash decode at head
    dims that are no multiple of 32 (16: ModelConfig.tiny's; 18: rows of no
    whole 16-byte unit on any cache type, staged by plain loads, 2 dims for
    a row's last value thread) and at 128 (the bulk copy), each against its
    plain version, stale rows beyond every n_past, a shuffled page table."""
    L, H, n_ctx, page = 2, 4, 256, 16
    n_pasts = [0, 63, 64, 200, 255]
    B = len(n_pasts)
    kc, ks = _kind_cache(kind, (L, B, H, n_ctx, dh), cuda, dh)
    vc, vs = _kind_cache(kind, (L, B, H, n_ctx, dh), cuda, dh + 1)
    for b, n in enumerate(n_pasts):
        if ks is None:
            kc[:, b, :, n + 1 :] = 1e4
            vc[:, b, :, n + 1 :] = -1e4
        else:
            _stale_int8(kc[:, b], ks[:, b], n)
            _stale_int8(vc[:, b], vs[:, b], n)
    dense = (kc, vc) if ks is None else (kc, vc, ks, vs)
    live = [n // page + 1 for n in n_pasts]
    P = sum(live) + 1
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(dh)).tolist()
    table = torch.full((B, n_ctx // page), 10**6, dtype=torch.int32)
    pools = [torch.zeros((P, L, H, page) + t.shape[-1:], dtype=t.dtype, device=cuda) for t in dense]
    for b in range(B):
        for c in range(live[b]):
            pid = ids.pop()
            table[b, c] = pid
            for pool, t in zip(pools, dense):
                pool[pid] = t[:, b, :, c * page : (c + 1) * page]
    table = table.to(cuda)
    q = torch.randn((B, H, dh), device=cuda, generator=torch.Generator(device=cuda).manual_seed(7))
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    s = "" if ks is None else "_int8"
    one = getattr(att, "flash_decode_attention" if ks is None else "flash_decode_attention_stacked_int8")
    one_plain = getattr(att, one.__name__ + "_plain")
    bat = getattr(att, f"flash_decode_attention_batched{s}")
    bat_plain = getattr(att, f"flash_decode_attention_batched{s}_plain")
    pag = getattr(att, f"flash_decode_attention_paged{s}")
    pag_plain = getattr(att, f"flash_decode_attention_paged{s}_plain")
    for il in range(L):
        for b, n in enumerate(n_pasts):
            args = (q[b].contiguous(), *(t[:, b].contiguous() for t in dense), il, n)
            out = one(*args)
            assert out.shape == (H, dh) and _rel(out, one_plain(*args)) <= 1e-5, (il, b)
        args = (q, *dense, il, np_, max(n_pasts))
        assert _rel(bat(*args), bat_plain(*args)) <= 1e-5
        args = (q, *pools, table, il, np_, max(n_pasts))
        assert _rel(pag(*args), pag_plain(*args)) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_unaligned_planes_take_plain_loads(cuda, dtype):
    """128-dim rows on planes that are not 16-byte aligned (a contiguous view
    one element into its storage): batch 1 stages them with plain loads, and
    a dh the kernels refuse raises with the rule."""
    L, H, n_ctx, dh, n_past = 2, 4, 256, 128, 200
    g = torch.Generator(device=cuda).manual_seed(11)
    n = L * H * n_ctx * dh
    kc = torch.randn(n + 1, device=cuda, generator=g).to(dtype)[1:].view(L, H, n_ctx, dh)
    vc = torch.randn(n + 1, device=cuda, generator=g).to(dtype)[1:].view(L, H, n_ctx, dh)
    assert kc.is_contiguous() and kc.data_ptr() % 16
    q = torch.randn((H, dh), device=cuda, generator=g)
    out = att.flash_decode_attention(q, kc, vc, 1, n_past)
    assert _rel(out, att.flash_decode_attention_plain(q, kc, vc, 1, n_past)) <= 1e-5
    odd = torch.zeros((1, H, 16, 17), device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="must be even"):
        att.flash_decode_attention(torch.zeros((H, 17), device=cuda), odd, odd, 0, 3)


def _stacked_weight(kind, out, in_dim, cuda, seed):
    """Layer 1 of a 2-layer stack (views at an offset of one layer)."""
    make = _q4 if kind == "q4_0" else _q41
    a, _ = make(out, in_dim, cuda, seed)
    b, g = make(out, in_dim, cuda, seed + 1)
    if kind == "q4_0":
        return mv.Q4_0Weight(torch.stack([a.qs, b.qs]), torch.stack([a.d, b.d])).layer(1), g
    return mv.Q4_1Weight(torch.stack([a.qs, b.qs]), torch.stack([a.dm, b.dm])).layer(1), g


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out,in_dim", [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096), (77, 352),
                                        (5120, 13824), (22016, 8192)])
def test_dequant_kernels_bit_exact_at_llama_shapes(cuda, kind, dtype, out, in_dim):
    """Rows 3 and 3b on a stacked layer's views at the four 7B shapes, at 847
    blocks (no launch tile divides them) and at 13B and 65B matrices."""
    w, _ = _stacked_weight(kind, out, in_dim, cuda, seed=out)
    fn, plain = (dq.q4_0_dequant, dq.dequantize_q4_0) if kind == "q4_0" else (dq.q4_1_dequant, dq.dequantize_q4_1)
    before = fn.launches
    dense = fn(w, dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(dense, plain(w, dtype))


def test_dequant_refuses_unaligned_views(cuda):
    """The kernel loads 4 nibble bytes at once: qs two bytes into its storage
    is refused, not read misaligned."""
    w, _ = _q4(64, 256, cuda)
    raw = torch.zeros(w.qs.numel() + 2, dtype=torch.uint8, device=cuda)
    qs = raw[2:].view(w.qs.shape)
    assert qs.is_contiguous() and qs.data_ptr() % 4
    with pytest.raises(ValueError, match="aligned"):
        dq.q4_0_dequant(mv.Q4_0Weight(qs, w.d), torch.float32)


@pytest.mark.parametrize("B", [2, 3, 8, 16, 17, 32])
@pytest.mark.parametrize("out,in_dim", [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096),
                                        (1000, 13824), (300, 22016)])
def test_multi_row_kernel_at_llama_shapes(cuda, B, out, in_dim):
    """Row 6 on a stacked layer's views at the 7B shapes (4096 outputs: a
    cluster of 4 splits each tile's in-dim) and at the 13B and 65B in-dims,
    out not a multiple of the 64-row tile; one counted launch a call."""
    w, g = _stacked_weight("q4_0", out, in_dim, cuda, seed=B)
    x = torch.randn((B, in_dim), device=cuda, generator=g)
    before = mv.q4_0_matmul_multi.launches
    y = mv.q4_0_matmul_multi(x, w)
    torch.cuda.synchronize()
    assert mv.q4_0_matmul_multi.launches == before + 1
    assert y.shape == (B, out)
    assert _rel(y, mv.q4_0_matmul_multi_plain(x, w)) <= 1e-5


@pytest.mark.parametrize("B", [2, 8, 17, 32])
def test_multi_row_kernel_rounds_exact_ties_as_the_plain_version(cuda, B):
    """Every block of every row scaled so that d = amax / 7 is a power of two
    and every other element sits exactly on a k + 1/2 step: the codes round
    half away from zero on the card as in the plain version (a flipped code
    moves y by percents)."""
    out, in_dim = 1000, 4096
    w, g = _q4(out, in_dim, cuda, seed=B)
    nb = in_dim // 32
    e = torch.randint(-4, 4, (B, nb, 1), device=cuda, generator=g).float()
    k = torch.randint(-7, 7, (B, nb, 32), device=cuda, generator=g).float() + 0.5
    sign = torch.where(torch.rand((B, nb, 1), device=cuda, generator=g) < 0.5, -1.0, 1.0)
    k[:, :, :1] = 7.0 * sign  # amax = 7 d exactly
    x = (k * torch.exp2(e)).reshape(B, in_dim).contiguous()
    q, d = mv.quantize_activations_q4_0_int(x)
    assert torch.equal(d, torch.exp2(e).reshape(B, nb))
    y = mv.q4_0_matmul_multi(x, w)
    assert _rel(y, mv.q4_0_matmul_multi_plain(x, w)) <= 1e-5


def _warp_row_order(x, w):
    """y [B, out] from the plain version's terms (each block's exact dot
    times d_w * d_x, rounded) summed as the warp-a-row kernel summed them:
    per class of blocks b = l (mod 32) one sequential sum, then the 32
    class sums by a warp's butterfly tree (xor 16, 8, 4, 2, 1)."""
    q, dx = mv.quantize_activations_q4_0_int(x)
    terms = mv.q4_0_block_partials(q, w).float() * (w.d[None] * dx[:, None, :])  # [B, out, nb]
    sums = []
    for lane in range(32):
        acc = torch.zeros_like(terms[..., 0])
        for b in range(lane, terms.shape[-1], 32):
            acc = acc + terms[..., b]
        sums.append(acc)
    for o in (16, 8, 4, 2, 1):
        sums = [sums[lane] + sums[lane ^ o] for lane in range(32)]
    return sums[0]


@pytest.mark.parametrize("B", [2, 8, 11, 16])
@pytest.mark.parametrize("out,in_dim", [(4096, 4096), (1000, 4096), (300, 11008), (77, 352)])
def test_multi_row_kernel_sums_in_the_warp_row_order_to_16_rows(cuda, B, out, in_dim):
    """Up to 16 rows the product is bit for bit the sum in the earlier
    warp-a-row kernel's order (4096 outputs: a cluster of 2 splits the
    classes; 352 inputs: 11 blocks, classes with no block), so whole-path
    results built on it do not move."""
    w, g = _q4(out, in_dim, cuda, seed=B + out)
    x = torch.randn((B, in_dim), device=cuda, generator=g)
    assert torch.equal(mv.q4_0_matmul_multi(x, w), _warp_row_order(x, w))


def test_multi_plan_smem_matches_the_kernel(cuda):
    from llama_swift_torch.ops import build

    lib = build.lib("q4_matvec")
    for B in range(1, mv.MAX_MULTI_ROWS + 1):
        assert lib.q4_0_matmul_multi_smem_bytes(B) == mv.multi_plan(4096, 4096, B).smem


# The two f32-activation Q4_0 products on the bf16 tensor cores (rows 6f and
# 10: csrc/q4_f32_mma.cuh), within 1e-5 of max |y| of their plain versions:
# at the 7B shapes and at 13B and 65B matrices (in-dims 13824 and 22016), at
# every row count each wrapper takes, with one-hot x that catches a K order
# of the fragments that differs from the staged x's, a second launch
# bit-equal to the first, x off 16-byte alignment, and clusters whose blocks
# have one chunk each.


def _f32_product(kind):
    """(wrapper, plain version, launch counter holder, largest row count)."""
    from llama_swift_torch.ops import q4_matmul as qm

    if kind == "multi_f32":
        return mv.q4_0_matmul_multi_f32, mv.q4_0_matmul_multi_f32_plain, mv.q4_0_matmul_multi_f32, 32
    return qm.q4_0_matmul_t, qm.q4_0_matmul_t_plain, qm.q4_0_matmul_t, 64


def _t_weight(kind, w):
    from llama_swift_torch.ops import q4_matmul as qm

    return qm.Q4_0WeightT(w.qs, w.d) if kind == "t" else w


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 17, 32, 33, 64])
@pytest.mark.parametrize("out,in_dim", [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096),
                                        (5120, 13824), (22016, 8192), (8192, 22016)])
def test_f32_mma_products_at_llama_shapes(cuda, kind, rows, out, in_dim):
    """Both products on a stacked layer's views at LLaMA shapes (4096 and
    5120 outputs: a cluster of 2 splits each tile's in-dim; 22016 in: the
    65B FFN, beyond the f32 matvecs' cap); one counted launch a call."""
    fn, plain, counter, max_rows = _f32_product(kind)
    if rows > max_rows:
        pytest.skip(f"the {kind} product takes 1..{max_rows} rows")
    w, g = _stacked_weight("q4_0", out, in_dim, cuda, seed=rows)
    w = _t_weight(kind, w)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    before = counter.launches
    y = fn(x, w)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert y.shape == (rows, out)
    assert _rel(y, plain(x, w)) <= 1e-5


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("out,in_dim", [(77, 352), (1000, 4096), (130, 13824)])
def test_f32_mma_products_at_every_row_count(cuda, kind, out, in_dim):
    """Every row count the wrapper takes, ragged ones included (B or N not a
    multiple of 8; 352 inputs: 11 blocks, a ragged last chunk and scale
    rows off 16-byte alignment; out not a multiple of the 64-row tile)."""
    fn, plain, _, max_rows = _f32_product(kind)
    w, g = _q4(out, in_dim, cuda, seed=out)
    w = _t_weight(kind, w)
    xs = torch.randn((max_rows, in_dim), device=cuda, generator=g)
    for rows in range(1, max_rows + 1):
        x = xs[:rows]
        assert _rel(fn(x, w), plain(x, w)) <= 1e-5, rows


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("rows", [1, 2, 0])
@pytest.mark.parametrize("out,in_dim", [(64, 256), (300, 4096)])
def test_f32_mma_k_order_one_hot(cuda, kind, rows, out, in_dim):
    """Row r of x is one-hot at element r % 32 of block r // 32 (with a
    value that needs all three bf16 pieces): y[r, o] is then d[o, b] * (n -
    8) * v for one weight, so a fragment whose K order differs from the
    staged x's gives a wrong weight, not a rounding error; both sides are
    exact, so the results are equal.  One and two rows take the launch
    whose MMA columns are the three pieces of each row; 0 stands for the
    wrapper's largest row count."""
    fn, plain, _, max_rows = _f32_product(kind)
    max_rows = rows or max_rows
    w, _ = _q4(out, in_dim, cuda, seed=7)
    # scales of 8 significant bits: (n - 8) * d is exact, so the T plain
    # version's weight rounds nothing and each side rounds d * (n - 8) * v once
    w = _t_weight(kind, mv.Q4_0Weight(w.qs, w.d.to(torch.bfloat16).float()))
    v = 1.0 + 2.0**-9 + 2.0**-20  # bits in all three pieces
    for r0 in range(0, 64, max_rows):
        x = torch.zeros((max_rows, in_dim), device=cuda)
        for r in range(max_rows):
            x[r, (r0 + r) % 64] = v * (-1.0) ** r
        assert torch.equal(fn(x, w), plain(x, w)), r0


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("rows", [1, 8, 32, 64])
def test_f32_mma_second_launch_bit_equal(cuda, kind, rows):
    """The partial sums of a cluster meet in a fixed order: a second launch
    gives the same bits (4096 outputs: a cluster of 2)."""
    fn, _, _, max_rows = _f32_product(kind)
    rows = min(rows, max_rows)
    w, g = _q4(4096, 4096, cuda, seed=rows)
    w = _t_weight(kind, w)
    x = torch.randn((rows, 4096), device=cuda, generator=g)
    assert torch.equal(fn(x, w), fn(x, w))


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("rows,in_dim", [(1, 1024), (2, 544), (8, 512), (8, 288), (32, 256), (64, 160)])
def test_f32_mma_clusters_with_one_chunk_a_block(cuda, kind, rows, in_dim):
    """In-dims with exactly as many chunks as the cluster's 2 blocks (16, 8
    or 4 weight blocks a chunk), the second one ragged in three cases."""
    fn, plain, _, max_rows = _f32_product(kind)
    rows = min(rows, max_rows)
    plan = mv.f32_mma_plan(100, in_dim, rows)
    assert (plan.cluster, plan.cluster_tiles, plan.chunks) == (2, 1, 2)
    w, g = _q4(100, in_dim, cuda, seed=in_dim)
    w = _t_weight(kind, w)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    assert _rel(fn(x, w), plain(x, w)) <= 1e-5


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
def test_f32_mma_unaligned_x(cuda, kind):
    """x whose rows start off 16-byte alignment (a view at one float's
    offset) takes 4-byte copies and gives the same result."""
    fn, plain, _, _ = _f32_product(kind)
    w, g = _q4(300, 4096, cuda, seed=3)
    w = _t_weight(kind, w)
    buf = torch.randn(8 * 4096 + 1, device=cuda, generator=g)
    x = buf[1:].view(8, 4096)
    assert x.data_ptr() % 16
    y = fn(x, w)
    assert torch.equal(y, fn(x.clone(), w))
    assert _rel(y, plain(x, w)) <= 1e-5


def test_f32_mma_plan_smem_matches_the_kernels(cuda):
    from llama_swift_torch.ops import build

    query = build.lib("q4_matmul_t").q4_0_f32_mma_smem_bytes
    for rows in range(1, 65):
        assert query(rows) == mv.f32_mma_plan(4096, 4096, rows).smem, rows


@pytest.mark.parametrize("kind", ["multi_f32", "t"])
@pytest.mark.parametrize("rows", [1, 8, 9])
def test_f32_mma_every_cluster_share(cuda, kind, rows):
    """Every share of tiles over a cluster that the launcher takes (C <= 4
    blocks on T <= C tiles; beyond 8 rows C <= 2 and T = 1), on
    7 tiles (the last cluster short) of 22 blocks (a ragged last chunk): a
    block's units end one tile and begin the next; against each wrapper's
    plain version, the same bits on a second launch, and refused shares."""
    from llama_swift_torch.ops import build

    fn, plain, _, _ = _f32_product(kind)
    launch_c = build.lib("q4_matmul_t").q4_0_f32_mma  # the one C entry of both wrappers
    out, in_dim = 420, 704
    w, g = _q4(out, in_dim, cuda, seed=rows)
    x = torch.randn((rows, in_dim), device=cuda, generator=g)
    ref = plain(x, w)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(c, t):
        y = torch.full((rows, out), float("nan"), device=cuda)
        code = launch_c(w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, rows, c, t,
                        stream)
        return code, y

    chunks, tiles = mv.f32_mma_plan(out, in_dim, rows).chunks, -(-out // 64)
    shares = [(c, t) for c in range(1, 5) for t in range(1, c + 1)]
    for c, t in shares:
        code, y = launch(c, t)
        last = tiles - (-(-tiles // t) - 1) * t  # the tiles of the last cluster: a unit for each block
        legal = (t == 1 and c <= 2 if rows > 8 else True) and last * chunks >= c
        if not legal:
            assert code != 0, (c, t)
            continue
        assert code == 0, (c, t)
        assert _rel(y, ref) <= 1e-5, (c, t)
        assert torch.equal(y, launch(c, t)[1]), (c, t)
    assert launch(5, 1)[0] != 0 and launch(2, 3)[0] != 0 and launch(1, 2)[0] != 0


# ---------------------------------------------------------------------------
# the paged kernel on the chunk pass (one launch a call) and the Q4_0
# f32-activation matvec's persistent grid
# ---------------------------------------------------------------------------

KINDS = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _paged_pools(kind, B, H, dh, page, n_pasts, n_ctx, cuda, seed, L=2):
    """(q, poisoned pools, clean pools, table) for slots at ``n_pasts``: a
    shuffled table, the rows of every live page beyond its slot's n_past,
    the spare pages and the pages that the table's entries beyond each
    slot's live ones name all hold NaN (f32/bf16 rows, int8 row scales) in
    the poisoned pools, finite stale values in the clean ones; the kernel
    reads the poisoned pools, the plain version the clean ones."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    mp = n_ctx // page
    live = [n // page + 1 for n in n_pasts]
    spare = 3
    P = sum(live) + spare
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).tolist()
    table = torch.empty((B, mp), dtype=torch.int32)
    for b in range(B):
        for c in range(mp):
            table[b, c] = ids.pop() if c < live[b] else ids[c % spare]  # beyond live: the spare pages
    shape = (P, L, H, page, dh)
    q = torch.randn((B, H, dh), device=cuda, generator=g)
    if kind == "int8":
        k8, ks = _int8(shape, cuda, seed + 1)
        v8, vs = _int8(shape, cuda, seed + 2)
        clean = [k8, v8, ks, vs]
    else:
        clean = [torch.randn(shape, device=cuda, generator=g).to(KINDS[kind]) for _ in range(2)]
    dead = torch.ones((P, page), dtype=torch.bool)  # rows no live key of any slot reads
    for b, n in enumerate(n_pasts):
        for j in range(n + 1):
            dead[table[b, j // page], j % page] = False
    poisoned = [t.clone() for t in clean]
    for t in poisoned:
        if t.dtype != torch.int8:
            t.permute(0, 3, 1, 2, 4)[dead.to(cuda)] = float("nan")
    return q, poisoned, clean, table.to(cuda)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("n_ctx", [512, 2048])
def test_paged_chunk_pass_at_engine_shapes(cuda, kind, page, B, n_ctx):
    """The paged kernel at B = 1, 8 and 16, pages of 16 and 128, contexts of
    512 and 2048 with one slot at its last position and one at n_past 0,
    head dims 16, 18, 48, 80 and 128 (the plain-load path and the bulk
    copy), against its plain version within 1e-5; every row that no live
    key names is NaN, so a read past a slot's live keys or pages shows; a
    second launch repeats the first bit for bit."""
    n_pasts = [n_ctx - 1, 0, 63, 64, 200, 311, n_ctx // 2, 5, 31, 400, 256, 1, 450, 99, 17, 383][:B]
    H = 4
    s = "_int8" if kind == "int8" else ""
    fn = getattr(att, f"flash_decode_attention_paged{s}")
    plain = getattr(att, f"flash_decode_attention_paged{s}_plain")
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    for dh in (16, 18, 48, 80, 128):
        q, poisoned, clean, table = _paged_pools(kind, B, H, dh, page, n_pasts, n_ctx, cuda, seed=dh + B)
        before = fn.launches
        out = fn(q, *poisoned, table, 1, np_, max(n_pasts))
        again = fn(q, *poisoned, table, 1, np_, max(n_pasts))
        ref = plain(q, *clean, table, 1, np_, max(n_pasts))
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert bool(torch.isfinite(out).all()), dh
        assert _rel(out, ref) <= 1e-5, dh
        assert torch.equal(out, again), dh


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_paged_chunk_pass_is_one_kernel_and_no_scratch(cuda, kind):
    """One device kernel a call (a profiler window of four calls) and no
    allocation besides the output."""
    from torch.profiler import ProfilerActivity, profile

    n_pasts = [0, 63, 64, 127, 200, 311, 511, 5]
    q, pools, _, table = _paged_pools(kind, 8, 32, 128, 128, n_pasts, 512, cuda, seed=3)
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    fn = getattr(att, "flash_decode_attention_paged" + ("_int8" if kind == "int8" else ""))
    fn(q, *pools, table, 1, np_, 511)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fn(q, *pools, table, 1, np_, 511)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(ev.count for ev in kernels) == 4, [(ev.key, ev.count) for ev in kernels]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = fn(q, *pools, table, 1, np_, 511)
    assert torch.cuda.memory_allocated() - base == out.numel() * 4 + (-out.numel() * 4) % 512


def test_paged_plan_smem_matches_the_kernel(cuda):
    """ops/attention.paged_plan's shared memory is the launcher's, at every
    cache type and the edges of the split plan."""
    from llama_swift_torch.ops import build

    query = build.lib("flash_decode").flash_decode_paged_smem_bytes
    for kind, elt in ((0, 4), (1, 2), (2, 1)):
        for dh in (2, 16, 18, 48, 80, 128, 256, 1022, 1024):
            for n_keys in (1, 16, 17, 128, 129, 512, 1289, 2048, 8192):
                plan = att.paged_plan(8, 32, dh, elt, 16, n_keys)
                assert query(dh, kind, n_keys, plan.splits, plan.tile) == plan.smem_bytes, (kind, dh, n_keys)
    assert query(128, 0, 512, 9, 32) == 0 and query(128, 0, 512, 8, 0) == 0  # plans the launcher refuses


def test_paged_launcher_refuses_what_it_cannot_run(cuda):
    """The C entry refuses keys beyond the table's pages, a layer out of
    range, an odd head dim and a plan of more than 8 splits or an empty
    tile (the wrapper raises before it for each, or plans none)."""
    from llama_swift_torch.ops import build

    launch = build.lib("flash_decode").flash_decode_paged
    q, pools, _, table = _paged_pools("float32", 2, 4, 128, 16, [20, 3], 64, cuda, seed=1)
    np_ = torch.tensor([20, 3], dtype=torch.int32, device=cuda)
    out = torch.empty((2, 4, 128), device=cuda)
    P, L = pools[0].shape[:2]
    stream = torch.cuda.current_stream().cuda_stream

    def call(il, dh, n_keys, S=2, tile=16):
        return launch(q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(), None, None, table.data_ptr(),
                      np_.data_ptr(), out.data_ptr(), 2, P, L, 4, 16, 4, il, dh, n_keys, S, tile, 0.1, 0, stream)

    assert call(1, 128, 21) == 0
    assert call(1, 128, 65) != 0  # 4 pages of 16 rows hold 64 keys
    assert call(2, 128, 21) != 0
    assert call(1, 127, 21) != 0
    assert call(1, 128, 21, S=9) != 0 and call(1, 128, 21, tile=0) != 0
    with pytest.raises(ValueError):
        att.flash_decode_attention_paged(q, *pools, table, 1, np_, 64)


# in-dims of LLaMA 7B, 13B and 65B (n_ff 11008, 13824, 22016) and the largest taken
F32_MATVEC_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096), (12288, 4096), (22016, 4096),
                     (5120, 13824), (8192, 22016), (64, mv.MAX_F32_IN), (77, 352), (8, 32)]


@pytest.mark.parametrize("out,in_dim", F32_MATVEC_SHAPES)
def test_f32_matvec_at_llama_shapes_repeats_bit_for_bit(cuda, out, in_dim):
    """The Q4_0 f32-activation matvec on its persistent grid within 1e-5 of
    max |y| of its plain version at LLaMA's shapes, one launch a call, a
    second launch bit-equal."""
    w, g = _q4(out, in_dim, cuda, seed=out % 97)
    x = torch.randn(in_dim, device=cuda, generator=g)
    before = mv.q4_0_matvec_f32.launches
    y = mv.q4_0_matvec_f32(x, w)
    again = mv.q4_0_matvec_f32(x, w)
    torch.cuda.synchronize()
    assert mv.q4_0_matvec_f32.launches == before + 2
    assert _rel(y, mv.q4_0_matvec_f32_plain(x, w)) <= 1e-5
    assert torch.equal(y, again)


def test_f32_matvec_sums_in_the_lane_order(cuda):
    """The kernel's sums are ops/q4_matvec.q4_0_matvec_f32_lane_order's
    (lane l's blocks l, l + 32, ... as fused multiply-adds, then the warp
    butterfly), bit for bit, on a row of 5120 (a ragged last lane step) and
    signed powers of two in x and the scales: every block dot is exact,
    and the f64 sums that the order's mirror rounds are exact too, so the
    mirror's bits are the kernel's while each rounded sum of the lanes
    depends on the order."""
    out, in_dim = 300, 4096 + 1024
    w, g = _q4(out, in_dim, cuda, seed=5)
    w = mv.Q4_0Weight(w.qs, 2.0 ** torch.randint(-6, 1, w.d.shape, device=cuda, generator=g).float())
    x = 2.0 ** torch.randint(-8, 8, (in_dim,), device=cuda, generator=g).float()
    x = x * torch.where(torch.rand(in_dim, device=cuda, generator=g) < 0.5, -1.0, 1.0)
    y = mv.q4_0_matvec_f32(x, w)
    torch.cuda.synchronize()
    want = mv.q4_0_matvec_f32_lane_order(x.cpu(), mv.Q4_0Weight(w.qs.cpu(), w.d.cpu()))
    assert torch.equal(y.cpu(), want)


# ---------------------------------------------------------------------------
# the dense batched kernel on the chunk pass (one launch a call, the paged
# kernel's template on each slot's plane) and the Q4_1 f32-activation
# matvec on the persistent grid
# ---------------------------------------------------------------------------


def _batched_planes(kind, B, H, dh, n_pasts, n_ctx, cuda, seed, L=2):
    """(q, poisoned caches, clean caches) [L, B, H, n_ctx, dh] for slots at
    ``n_pasts``: every row beyond a slot's n_past holds NaN in the poisoned
    caches (f32/bf16 rows, int8 row scales), finite values in the clean
    ones; the kernel reads the poisoned caches, the plain version the clean
    ones."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (L, B, H, n_ctx, dh)
    q = torch.randn((B, H, dh), device=cuda, generator=g)
    if kind == "int8":
        k8, ks = _int8(shape, cuda, seed + 1)
        v8, vs = _int8(shape, cuda, seed + 2)
        clean = [k8, v8, ks, vs]
    else:
        clean = [torch.randn(shape, device=cuda, generator=g).to(KINDS[kind]) for _ in range(2)]
    poisoned = [t.clone() for t in clean]
    for t in poisoned:
        if t.dtype != torch.int8:
            for b, n in enumerate(n_pasts):
                t[:, b, :, n + 1 :] = float("nan")
    return q, poisoned, clean


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("n_ctx", [512, 2048])
def test_batched_chunk_pass_at_engine_shapes(cuda, kind, B, n_ctx):
    """The batched kernel at B = 1, 8 and 16, contexts of 512 and 2048 with
    one slot at its last position and one at n_past 0, head dims 16, 18,
    48, 80 and 128 (the plain-load path and the bulk copy), against its
    plain version within 1e-5; every row beyond a slot's n_past is NaN, so
    a read past a slot's live keys shows; a second launch repeats the
    first bit for bit."""
    n_pasts = [n_ctx - 1, 0, 63, 64, 200, 311, n_ctx // 2, 5, 31, 400, 256, 1, 450, 99, 17, 383][:B]
    H = 4
    s = "_int8" if kind == "int8" else ""
    fn = getattr(att, f"flash_decode_attention_batched{s}")
    plain = getattr(att, f"flash_decode_attention_batched{s}_plain")
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    for dh in (16, 18, 48, 80, 128):
        q, poisoned, clean = _batched_planes(kind, B, H, dh, n_pasts, n_ctx, cuda, seed=dh + B)
        before = fn.launches
        out = fn(q, *poisoned, 1, np_, max(n_pasts))
        again = fn(q, *poisoned, 1, np_, max(n_pasts))
        ref = plain(q, *clean, 1, np_, max(n_pasts))
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert bool(torch.isfinite(out).all()), dh
        assert _rel(out, ref) <= 1e-5, dh
        assert torch.equal(out, again), dh


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_batched_chunk_pass_is_one_kernel_and_no_scratch(cuda, kind):
    """One device kernel a call (chip_smoke.launches_per_call: profiler
    windows of four calls, the most any window shows, since a window can
    lose records but never invents one) and no allocation besides the
    output."""
    from chip_smoke import launches_per_call

    n_pasts = [0, 63, 64, 127, 200, 311, 511, 5]
    q, caches, _ = _batched_planes(kind, 8, 32, 128, n_pasts, 512, cuda, seed=3)
    np_ = torch.tensor(n_pasts, dtype=torch.int32, device=cuda)
    fn = getattr(att, "flash_decode_attention_batched" + ("_int8" if kind == "int8" else ""))
    assert launches_per_call(torch, lambda i: fn(q, *caches, 1, np_, 511)) == 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = fn(q, *caches, 1, np_, 511)
    assert torch.cuda.memory_allocated() - base == out.numel() * 4 + (-out.numel() * 4) % 512


def test_batched_plan_smem_matches_the_kernel(cuda):
    """ops/attention.batched_plan's shared memory is the launcher's, at
    every cache type, the edges of the split plan and B 1, 8 and 32 (from 8
    splits down to 1)."""
    from llama_swift_torch.ops import build

    query = build.lib("flash_decode").flash_decode_batched_smem_bytes
    for kind, elt in ((0, 4), (1, 2), (2, 1)):
        for dh in (2, 16, 18, 48, 80, 128, 256, 1022, 1024):
            for n_keys in (1, 16, 17, 128, 129, 512, 1289, 2048, 8192):
                for B in (1, 8, 32):
                    plan = att.batched_plan(B, 32, dh, elt, n_keys)
                    got = query(dh, kind, n_keys, plan.splits, plan.tile)
                    assert got == plan.smem_bytes, (kind, dh, n_keys, B)
    assert query(128, 0, 512, 9, 32) == 0 and query(128, 0, 512, 2, 0) == 0  # plans the launcher refuses
    assert query(17, 0, 512, 2, 32) == -1


def test_batched_launcher_refuses_what_it_cannot_run(cuda):
    """The C entry refuses keys beyond n_ctx, an odd head dim, a plan of
    more than 8 splits, an empty tile or one beyond 227 KB of shared memory
    (the wrapper raises before it for each, or plans none)."""
    from llama_swift_torch.ops import build

    launch = build.lib("flash_decode").flash_decode_batched
    q, caches, _ = _batched_planes("float32", 2, 4, 128, [20, 3], 64, cuda, seed=1)
    np_ = torch.tensor([20, 3], dtype=torch.int32, device=cuda)
    out = torch.empty((2, 4, 128), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(dh, n_keys, S=2, tile=16):
        return launch(q.data_ptr(), caches[0][1].data_ptr(), caches[1][1].data_ptr(), None, None, np_.data_ptr(),
                      out.data_ptr(), 2, 4, 64, dh, n_keys, S, tile, 0.1, 0, stream)

    assert call(128, 21) == 0
    assert call(128, 65) != 0  # n_ctx 64
    assert call(127, 21) != 0
    assert call(128, 21, S=9) != 0 and call(128, 21, tile=0) != 0
    assert call(128, 21, S=1, tile=512) != 0  # a 512-row tile: 0.5 MB of K and V rows
    with pytest.raises(ValueError):
        att.flash_decode_attention_batched(q, *caches, 1, np_, 64)


def _q41_powers_of_two(out, in_dim, cuda, seed):
    """A Q4_1 weight and x whose deltas, mins and elements are signed powers
    of two: every block dot and block sum of x is exact, and so is every
    f64 sum that the lane order's mirror rounds, so its bits are the
    kernel's while each rounded sum of the lanes depends on the order."""
    w, g = _q41(out, in_dim, cuda, seed=seed)
    d = 2.0 ** torch.randint(-6, 1, w.d.shape, device=cuda, generator=g).float()
    m = -(2.0 ** torch.randint(-4, 3, w.d.shape, device=cuda, generator=g).float())
    w = mv.Q4_1Weight(w.qs, torch.stack([d, m], dim=-1).contiguous())
    x = 2.0 ** torch.randint(-8, 8, (in_dim,), device=cuda, generator=g).float()
    return w, x * torch.where(torch.rand(in_dim, device=cuda, generator=g) < 0.5, -1.0, 1.0)


@pytest.mark.parametrize("out,in_dim", F32_MATVEC_SHAPES)
def test_q4_1_f32_matvec_at_llama_shapes_in_the_lane_order(cuda, out, in_dim):
    """The Q4_1 f32-activation matvec on its persistent grid at LLaMA's
    shapes (13B's and 65B's n_ff in-dims, and the largest taken): bit-equal
    to ops/q4_matvec.q4_1_matvec_f32_lane_order (the earlier kernel's sums)
    on power-of-two inputs, within 1e-5 of max |y| of its plain version on
    random ones, one launch a call, a second launch bit-equal."""
    w, x = _q41_powers_of_two(out, in_dim, cuda, seed=out % 89)
    before = mv.q4_1_matvec_f32.launches
    y = mv.q4_1_matvec_f32(x, w)
    again = mv.q4_1_matvec_f32(x, w)
    torch.cuda.synchronize()
    assert mv.q4_1_matvec_f32.launches == before + 2
    assert torch.equal(y, again)
    want = mv.q4_1_matvec_f32_lane_order(x.cpu(), mv.Q4_1Weight(w.qs.cpu(), w.dm.cpu()))
    assert torch.equal(y.cpu(), want)
    w, g = _q41(out, in_dim, cuda, seed=out % 83)
    x = torch.randn(in_dim, device=cuda, generator=g)
    y = mv.q4_1_matvec_f32(x, w)
    assert _rel(y, mv.q4_1_matvec_plain(x, w, quantize_acts=False)) <= 1e-5
    assert torch.equal(y, mv.q4_1_matvec_f32(x, w))


# ---------------------------------------------------------------------------
# the 4-bit-activation matvecs (rows 1 and 5) on the persistent grid: one
# launch a call, no scratch, x's codes quantized in every block
# ---------------------------------------------------------------------------

# LLaMA 7B's four matvec shapes and the fused wqkv and w13, 13B's and 65B's
# n_ff in-dims, odd row counts, in-dim 32 and the largest taken
Q4_MATVEC_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096), (12288, 4096), (22016, 4096),
                    (5120, 13824), (8192, 22016), (77, 352), (1001, 4096), (8, 32), (33, 32), (64, mv.MAX_Q4_IN)]


def _q4_kind(kind, out, in_dim, cuda, seed):
    w, g = (_q41 if kind == "q4_1" else _q4)(out, in_dim, cuda, seed=seed)
    cpu = type(w)(w.qs.cpu(), (w.dm if kind == "q4_1" else w.d).cpu())
    return w, cpu, g


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
@pytest.mark.parametrize("out,in_dim", Q4_MATVEC_SHAPES)
def test_q4_matvec_bit_equal_to_its_lane_order(cuda, kind, out, in_dim):
    """The kernel's results are ops/q4_matvec.<kind>_matvec_lane_order's on
    the CPU bit for bit (the first kernels' sums: exact integer block dots,
    each product and sum rounded once, Q4_1's fused multiply-adds rounded
    once), a second launch bit-equal, one counted launch a call, within
    1e-5 of max |y| of the plain version."""
    w, cpu, g = _q4_kind(kind, out, in_dim, cuda, seed=out % 89)
    x = torch.randn(in_dim, device=cuda, generator=g)
    fn = getattr(mv, f"{kind}_matvec")
    before = fn.launches
    y = fn(x, w)
    again = fn(x, w)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(y, again)
    assert torch.equal(y.cpu(), getattr(mv, f"{kind}_matvec_lane_order")(x.cpu(), cpu))
    assert _rel(y, getattr(mv, f"{kind}_matvec_plain")(x, w)) <= 1e-5


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_q4_matvec_codes_of_ties_and_flat_blocks(cuda, kind):
    """Blocks of exact rounding ties, constant blocks (d_x = 0) and all-zero
    blocks quantize in the kernel as on the CPU: bit-equal to the lane
    order, whose quantizer is the plain one."""
    out, in_dim = 300, 4096
    w, cpu, g = _q4_kind(kind, out, in_dim, cuda, seed=3)
    x = torch.randn(in_dim, device=cuda, generator=g)
    x[:32] = torch.tensor([7.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5] * 4)  # Q4_0: amax 7, d = 1, ties
    x[32:64] = torch.arange(32, dtype=torch.float32) % 15 + 0.5  # Q4_1: min 0.5, max 14.5, ties
    x[32], x[33] = 0.0, 15.0
    x[64:96] = 0.75
    x[96:128] = 0.0
    y = getattr(mv, f"{kind}_matvec")(x, w)
    assert torch.equal(y.cpu(), getattr(mv, f"{kind}_matvec_lane_order")(x.cpu(), cpu))


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_q4_matvec_takes_x_off_16_byte_alignment(cuda, kind):
    """x 4-byte aligned only (a view one element in) takes the kernel's
    scalar loads: the same bits as an aligned copy."""
    w, _, g = _q4_kind(kind, 4096, 4096, cuda, seed=4)
    x = torch.randn(4097, device=cuda, generator=g)[1:]
    assert x.data_ptr() % 16
    fn = getattr(mv, f"{kind}_matvec")
    assert torch.equal(fn(x, w), fn(x.clone(), w))


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_q4_matvec_is_one_kernel_and_no_scratch(cuda, kind):
    """One device kernel a call and no allocation besides the output: one
    call captured into a CUDA graph holds one kernel node
    (chip_smoke.graph_kernels), each call counts one launch, and a
    profiler window of eight calls shows the matvec kernel and no other (no
    pre-pass), never more than eight times (a window in a long process can
    lose a record, seen on the card)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import graph_kernels

    w, _, g = _q4_kind(kind, 11008, 4096, cuda, seed=5)
    x = torch.randn(4096, device=cuda, generator=g)
    fn = getattr(mv, f"{kind}_matvec")
    assert graph_kernels(torch, lambda: fn(x, w)) == 1
    before = fn.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(8):
            fn(x, w)
        torch.cuda.synchronize()
    keys = [(ev.key, ev.count) for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert fn.launches == before + 8
    assert len(keys) == 1 and "q4_matvec_kernel" in keys[0][0] and 1 <= keys[0][1] <= 8, keys
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    y = fn(x, w)
    assert torch.cuda.memory_allocated() - base == y.numel() * 4 + (-y.numel() * 4) % 512


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_q4_matvec_refuses_in_dims_beyond_its_cap(cuda, kind):
    """x's codes beyond a block's shared memory: refused before a launch."""
    w, _, g = _q4_kind(kind, 8, mv.MAX_Q4_IN + 32, cuda, seed=6)
    fn = getattr(mv, f"{kind}_matvec")
    before = fn.launches
    with pytest.raises(ValueError):
        fn(torch.randn(mv.MAX_Q4_IN + 32, device=cuda, generator=g), w)
    assert fn.launches == before


# ---------------------------------------------------------------------------
# causal prefill attention: one launch a layer, live keys only, f32 precision
# ---------------------------------------------------------------------------

PREFILL_TOL = 1e-5  # of max|V| over the live keys; single-pass TF32 misses it (the control below)


def _prefill_inputs(N, n_past, dh, dtype, device, seed, H=2, extra=9):
    """q ``[N, H, dh]`` and planes of ``n_past + N + extra`` keys (the extra
    ones stale, as a cache's rows past the prompt)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_keys = n_past + N + extra
    q = 2.0 * torch.randn((N, H, dh), device=device, generator=g)
    kc = torch.randn((H, n_keys, dh), device=device, generator=g).to(dtype)
    vc = torch.randn((H, n_keys, dh), device=device, generator=g).to(dtype)
    return q, kc, vc


def _prefill_err(out, ref, vc, n_keys):
    return float((out.float() - ref).abs().max()) / float(vc[:, :n_keys].float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 18, 64, 128, 256])
@pytest.mark.parametrize("n_past", [0, 70, 1000])
@pytest.mark.parametrize("N", [1, 17, 64, 100, 2560])
def test_flash_prefill_kernel_matches_plain(cuda, N, n_past, dh, dtype):
    """The kernel within 1e-5 of max|V| of the plain version, one launch,
    ``H · (n_past + N)`` keys counted."""
    q, kc, vc = _prefill_inputs(N, n_past, dh, dtype, cuda, seed=N + n_past + dh)
    before = (att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read)
    out = att.flash_prefill_attention(q, kc, vc, n_past, torch.float32)
    torch.cuda.synchronize()
    assert (att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read) == (
        before[0] + 1, before[1] + 2 * (n_past + N))
    ref = att.flash_prefill_attention_plain(q, kc, vc, n_past, torch.float32)
    assert _prefill_err(out, ref, vc, n_past + N) <= PREFILL_TOL


def test_flash_prefill_tolerance_sees_single_pass_tf32(cuda):
    """The control: at N = 2560 the plain version with TF32 allowed misses
    the bar that the kernel meets, so the bar can tell f32 products from
    TF32 ones."""
    q, kc, vc = _prefill_inputs(2560, 0, 128, torch.float32, cuda, seed=5, H=4)
    ref = att.flash_prefill_attention_plain(q, kc, vc, 0, torch.float32)
    assert _prefill_err(att.flash_prefill_attention(q, kc, vc, 0, torch.float32), ref, vc, 2560) <= PREFILL_TOL
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = att.flash_prefill_attention_plain(q, kc, vc, 0, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _prefill_err(tf32, ref, vc, 2560) > PREFILL_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,n_past,dh", [(1, 0, 128), (17, 0, 18), (100, 70, 64), (2560, 0, 128), (33, 1000, 256)])
def test_flash_prefill_never_reads_past_n_past_plus_n(cuda, N, n_past, dh, dtype):
    """NaN in every key and value at or past n_past + N: the output, bit
    for bit the same."""
    q, kc, vc = _prefill_inputs(N, n_past, dh, dtype, cuda, seed=3, extra=40)
    out = att.flash_prefill_attention(q, kc, vc, n_past, torch.float32)
    kc[:, n_past + N :] = float("nan")
    vc[:, n_past + N :] = float("nan")
    assert torch.equal(att.flash_prefill_attention(q, kc, vc, n_past, torch.float32), out)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
def test_flash_prefill_reads_strided_q_and_writes_compute_dtype(cuda, out_dtype):
    """q as a strided view (the rows of a fused qkv product) in the output's
    dtype, written by the kernel in that dtype."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = torch.randn((100, 3, 4, 128), device=cuda, generator=g).to(out_dtype)
    q = qkv[:, 0]
    _, kc, vc = _prefill_inputs(100, 70, 128, torch.float32, cuda, seed=4, H=4)
    out = att.flash_prefill_attention(q, kc, vc, 70, out_dtype)
    assert out.dtype == out_dtype and out.shape == (100, 4, 128)
    ref = att.flash_prefill_attention_plain(q, kc, vc, 70, torch.float32)
    assert _prefill_err(out, ref, vc, 170) <= 2.0**-8


def test_flash_prefill_plan_smem_matches_the_kernel(cuda):
    from llama_swift_torch.ops import build

    lib = build.lib("flash_prefill")
    for n in (1, 17, 33, 2560):
        for dh in (16, 64, 128, 200, 256):
            for elt, kind in ((4, 0), (2, 1)):
                plan = att.flash_prefill_plan(n, dh, 0, elt)
                assert lib.flash_prefill_smem_bytes(plan.dp, kind, plan.warps) == plan.smem_bytes


def test_flash_prefill_refuses_what_the_kernel_does_not_take(cuda):
    q, kc, vc = _prefill_inputs(8, 0, 128, torch.float32, cuda, seed=2)
    before = att.flash_prefill_attention.launches
    bad = [
        (q, kc.to(torch.int8), vc.to(torch.int8)),  # int8 planes: the model dequantizes them first
        (q, kc, vc.to(torch.bfloat16)),  # two plane types
        (q.cpu(), kc, vc),  # devices differ
        (q.to(torch.int32), kc, vc),
        (q, kc.transpose(1, 2).contiguous().transpose(1, 2), vc),  # a dim stride of n_keys
    ]
    for args in bad:
        with pytest.raises(ValueError):
            att.flash_prefill_attention(*args, 0, torch.float32)
    with pytest.raises(ValueError):
        att.flash_prefill_attention(q, kc, vc, 0, torch.int8)  # an output type the kernel does not write
    q2, k2, v2 = _prefill_inputs(8, 0, 258, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError):
        att.flash_prefill_attention(q2, k2, v2, 0, torch.float32)
    assert att.flash_prefill_attention.launches == before


def test_prefill_forward_one_launch_a_layer_and_agrees_with_cpu(cuda, monkeypatch):
    """A tiny model's prefill and a second chunk at n_past > 0 on the card:
    ``launches`` rises by n_layer and ``keys_read`` by n_layer · H ·
    (n_past + N) a forward, no plain attention runs on the card, and the
    logits agree with the CPU's."""
    from llama_swift_torch.config import ModelConfig
    from llama_swift_torch.models import llama as model_lib

    cfg = ModelConfig.tiny(quantize_activations=False, prefill_bf16=False)
    tensors = model_lib.random_params(cfg, seed=3)
    chunks = [([1, 17, 40, 99, 3, 8, 200, 31, 5, 6], 0), ([77, 12, 9, 250, 4, 4, 60], 10)]

    def run(device):
        params = model_lib.params_from_tensors(tensors, cfg, device=device, param_dtype=torch.float32)
        cache = model_lib.init_cache(cfg, device=device)
        out = []
        for toks, n_past in chunks:
            before = (att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read)
            lg, cache = model_lib.forward(params, torch.tensor(toks, device=device), n_past, cache, cfg)
            if device != "cpu":
                torch.cuda.synchronize()
                assert (att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read) == (
                    before[0] + cfg.n_layer, before[1] + cfg.n_layer * cfg.n_head * (n_past + len(toks)))
            out.append(lg.cpu())
        return out

    cpu = run("cpu")

    def no_plain(*args, **kwargs):
        raise AssertionError("plain attention ran on the card")

    monkeypatch.setattr(att, "flash_prefill_attention_plain", no_plain)
    monkeypatch.setattr(att, "_attention_chunked", no_plain)
    card = run(cuda)
    for c, r in zip(card, cpu):
        assert _rel(c, r) <= 1e-4
