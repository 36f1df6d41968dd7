"""ggml op-set compatibility layer: the reference's graph ops
(``Sources/cpp/ggml.h:212-253``, constructors ``ggml.c:3011-4188``) as torch
functions with the semantics of ``llama_swift_tpu/ops/ggml_compat.py``.

The model code uses idiomatic torch directly; this module exists for
capability parity (every op a ggml user could call has an equivalent) and
for porting ggml-built graphs.  ggml constructs a graph lazily; here each
function runs eagerly (``ggml_build_forward_expand`` + ``ggml_graph_compute``
have no counterpart: call the composition).

Axis convention: ggml ``ne[4]`` lists dims fastest-first; torch shapes are
the reverse.  2-D ggml tensors ``ne=(in, out)`` are torch ``[out, in]``.
``mul_mat(a, b) = b @ a.T`` (``ggml.c:3623-3646``: result[i,j] = dot of row i
of a with row j of b).

Autodiff: the reference's backward pass is half-implemented and aborts on
gelu/silu/norm/mul_mat/rope (``ggml.c:8702-8804`` GGML_ASSERT TODOs); every
op here is differentiable by torch autograd.  No op reaches a kernel of the
port but ``get_rows`` of a packed table (``embedding_lookup``), so none
needs an ``autograd.Function``.

Products are f32: matrix products in full f32 (PyTorch's default,
``allow_tf32`` off), and the convolutions as an unfold and a product, not
through cuDNN, which would take TF32 on the card by default.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .norms import ggml_norm as _ggml_norm
from .rope import rope as _rope_insert

# ---------------------------------------------------------------------------
# elementwise / unary (forward kernels ggml.c:4190-5326)
# ---------------------------------------------------------------------------


def dup(a):
    return a.clone()


add = torch.add
sub = torch.sub
mul = torch.mul
div = torch.div
sqrt = torch.sqrt
abs = torch.abs  # noqa: A001 - mirrors ggml_abs
sgn = torch.sign
neg = torch.neg
relu = torch.relu


def sqr(a):
    return a * a


def step(a):
    """ggml_step: x > 0 ? 1 : 0 (``ggml.c:4920-4971``)."""
    return (a > 0).to(a.dtype)


def gelu(a):
    """ggml's gelu is the tanh approximation evaluated through a 64K fp16
    LUT (``ggml.c:1915-1945``); the exact tanh form here, as in JAX."""
    return F.gelu(a, approximate="tanh")


def silu(a):
    return F.silu(a)


# ---------------------------------------------------------------------------
# reductions / shape ops
# ---------------------------------------------------------------------------


def sum(a):  # noqa: A001
    """ggml_sum returns a 1-element tensor (``ggml.c:3377``)."""
    return a.sum().reshape(1)


def mean(a):
    """ggml_mean: mean over the fastest dim, per row (``ggml.c:3397``)."""
    return a.mean(dim=-1, keepdim=True)


def repeat(a, b):
    """ggml_repeat(a, like=b): tile a up to b's shape (``ggml.c:3268``);
    used to broadcast 1-D norm weights over rows."""
    return torch.broadcast_to(a, tuple(b.shape))


def norm(a, eps: float = 1e-5):
    """ggml_norm WITHOUT the weight multiply (the graph multiplies
    separately, ``LlamaPredictOperation.mm:571-575``)."""
    return _ggml_norm(a, torch.ones(a.shape[-1], dtype=a.dtype, device=a.device), eps)


def mul_mat(a, b):
    """result = b @ a.T — ggml's row-dot convention (``ggml.c:3623-3646``)."""
    return torch.matmul(b, a.transpose(-1, -2))


def scale(a, s):
    return a * s


def cpy(a, _like=None):
    return a.clone()


def reshape(a, shape):
    return torch.reshape(a, tuple(shape))


reshape_2d = reshape_3d = reshape


def view(a, shape, offset_elems: int = 0):
    """ggml_view_1d/2d over a contiguous buffer (``ggml.c:3740-3800``).  An
    offset that would run past the buffer is clamped so that the view fits,
    as ``lax.dynamic_slice`` clamps it in the JAX package."""
    flat = a.reshape(-1)
    n = math.prod(shape)
    off = min(max(int(offset_elems), 0), flat.numel() - n)
    return flat[off : off + n].reshape(tuple(shape))


def permute(a, *axes):
    """ggml_permute takes ggml-axis order; for torch tensors give the
    permutation of torch axes directly (none: reverse them)."""
    return a.permute(*axes) if axes else transpose(a)


def transpose(a, axes=None):
    """``jnp.transpose``: reverse the axes, or permute them by ``axes``."""
    return a.permute(*(axes if axes is not None else reversed(range(a.dim()))))


def get_rows(a, ids):
    """Row gather, dequantizing when a is packed (``ggml.c:6760-6920``)."""
    from .quantized_matmul import embedding_lookup

    w = a.qs if hasattr(a, "qs") else a
    return embedding_lookup(torch.as_tensor(ids, dtype=torch.int64, device=w.device), a)


def diag_mask_inf(a, n_past: int):
    """Mask entries above the shifted diagonal with -inf
    (``ggml.c:6921-6981``): for a [..., N, M] score tensor, entry (i, j) with
    j > n_past + i becomes -inf."""
    N, M = a.shape[-2], a.shape[-1]
    i = torch.arange(N, device=a.device)[:, None]
    j = torch.arange(M, device=a.device)[None, :]
    return a.masked_fill(j > n_past + i, float("-inf"))


def soft_max(a):
    """Max-subtracted softmax over the fastest dim; -inf → 0
    (``ggml.c:6982-7050``; exact exp instead of the fp16 LUT).  A row with no
    finite entry gives NaN, as in JAX."""
    finite = torch.isfinite(a)
    m = torch.where(finite, a, float("-inf")).amax(dim=-1, keepdim=True)
    e = torch.where(finite, torch.exp(a - m), 0.0)
    return e / e.sum(dim=-1, keepdim=True)


def rope(a, n_past: int, n_dims: int, mode: int):
    """Adjacent-pair rotary embedding (``ggml.c:7076-7131``).

    a: [N, H, D] (positions on the leading axis, matching the ggml 3-D
    layout ne=(D, H, N)).  mode 0: all N positions rotated with
    p = n_past + i.  mode 1: only positions i >= n_past are rotated
    (p = i), the rest pass through unchanged — the in-place cache-view
    behavior (see ops/rope.py).
    """
    N = a.shape[0]
    pos = torch.arange(N, device=a.device)
    if mode == 0:
        return _rope_insert(a, n_past + pos, n_dims)
    rotated = _rope_insert(a, pos, n_dims)
    return torch.where((pos < n_past).reshape(N, 1, 1), a, rotated)


def _conv_1d_same(a, b, stride: int):
    """XLA's ``padding="SAME"`` cross-correlation of b [IC, T] with kernels
    a [OC, IC, K] → [OC, ceil(T/stride)]: ``pad_total = max((out−1)·stride
    + K − T, 0)``, ``pad_total // 2`` on the left (asymmetric at stride 2,
    which ``F.conv1d(padding="same")`` refuses)."""
    K, T = a.shape[-1], b.shape[-1]
    n_out = -(-T // stride)
    pad = max((n_out - 1) * stride + K - T, 0)
    cols = F.pad(b, (pad // 2, pad - pad // 2)).unfold(-1, K, stride)  # [IC, out, K]
    return torch.einsum("itk,oik->ot", cols, a)


def conv_1d_1s(a, b):
    """Stride-1 'same' 1-D convolution (whisper leftover, ``ggml.c:4060``).
    a: kernels [OC, IC, K], b: signal [IC, T] → [OC, T]."""
    return _conv_1d_same(a, b, 1)


def conv_1d_2s(a, b):
    """Stride-2 variant (``ggml.c:4088``) → [OC, ceil(T/2)]."""
    return _conv_1d_same(a, b, 2)


def flash_attn(q, k, v, masked: bool):
    """Fused attention (``ggml.c:7753-8237`` — implemented there but unused
    by the llama path).  q,k,v: [N|M, H, D] position-major; returns [N, H, D].
    """
    N, H, D = q.shape
    M = k.shape[0]
    scores = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(D)
    if masked:
        scores = diag_mask_inf(scores, M - N)
    return torch.einsum("hnm,mhd->nhd", soft_max(scores), v)


def flash_ff(x, w1, b1, w2, b2):
    """Fused feed-forward with gelu (``ggml.c:8238-8448``)."""
    h = gelu(mul_mat(w1, x) + b1)
    return mul_mat(w2, h) + b2


def set_param(x):
    """ggml_set_param marks a tensor trainable (``ggml.c:4179-4188``): the
    same tensor, with ``requires_grad`` set (JAX differentiates by position
    and returns it as is)."""
    return x.requires_grad_(True)
