"""The plain reference of a LLaMA-family model on Q4_0 weights: plain
PyTorch in f32 with TF32 off, no kernel, no cache, no batching.  It imports
neither the port (``llama_swift_torch``) nor JAX nor the JAX package.

The arithmetic is the configuration's: every product quantizes its
activation rows to 4-bit codes (GGML's Q4_0 activation quantizer: a block
of 32 takes ``d = amax/7``, codes ``trunc(x/d ± ½)``) and multiplies them by
the Q4_0 weights; RMSNorm, GGML's adjacent-pair RoPE at base 10000, causal
softmax attention with full multi-head K/V, SwiGLU, no biases.  Where the
configuration states ``prefill_bf16``, the rows that only a prefill
computes (positions before the prompt's last) take their products on
bf16-rounded operands, as the port's prefill does on the card; every other
row, and every decode row, is f32.

``dtype=torch.float64`` computes the same model in float64 throughout
(bf16-rounded operands where a prefill's are): a second sound path, whose
roundings differ from the f32 reference's at every operation, as a sound
port's do; the 4-bit codes make the model chaotic under rounding (see
``benchmark/check.py``).  ``dtype=torch.bfloat16`` computes the same model
in bf16 (weights,
activations, the residual stream, K/V and products): the control of
``correct``, which a sound run has to beat.

The weights are made again from the seed (``benchmark/weights.py``), one
layer at a time, so that the reference fits beside nothing of the port's.
"""

from __future__ import annotations

import math

import torch

from .. import weights
from ..counts import llama as counts

QK = 32


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the reference computes in: f32, or f64 as it is."""
    return x if x.dtype == torch.float64 else x.float()


def dequantize(qs: torch.Tensor, d: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dense ``[out, in]`` of Q4_0 codes and scales: ``(n − 8)·d`` in
    ``dtype``, the even element from the low nibble."""
    out = qs.shape[0]
    n = torch.stack([qs & 0xF, qs >> 4], dim=-1).reshape(out, -1, QK).to(dtype) - 8.0
    return (n * d.to(dtype)[:, :, None]).reshape(out, -1)


def quantize_acts(x: torch.Tensor) -> torch.Tensor:
    """x ``[..., k]`` through 4-bit codes and back, in f32 (f64 for f64 x):
    per block of 32, ``d = amax/7``, ``q = trunc(x/d + ½·sign)``, value
    ``q·d``."""
    xb = _wide(x).reshape(*x.shape[:-1], x.shape[-1] // QK, QK)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    d = amax / torch.full_like(amax, 7.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    q = torch.trunc(xb * inv + torch.where(xb >= 0, 0.5, -0.5))
    return (q * d).reshape(x.shape)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = _wide(x)
    return (xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """x ``[T, H, Dh]`` at positions 0..T-1: pairs (2j, 2j+1) rotated by
    ``p·base^(−2j/Dh)``."""
    T, _, Dh = x.shape
    f = _wide(x).dtype
    inv = torch.pow(torch.tensor(base, dtype=f, device=x.device),
                    -torch.arange(0, Dh, 2, dtype=f, device=x.device) / float(Dh))
    ang = (torch.arange(T, dtype=f, device=x.device)[:, None] * inv[None, :])[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x0, x1 = _wide(x[..., 0::2]), _wide(x[..., 1::2])
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape).to(x.dtype)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal softmax attention of ``[T, H, Dh]`` rows; row i sees keys
    ``j <= i``.  Scores and softmax in f32 (f64 for f64 rows); query rows
    in blocks."""
    T, H, Dh = q.shape
    kt, vt = k.transpose(0, 1), v.transpose(0, 1)  # [H, T, Dh]
    out = []
    for r0 in range(0, T, block):
        qb = q[r0 : r0 + block].transpose(0, 1)  # [H, n, Dh]
        s = _wide(torch.matmul(qb, kt.transpose(1, 2))) / math.sqrt(Dh)
        rows = torch.arange(r0, r0 + qb.shape[1], device=q.device)[:, None]
        s = s.masked_fill(torch.arange(T, device=q.device)[None, :] > rows, float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out.append(torch.matmul(p, vt).transpose(0, 1))
    return torch.cat(out)


class Sequence:
    """One request as the reference sees it: ``tokens`` (the prompt, then
    the served tokens but the last), ``first`` the row whose logits chose the
    first served token (the prompt's last position), and ``prefill_rows``
    rows computed by a prefill alone."""

    def __init__(self, tokens, first: int, prefill_rows: int):
        self.tokens, self.first, self.prefill_rows = list(tokens), first, prefill_rows


class Reference:
    def __init__(self, cfg: dict, seed: int, device, dtype=torch.float32, prefill_bf16: bool = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.device, self.dtype = cfg, seed, torch.device(device), dtype
        p = cfg["port"]
        self.dims = counts.dims(cfg)
        self.eps, self.base = float(p["norm_eps"]), float(p["rope_base"])
        self.prefill_bf16 = p["prefill_bf16"] if prefill_bf16 is None else prefill_bf16
        self.specs = {t.name: t for t in counts.tensors(self.dims)}

    def _make(self, name: str, layer: int = 0):
        w = weights.make(self.seed, self.specs[name], layer, self.device)
        wide = torch.float64 if self.dtype == torch.float64 else torch.float32
        return w.to(wide) if isinstance(w, torch.Tensor) else dequantize(*w, dtype=wide)

    def _linear(self, x, w, split: int):
        """``x @ w.T`` on 4-bit activation codes; rows below ``split`` on
        bf16-rounded operands when the prefill's products are bf16."""
        xq = quantize_acts(x)
        if self.dtype == torch.bfloat16:
            return torch.matmul(xq.to(self.dtype), w.to(self.dtype).t())
        if split <= 0 or not self.prefill_bf16:
            return torch.matmul(xq, w.t())
        wb = w.to(torch.bfloat16).to(w.dtype)
        return torch.cat([torch.matmul(xq[:split].to(torch.bfloat16).to(w.dtype), wb.t()),
                          torch.matmul(xq[split:], w.t())])

    def _layer(self, x, ws: dict, split: int):
        d = self.dims
        T = x.shape[0]
        h = rms_norm(x, ws["attention_norm"], self.eps)
        qkv = self._linear(h, ws["wqkv"], split)
        q, k, v = (qkv[:, i * d.D : (i + 1) * d.D].reshape(T, d.H, d.Dh) for i in range(3))
        ctx = attention(rope(q, self.base), rope(k, self.base), v).reshape(T, d.D)
        x = x + self._linear(ctx, ws["wo"], split)
        h2 = rms_norm(x, ws["ffn_norm"], self.eps)
        g1, g3 = _wide(self._linear(h2, ws["w13"], split)).chunk(2, dim=-1)
        gate = (g1 / (1.0 + torch.exp(-g1)) * g3).to(x.dtype)
        return x + self._linear(gate, ws["w2"], split)

    def logits(self, seqs: list):
        """Yields, for each sequence, logits ``[T − first, V]`` f32 of its rows
        ``first..T-1``, all layers computed one at a time over all sequences."""
        emb = self._make("tok_embeddings")
        xs = [emb[torch.as_tensor(s.tokens, device=self.device)].to(self.dtype) for s in seqs]
        del emb
        for il in range(self.dims.L):
            ws = {n: self._make(n, il) for n in ("attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")}
            xs = [self._layer(x, ws, s.prefill_rows) for x, s in zip(xs, seqs)]
            del ws
        norm, out = self._make("norm"), self._make("output")
        for x, s in zip(xs, seqs):
            h = rms_norm(x[s.first :], norm, self.eps)
            yield _wide(self._linear(h, out, 0))
