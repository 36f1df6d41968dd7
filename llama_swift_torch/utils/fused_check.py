"""The one bar that holds the whole-stack kernel
(``ops/fused_layer.fused_layers_block``) to its plain version; ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` both call :func:`fused_case`.

The two run the same arithmetic in another order, so their f32 values
differ by ulps.  Every product takes its activation as 4-bit codes; where an
ulp carries a value across a rounding boundary of the quantizer, one code
flips, that product moves by a quantization step, and everything after it
moves with it (one flip in layer 22 of 32 became 48,561).  So a case passes
where

* x and the new K/V rows agree (``X_BAR``, :func:`kv_rows_ok`), whatever the
  flips; or
* codes flip, and all of these hold:

  - the first flip (in the order the kernel computes) sits at a rounding
    boundary: each flipped value of the first segment that flips, kernel's
    and plain's, lies within ``FLIP_GAP`` of a quantization step of the
    other (:func:`first_flip`).  On a bf16 cache a ctx segment may instead
    follow a new K/V row whose bf16 rounding went the other way in the same
    layer (that row is held by :func:`kv_rows_ok`);
  - the plain arithmetic run on the kernel's own quantizer inputs and its
    own new K/V rows agrees with the kernel everywhere within ``X_BAR``,
    with no flip left to exempt (:func:`forced_check`);

and always the kernel leaves the rows beyond ``n_past`` as they were, and a
second launch on the same inputs repeats the first bit for bit (its trace
too, so the first flip is the same one).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops import attention as att
from ..ops import fused_layer as fl
from ..ops.norms import norm
from ..ops.q4_matvec import q4_0_matvec_plain, quantize_activations_q4_0_int

#: x, each quantizer input and f32 K/V rows: relative to the plain's largest
#: value (the JAX package's fused tests' bar)
X_BAR = 5e-4
#: the most two values that straddle a rounding boundary may differ, in
#: quantization steps, for the flip to count as one of rounding order
FLIP_GAP = 1e-3
#: of a bf16 row's largest |value|: below it, f32 sum noise exceeds an
#: element's bf16 step, so the step is taken at no less than this
BF16_STEP_FLOOR = 2.0**-13
#: the trace's segments of a layer, in the order the kernel computes them
SEGMENTS = ("h", "ctx", "h2", "gate")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def kv_rows_ok(rows) -> tuple:
    """The new K/V rows [(kernel, plain)] of an f32 cache within ``X_BAR``
    of the row's max; of a bf16 cache within one bf16 step (2^-7) of the
    plain's element, the step taken at no less than ``BF16_STEP_FLOOR`` of
    the row's largest value (both rows are rounded from f32 sums whose noise
    scales with that largest value, ~1e-8 of it: an element 1e-6 of the max
    cannot be held to its own step).  Returns (ok, worst element or None)."""
    if rows[0][0].dtype != torch.bfloat16:
        return max(rel_err(a, b) for a, b in rows) <= X_BAR, None
    over = []
    for a, b in rows:
        a, b = a.float(), b.float()
        step = torch.maximum(b.abs(), b.abs().max() * BF16_STEP_FLOOR) * 2.0**-7
        over.append((a - b).abs() - step)
    if all(bool((o <= 0).all()) for o in over):
        return True, None
    which = max(range(len(rows)), key=lambda i: float(over[i].max()))
    idx = int(over[which].argmax())
    a, b = rows[which]
    return False, {"kv": "kv"[which], "index": idx, "card": float(a.flatten()[idx]),
                   "plain": float(b.flatten()[idx]), "max_abs_plain": float(b.abs().max())}


def _steps(tr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes of a trace ``[L, n]`` and each value in quantization steps of
    its 32-block (the quantizer's x * (1 / d), before it rounds half away
    from zero: the boundaries are the half-integers)."""
    codes, d = quantize_activations_q4_0_int(tr)
    d = d.repeat_interleave(tr.shape[-1] // d.shape[-1], dim=-1)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    return codes, tr.float() * inv


def first_flip(tr_k: torch.Tensor, tr_p: torch.Tensor, D: int) -> Optional[dict]:
    """The first segment (layer-major, ``SEGMENTS`` order) whose 4-bit codes
    differ between the kernel's trace and the plain's (``[L, 3D + F]``), or
    None: its layer and name, its flipped elements, the first of them with
    both values and both in steps beside the boundary between them, and
    ``gap``, the largest step difference over its flipped elements."""
    ck, uk = _steps(tr_k)
    cp, up = _steps(tr_p)
    bounds = [0, D, 2 * D, 3 * D, tr_p.shape[1]]
    for il in range(tr_p.shape[0]):
        for sg, name in enumerate(SEGMENTS):
            lo, hi = bounds[sg], bounds[sg + 1]
            idx = (ck[il, lo:hi] != cp[il, lo:hi]).nonzero().flatten()
            if len(idx):
                i = int(idx[0]) + lo
                a, b = float(uk[il, i]), float(up[il, i])
                return {"layer": il, "segment": name, "flipped": len(idx), "index": i - lo,
                        "card": float(tr_k[il, i]), "plain": float(tr_p[il, i]), "card_steps": a,
                        "plain_steps": b, "boundary": math.floor((a + b) / 2) + 0.5,
                        "gap": float((uk[il, lo:hi] - up[il, lo:hi]).abs()[idx].max())}
    return None


def count_flips(tr_k: torch.Tensor, tr_p: torch.Tensor) -> int:
    return int((quantize_activations_q4_0_int(tr_k)[0] != quantize_activations_q4_0_int(tr_p)[0]).sum())


def forced_check(x, norms, weights, kc, vc, n_past: int, trace, out) -> dict:
    """The plain whole-stack arithmetic on the kernel's own quantizer inputs
    (its trace) and its own new K/V rows (``kc``/``vc``: the caches after the
    kernel's launch, only read): every product takes the codes the kernel
    took and attention the rows it wrote, so no flip and no bf16 rounding
    separates the two.  Each quantizer input the plain computes (norms, ctx,
    gate) and the final x are held to the kernel's within ``X_BAR``; the
    new K/V rows the plain computes, rounded to the cache dtype, to the
    kernel's by :func:`kv_rows_ok`."""
    (an, fn), (wqkv, wo, w13, w2) = norms, weights
    L, H = an.shape[0], kc.shape[1]
    D, F, dh = H * fl.HEAD_DIM, w2.shape[1], fl.HEAD_DIM
    tr = trace.to(x.device)
    cos, sin_s = fl.rope_vectors(n_past, dh, x.device)
    xp = x.float().clone()
    kv_plain = (torch.empty_like(kc[:, :, n_past]), torch.empty_like(vc[:, :, n_past]))
    errs = {name: 0.0 for name in SEGMENTS}
    for il in range(L):
        h_k, ctx_k, h2_k, gate_k = tr[il, :D], tr[il, D:2 * D], tr[il, 2 * D:3 * D], tr[il, 3 * D:]
        errs["h"] = max(errs["h"], rel_err(h_k, norm(xp, an[il], "layernorm", 1e-5)))
        qkv = q4_0_matvec_plain(h_k, wqkv.layer(il))
        q = fl._rope_rows(qkv[:D].reshape(H, dh), cos, sin_s)
        kv_plain[0][il] = fl._rope_rows(qkv[D:2 * D].reshape(H, dh), cos, sin_s).to(kc.dtype)
        kv_plain[1][il] = qkv[2 * D:].reshape(H, dh).to(vc.dtype)
        ctx = att.flash_decode_attention_plain(q, kc, vc, il, n_past).reshape(D)
        errs["ctx"] = max(errs["ctx"], rel_err(ctx_k, ctx))
        xp = xp + q4_0_matvec_plain(ctx_k, wo.layer(il))
        errs["h2"] = max(errs["h2"], rel_err(h2_k, norm(xp, fn[il], "layernorm", 1e-5)))
        g13 = q4_0_matvec_plain(h2_k, w13.layer(il))
        g1, g3 = g13[:F], g13[F:]
        errs["gate"] = max(errs["gate"], rel_err(gate_k, g1 / (1.0 + torch.exp(-g1)) * g3))
        xp = xp + q4_0_matvec_plain(gate_k, w2.layer(il))
    kv_ok, worst = kv_rows_ok([(kc[:, :, n_past], kv_plain[0]), (vc[:, :, n_past], kv_plain[1])])
    err_x = rel_err(out, xp)
    return {"x_rel_err": err_x, "inputs_rel_err": errs, "kv_new_ok": kv_ok, **({"kv_worst": worst} if worst else {}),
            "ok": err_x <= X_BAR and max(errs.values()) <= X_BAR and kv_ok}


def fused_case(x, norms, weights, kc, vc, n_past: int, kernel: Optional[Callable] = None) -> dict:
    """The whole-stack kernel (``kernel``, by default
    ``fl.fused_layers_block``) and its plain version on copies of one cache
    state ``kc``/``vc`` (the kernel's run is left in them), held to the bar
    of this module.  ``norms`` = (attn, ffn) ``[L, D]``, ``weights`` =
    (wqkv, wo, w13, w2).  Returns the record: errors of x and of the new
    K/V rows, the flips, the first flip, the repeat, the forced run where
    codes flip, and ``ok``."""
    kernel = kernel or fl.fused_layers_block
    kp, vp = kc.clone(), vc.clone()  # the plain's run
    kr, vr = kc.clone(), vc.clone()  # the kernel's second run
    tr_k, tr_p, tr_r = [], [], []
    out = kernel(x, *norms, *weights, kc, vc, n_past, trace=tr_k)
    again = kernel(x, *norms, *weights, kr, vr, n_past, trace=tr_r)
    ref = fl.fused_layers_block_plain(x, *norms, *weights, kp, vp, n_past, trace=tr_p)
    repeats = bool(torch.equal(out, again) and torch.equal(tr_k[0], tr_r[0]) and torch.equal(kc, kr)
                   and torch.equal(vc, vr))
    del kr, vr
    stale_kept = bool(torch.equal(kc[:, :, n_past + 1:], kp[:, :, n_past + 1:])
                      and torch.equal(vc[:, :, n_past + 1:], vp[:, :, n_past + 1:]))
    flips = count_flips(tr_k[0], tr_p[0])
    rows = [(a[:, :, n_past], b[:, :, n_past]) for a, b in ((kc, kp), (vc, vp))]
    kv_ok, worst = kv_rows_ok(rows)
    err = rel_err(out, ref)
    finite = bool(torch.isfinite(out).all())
    rec = {"max_rel_err": err, "max_abs_err": float((out - ref).abs().max()),
           "kv_new_rel_err": max(rel_err(a, b) for a, b in rows), "kv_new_ok": kv_ok, "q4_flips": flips,
           "repeats_bit_for_bit": repeats, "stale_rows_kept": stale_kept, **({"kv_worst": worst} if worst else {})}
    agrees = err <= X_BAR and kv_ok
    if flips:
        D = kc.shape[1] * fl.HEAD_DIM
        ff = first_flip(tr_k[0], tr_p[0], D)
        il = ff["layer"]
        ff["kv_rows_differ"] = bool(not torch.equal(kc[il, :, n_past], kp[il, :, n_past])
                                    or not torch.equal(vc[il, :, n_past], vp[il, :, n_past]))
        ff["at_boundary"] = ff["gap"] <= FLIP_GAP or (
            kc.dtype == torch.bfloat16 and ff["segment"] == "ctx" and ff["kv_rows_differ"])
        rec["first_flip"] = ff
        rec["forced"] = forced_check(x, norms, weights, kc, vc, n_past, tr_k[0], out)
        agrees = agrees or (ff["at_boundary"] and rec["forced"]["ok"])
    rec["ok"] = finite and stale_kept and repeats and agrees
    return rec
