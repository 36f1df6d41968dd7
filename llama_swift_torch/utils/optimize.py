"""Optimizers — parity with ``ggml_opt`` (Adam + L-BFGS,
``Sources/cpp/ggml.c:9752-10421``); the port's counterpart of
``llama_swift_tpu/utils/optimize.py``.

The reference ships full Adam and L-BFGS (with a backtracking line search)
implementations that nothing in the inference product uses.  Here gradients
come from torch autograd, Adam from ``torch.optim.Adam`` (the update of
optax's ``adam``: bias-corrected moments, ``eps`` outside the root) and
L-BFGS from ``torch.optim.LBFGS`` with a strong-Wolfe line search and a
history of ``m`` pairs, one iteration per step, as the JAX package runs
optax's solver.

API mirrors ``ggml_opt(ctx, params, f, x)``: minimize a scalar function
``f(x)`` of a tensor or a list of tensors ``x0`` (``f`` returns a scalar
tensor), returning the result and convergence info; ``x0`` is not modified.
The stopping rules are the JAX package's: Adam stops when the gradient's
global norm falls below ``eps_g`` or f changes by less than ``eps_f``
relative to ``max(1, |f|)``; L-BFGS when the gradient's norm falls below
``eps``.  Defaults follow ``ggml_opt_default_params``
(``ggml.c:10307-10377``): adam lr 1e-3, 100 iters; lbfgs m=6, 100 iters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

Tensors = Union[torch.Tensor, list]


class OptResult:
    def __init__(self, x, fx, n_iters, converged):
        self.x = x
        self.fx = float(fx)
        self.n_iters = int(n_iters)
        self.converged = bool(converged)


@dataclasses.dataclass
class AdamParams:
    """Defaults per ``ggml.c:10318-10341``."""

    n_iter: int = 100
    alpha: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    eps_f: float = 1e-5  # relative function-change convergence test
    eps_g: float = 1e-3  # gradient-norm convergence test


@dataclasses.dataclass
class LBFGSParams:
    """Defaults per ``ggml.c:10343-10373``."""

    n_iter: int = 100
    m: int = 6
    eps: float = 1e-5


class _Problem:
    """``f`` over trainable copies of ``x0``."""

    def __init__(self, f: Callable, x0: Tensors):
        self.f, self.single = f, isinstance(x0, torch.Tensor)
        self.xs = [x.detach().clone().requires_grad_(True) for x in ([x0] if self.single else x0)]

    def value_and_grad_norm(self) -> tuple[torch.Tensor, float]:
        """f at the current x, with its gradient left in ``.grad``."""
        for x in self.xs:
            x.grad = None
        fx = self.f(self.x())
        fx.backward()
        return fx.detach(), float(torch.sqrt(sum((x.grad.double() ** 2).sum() for x in self.xs)))

    def x(self):
        return self.xs[0] if self.single else self.xs

    def result(self, fx, n_iters: int, converged: bool) -> OptResult:
        x = self.xs[0].detach() if self.single else [x.detach() for x in self.xs]
        return OptResult(x, fx, n_iters, converged)

    def final(self, n_iters: int) -> OptResult:
        with torch.no_grad():
            return self.result(float(self.f(self.x())), n_iters, False)


def adam(f: Callable[[Tensors], torch.Tensor], x0: Tensors, params: Optional[AdamParams] = None) -> OptResult:
    p = params or AdamParams()
    prob = _Problem(f, x0)
    opt = torch.optim.Adam(prob.xs, lr=p.alpha, betas=(p.beta1, p.beta2), eps=p.eps)
    fx_prev = None
    for it in range(p.n_iter):
        fx, gnorm = prob.value_and_grad_norm()
        opt.step()
        fx = float(fx)
        if gnorm < p.eps_g:
            return prob.result(fx, it + 1, True)
        if fx_prev is not None and abs(fx - fx_prev) < p.eps_f * max(1.0, abs(fx)):
            return prob.result(fx, it + 1, True)
        fx_prev = fx
    return prob.final(p.n_iter)


def lbfgs(f: Callable[[Tensors], torch.Tensor], x0: Tensors, params: Optional[LBFGSParams] = None) -> OptResult:
    p = params or LBFGSParams()
    prob = _Problem(f, x0)
    opt = torch.optim.LBFGS(prob.xs, lr=1.0, max_iter=1, history_size=p.m, line_search_fn="strong_wolfe",
                            tolerance_grad=0.0, tolerance_change=0.0)

    def closure():
        return prob.value_and_grad_norm()[0]

    for it in range(p.n_iter):
        fx, gnorm = prob.value_and_grad_norm()
        before = [x.detach().clone() for x in prob.xs]
        opt.step(closure)
        if all(torch.equal(a, x) for a, x in zip(before, prob.xs)):
            _full_step(prob.xs, opt.state[prob.xs[0]])
        if gnorm < p.eps:
            return prob.result(float(fx), it + 1, True)
    return prob.final(p.n_iter)


def _full_step(xs: list, state: dict) -> None:
    """Take the quasi-Newton direction's whole step where the strong-Wolfe
    search made none: near the minimum, f changes below its dtype's
    resolution and no trial point shows a decrease, while the gradient can
    still exceed ``eps`` (optax's zoom search accepts such steps by its
    approximate Wolfe conditions).  The step (t = 1) becomes the next
    secant pair."""
    d, offset = state["d"], 0
    with torch.no_grad():
        for x in xs:
            x.add_(d[offset : offset + x.numel()].view_as(x))
            offset += x.numel()
    state["t"] = 1.0


def opt(f, x0, method: str = "adam", **kw) -> OptResult:
    """``ggml_opt`` facade: method ∈ {"adam", "lbfgs"} (``ggml.c:10379-10421``)."""
    if method == "adam":
        return adam(f, x0, AdamParams(**kw) if kw else None)
    if method == "lbfgs":
        return lbfgs(f, x0, LBFGSParams(**kw) if kw else None)
    raise ValueError(f"unknown method {method!r}")
