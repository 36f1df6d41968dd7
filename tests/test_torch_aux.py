"""The port's auxiliary modules against the JAX package's, on the CPU:
llama_swift_torch/ops/ggml_compat.py (every ggml op, inputs from numpy seeds,
within 1e-6 absolute / 1e-5 relative: the same f32 arithmetic in other
orders; NaN where JAX gives NaN), gradients through the ops the reference's
backward aborts on (torch autograd against ``jax.grad``, 1e-5),
llama_swift_torch/utils/optimize.py (Adam on the JAX test's quadratic, and
its 50-step trajectory against optax's; L-BFGS) and
llama_swift_torch/utils/profiling.py (``graph_summary``, ``dump_hlo``,
``trace``; its spans: test_torch_spans.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops import ggml_compat as jg
from llama_swift_tpu.utils.optimize import opt as jax_opt
from llama_swift_torch.ops import ggml_compat as tg
from llama_swift_torch.ops.q4_matvec import Q4_0Weight
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.utils import profiling
from llama_swift_torch.utils.optimize import opt

ATOL, RTOL = 1e-6, 1e-5
GRAD_BAR = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(seed, shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _masked_scores():
    s = _f32(7, (2, 3, 5))
    i, j = np.mgrid[0:3, 0:5]
    s[:, j > 1 + i] = -np.inf  # diag_mask_inf(s, 1)
    s[1, 0, :] = -np.inf  # a row with no finite entry: NaN in both
    return s


_TABLE = Q4_0Tensor.quantize(_f32(8, (10, 64)))

# name: (ggml op name, numpy args, extra python args)
CASES = {
    "dup": ("dup", [_f32(0, (3, 5))], ()),
    "add": ("add", [_f32(0, (3, 5)), _f32(1, (3, 5))], ()),
    "sub": ("sub", [_f32(0, (3, 5)), _f32(1, (3, 5))], ()),
    "mul": ("mul", [_f32(0, (3, 5)), _f32(1, (3, 5))], ()),
    "div": ("div", [_f32(0, (3, 5)), np.abs(_f32(1, (3, 5))) + 0.5], ()),
    "sqr": ("sqr", [_f32(0, (3, 5))], ()),
    "sqrt": ("sqrt", [np.abs(_f32(0, (3, 5)))], ()),
    "abs": ("abs", [_f32(0, (3, 5))], ()),
    "sgn": ("sgn", [np.r_[_f32(0, (5,)), 0.0].astype(np.float32)], ()),
    "neg": ("neg", [_f32(0, (3, 5))], ()),
    "step": ("step", [np.r_[_f32(0, (5,)), 0.0].astype(np.float32)], ()),
    "relu": ("relu", [_f32(0, (3, 5))], ()),
    "gelu": ("gelu", [_f32(0, (3, 5)) * 3], ()),
    "silu": ("silu", [_f32(0, (3, 5)) * 3], ()),
    "sum": ("sum", [_f32(0, (3, 5))], ()),
    "mean": ("mean", [_f32(0, (3, 5))], ()),
    "repeat": ("repeat", [_f32(0, (5,)), _f32(1, (3, 5))], ()),
    "norm": ("norm", [_f32(0, (3, 16)) * 2 + 1], ()),
    "mul_mat": ("mul_mat", [_f32(0, (4, 8)), _f32(1, (3, 8))], ()),
    "scale": ("scale", [_f32(0, (3, 5))], (0.37,)),
    "cpy": ("cpy", [_f32(0, (3, 5))], ()),
    "reshape": ("reshape", [_f32(0, (3, 4))], ((4, 3),)),
    "reshape_2d": ("reshape_2d", [_f32(0, (3, 4))], ((2, 6),)),
    "reshape_3d": ("reshape_3d", [_f32(0, (3, 4))], ((2, 2, 3),)),
    "view": ("view", [_f32(0, (4, 6))], ((2, 5), 7)),
    "view_clamped": ("view", [_f32(0, (4, 6))], ((2, 5), 100)),
    "permute": ("permute", [_f32(0, (2, 3, 4))], (2, 0, 1)),
    "permute_reversed": ("permute", [_f32(0, (2, 3, 4))], ()),
    "transpose": ("transpose", [_f32(0, (2, 3, 4))], ()),
    "get_rows": ("get_rows", [_f32(0, (10, 8))], ([3, 0, 9, 3],)),
    "get_rows_q4_0": ("get_rows", [_TABLE], ([3, 0, 9, 3],)),
    "diag_mask_inf": ("diag_mask_inf", [_f32(0, (2, 3, 5))], (1,)),
    "soft_max": ("soft_max", [_masked_scores()], ()),
    "rope_mode0": ("rope", [_f32(0, (6, 2, 8))], (3, 8, 0)),
    "rope_mode1": ("rope", [_f32(0, (6, 2, 8))], (4, 8, 1)),
    "rope_partial": ("rope", [_f32(0, (6, 2, 8))], (2, 4, 0)),
    "conv_1d_1s": ("conv_1d_1s", [_f32(0, (4, 3, 3)), _f32(1, (3, 10))], ()),
    "conv_1d_1s_even_k": ("conv_1d_1s", [_f32(0, (4, 3, 4)), _f32(1, (3, 9))], ()),
    "conv_1d_2s_even_t": ("conv_1d_2s", [_f32(0, (4, 3, 3)), _f32(1, (3, 10))], ()),
    "conv_1d_2s_odd_t": ("conv_1d_2s", [_f32(0, (4, 3, 3)), _f32(1, (3, 9))], ()),
    "conv_1d_2s_even_k": ("conv_1d_2s", [_f32(0, (4, 3, 4)), _f32(1, (3, 11))], ()),
    "flash_attn": ("flash_attn", [_f32(0, (3, 2, 8)), _f32(1, (5, 2, 8)), _f32(2, (5, 2, 8))], (False,)),
    "flash_attn_masked": ("flash_attn", [_f32(0, (3, 2, 8)), _f32(1, (5, 2, 8)), _f32(2, (5, 2, 8))], (True,)),
    "flash_ff": ("flash_ff", [_f32(0, (3, 8)), _f32(1, (16, 8)), _f32(2, (16,)), _f32(3, (8, 16)),
                              _f32(4, (8,))], ()),
    "set_param": ("set_param", [_f32(0, (3, 5))], ()),
}


def _to_torch(a):
    if isinstance(a, Q4_0Tensor):
        return Q4_0Weight.from_q4_0(TQ4_0Tensor(a.scales, a.qs))
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_ggml_op_matches_jax(case):
    op, args, extra = CASES[case]
    want = np.asarray(getattr(jg, op)(*[a if isinstance(a, Q4_0Tensor) else jnp.asarray(a) for a in args], *extra))
    got = getattr(tg, op)(*map(_to_torch, args), *extra).detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    if case == "soft_max":
        assert np.isnan(got[1, 0]).all()


def test_every_jax_op_has_a_port():
    public = {n for n in dir(jg) if not n.startswith("_") and callable(getattr(jg, n))
              and getattr(getattr(jg, n), "__module__", "").startswith(("llama_swift_tpu.ops.ggml", "jax"))}
    public -= {"annotations"}
    assert public <= {n for n in dir(tg) if not n.startswith("_")}
    assert public <= {op for op, _, _ in CASES.values()}


def _loss(g, lib, w):
    """The JAX test's loss through gelu/silu/norm/mul_mat/rope."""
    x = lib.ones((2, 8))
    h = g.silu(g.mul_mat(w, x))
    h = g.norm(h)
    r = g.rope(h.reshape(2, 1, 4), 0, 4, 0)
    return (g.gelu(r) ** 2).sum()


def test_gradients_match_jax():
    w = _f32(3, (4, 8))
    want = np.asarray(jax.grad(lambda v: _loss(jg, jnp, v))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    _loss(tg, torch, wt).backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=GRAD_BAR, atol=GRAD_BAR)


def test_conv_1d_2s_pads_as_xla_same():
    """XLA's SAME at stride 2: ceil(T/2) outputs, the odd pad on the right."""
    a, b = torch.ones(1, 1, 3), torch.arange(1.0, 11.0)[None]  # T = 10: pad 1, left 0, right 1
    out = tg.conv_1d_2s(a, b)
    np.testing.assert_array_equal(out.numpy(), [[6, 12, 18, 24, 19]])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

TARGET = [1.0, -2.0, 3.0]


def test_adam_converges_on_the_jax_quadratic():
    t = torch.tensor(TARGET)
    x0 = torch.zeros(3)
    res = opt(lambda x: ((x - t) ** 2).sum(), x0, method="adam", n_iter=500, alpha=0.05)
    np.testing.assert_allclose(res.x.numpy(), TARGET, atol=0.05)
    assert res.converged and not x0.any()


def test_adam_trajectory_matches_optax():
    """50 steps without stopping; the updates are optax's, rounded in
    another order (f32 bias corrections there, f64 here), which drifts by
    ~1e-5 absolute on values up to 3: held relative to max |x|."""
    kw = dict(method="adam", n_iter=50, alpha=0.05, eps_f=0.0, eps_g=0.0)
    tj, t = jnp.asarray(TARGET), torch.tensor(TARGET)
    want = jax_opt(lambda x: jnp.sum((x - tj) ** 2), jnp.zeros(3), **kw)
    got = opt(lambda x: ((x - t) ** 2).sum(), torch.zeros(3), **kw)
    ref = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-5
    assert got.fx == float(((got.x - t) ** 2).sum())  # f at the final x, as JAX reports
    assert got.n_iters == want.n_iters == 50


def test_adam_on_a_list_of_tensors():
    t = torch.tensor(TARGET)
    res = opt(lambda xs: ((xs[0] - t[:2]) ** 2).sum() + (xs[1] - t[2]) ** 2, [torch.zeros(2), torch.zeros(())],
              method="adam", n_iter=500, alpha=0.05)
    np.testing.assert_allclose(np.r_[res.x[0].numpy(), res.x[1].numpy()], TARGET, atol=0.05)


def test_lbfgs_lowers_f_and_reaches_eps():
    t = torch.tensor([0.5, 1.5])

    def f(x):
        return ((x - t) ** 2).sum() + 0.1 * (x ** 4).sum()

    res = opt(f, torch.zeros(2), method="lbfgs", n_iter=50)
    assert res.fx < float(f(torch.zeros(2)))
    assert res.converged and res.n_iters < 50
    x = res.x.clone().requires_grad_(True)
    f(x).backward()
    assert float(x.grad.norm()) < 1e-4  # eps = 1e-5 held one step earlier
    tj = jnp.asarray([0.5, 1.5])
    want = jax_opt(lambda v: jnp.sum((v - tj) ** 2) + 0.1 * jnp.sum(v ** 4), jnp.zeros(2), method="lbfgs", n_iter=50)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), atol=1e-4)


def test_opt_rejects_unknown_method():
    with pytest.raises(ValueError):
        opt(lambda x: x.sum(), torch.zeros(1), method="sgd")


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_graph_summary_counts_matmul_flops():
    # no flop count any more (the port's kernels are invisible to
    # FlopCounterMode): the launches, and on the card the peak memory
    m, k, n = 8, 16, 4
    calls = []
    s = profiling.graph_summary(lambda a, b: calls.append(torch.matmul(a, b)), torch.ones(m, k), torch.ones(k, n))
    assert len(calls) == 1
    assert set(s) == ({"kernel_launches", "peak_memory_bytes"} if torch.cuda.is_available() else {"kernel_launches"})
    assert s["kernel_launches"] == {}  # the CPU takes the plain versions


def test_dump_hlo_is_an_aten_graph():
    text = profiling.dump_hlo(lambda x: (x * 2.0).sum(), torch.ones(8, 8))
    assert "aten." in text and "mul" in text and "sum" in text


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and os.path.getsize(d / files[0]) > 0
    with open(d / files[0]) as f:
        assert json.load(f)["traceEvents"]
