"""The Q4_0 dequant kernel's share of its roofline in the traced prefills:
each launch's least time (its Q4_0 weight read once, its bf16 copy written
once: ``counts.dequant_bound_s``, in the order a prefill dequantizes its
weights) over the sum of their device times.  A prefill whose launches do
not match that order's count is left out."""

UNIT = "%"
KERNEL = "dequant_kernel"


def read(run):
    from benchmark.metrics_common import kernels_by_request

    shapes = run.counts.prefill_dequant_shapes(run.dims)
    bound = took = 0.0
    for ks in kernels_by_request(run, "prefill").values():
        dq = [k for k in ks if KERNEL in k.name]
        if len(dq) != len(shapes):
            continue
        bound += sum(run.counts.dequant_bound_s(o, i) for o, i in shapes)
        took += sum(k.dur for k in dq) * 1e-6
    return 100.0 * bound / took if took else None
