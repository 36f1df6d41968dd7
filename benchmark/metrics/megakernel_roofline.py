"""The whole-stack kernel's share of its roofline: over the traced decode
chunks, the sum of each ``fused_layers_kernel`` launch's least time
(``counts.megakernel_bound_s`` at the ``n_past`` the traffic gave it) over
the sum of their device times.  A chunk whose launches do not match its
steps one for one is left out."""

UNIT = "%"
KERNEL = "fused_layers_kernel"


def read(run):
    from benchmark.metrics_common import decode_chunks

    bound = took = 0.0
    for _, n_pasts, ks in decode_chunks(run):
        mk = [k for k in ks if KERNEL in k.name]
        if len(mk) != len(n_pasts):
            continue
        bound += sum(run.counts.megakernel_bound_s(run.dims, n) for n in n_pasts)
        took += sum(k.dur for k in mk) * 1e-6
    return 100.0 * bound / took if took else None
