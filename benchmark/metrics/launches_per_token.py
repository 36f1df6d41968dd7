"""Device kernels (the port's and PyTorch's) launched inside the traced
decode chunks, over the tokens those chunks decoded."""

UNIT = "count"


def read(run):
    from benchmark.metrics_common import decode_chunks

    chunks = decode_chunks(run)
    steps = sum(len(n_pasts) for _, n_pasts, _ in chunks)
    return sum(len(ks) for _, _, ks in chunks) / steps if steps else None
