"""What several metric readers take from a run's device trace."""

from __future__ import annotations


def kernels_by_request(run, label: str) -> dict:
    """{request index: kernels launched in its ``label`` ranges, in launch
    order}."""
    if run.trace is None:
        return {}
    out = {}
    for rng, ks in run.trace.in_ranges(label):
        out.setdefault(rng.request, []).extend(ks)
    return {i: sorted(ks, key=lambda k: run.trace.launch[k.corr]) for i, ks in out.items()}


def decode_chunks(run) -> list:
    """The traced decode chunks: (request, the ``n_past`` of each of its
    steps, the kernels launched in it), for chunks of requests sent in the
    window."""
    if run.trace is None:
        return []
    recs = run.by_index()
    chunk = int(run.mix["device_chunk"])
    seen, out = {}, []
    for rng, ks in run.trace.in_ranges("decode"):
        rec = recs.get(rng.request)
        if rec is None:
            continue
        k = seen.get(rng.request, 0)
        seen[rng.request] = k + 1
        steps = min(chunk, rec.n_predict - k * chunk)
        out.append((rec, rec.decode_n_pasts(k * chunk, steps),
                    sorted(ks, key=lambda x: run.trace.launch[x.corr])))
    return out
