"""Faults planted underneath the timed path, for the tests and for
``benchmark/control.py``: each must make ``correct`` false.

* ``token_altered``: the sampler's token is replaced by the next id where it
  is produced;
* ``state_unchanged``: a decode step writes its K/V into a copy of the
  cache, so the cache it leaves is the one it was given.

(A batch-1 cell on one chip has no half of a batch to leave out and no
exchange between chips.)
"""

from __future__ import annotations

import contextlib

FAULTS = ("token_altered", "state_unchanged")


@contextlib.contextmanager
def planted(name: str):
    from llama_swift_torch.models import llama
    from llama_swift_torch.runtime import device_sampler

    if name == "token_altered":
        mod, attr = device_sampler, "sample_token"
        orig = mod.sample_token

        def broken(logits, *a):
            return (orig(logits, *a) + 1) % logits.shape[-1]
    elif name == "state_unchanged":
        mod, attr = llama, "fused_layers_block"
        orig = mod.fused_layers_block

        def broken(x, an, fn, wqkv, wo, w13, w2, k, v, n_past, **kw):
            return orig(x, an, fn, wqkv, wo, w13, w2, k.clone(), v.clone(), n_past, **kw)
    else:
        raise ValueError(f"no fault {name!r}; known: {', '.join(FAULTS)}")
    setattr(mod, attr, broken)
    try:
        yield
    finally:
        setattr(mod, attr, orig)
