"""``tools/fused_variants.py`` against the source it edits: each variant's
replaced text occurs exactly once in ``csrc/fused_layer.cu``, so an edit of
the whole-stack kernel that moves a variant's text breaks here, on the CPU,
and not in a chip run.  No ``nvcc`` is needed."""

import os

import pytest

from llama_swift_torch.ops import build
from llama_swift_torch.tools import fused_variants as fv

SOURCE = os.path.join(build.CSRC_DIR, "fused_layer.cu")


@pytest.mark.parametrize("name", sorted(fv.VARIANTS))
def test_variant_source_differs_only_by_its_replacements(name):
    """Each replaced text occurs exactly once in the source (else
    ``variant_source`` raises), and the variant is the source with just
    those replacements."""
    with open(SOURCE) as f:
        src = f.read()
    for old, _ in fv.VARIANTS[name]:
        assert src.count(old) == 1, (name, old)
    out = fv.variant_source(name)
    assert out != src
    for old, new in fv.VARIANTS[name]:
        assert out.count(new) >= 1
        src = src.replace(old, new)
    assert out == src


def test_variants_cover_the_attribution():
    """The variants the records rely on: the products off, the weight
    streaming (L2 prefetch) off, the barriers alone, two blocks an SM."""
    assert {"no_products", "no_prefetch", "barriers_only", "blocks_per_sm_2"} <= set(fv.VARIANTS)


def test_variant_text_not_found_raises(tmp_path):
    (tmp_path / "fused_layer.cu").write_text("// an edited source\n")
    with pytest.raises(RuntimeError):
        fv.variant_source("no_products", csrc_dir=str(tmp_path))
