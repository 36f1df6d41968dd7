"""``tools/matvec_variants.py`` against the source it edits: each variant's
replaced text occurs exactly once in ``csrc/q4_matvec.cu``, so an edit of
the 4-bit-activation matvecs' kernel that moves a variant's text breaks
here, on the CPU, and not in a chip run.  No ``nvcc`` is needed."""

import os

import pytest

from llama_swift_torch.ops import build
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.tools import matvec_variants as mvv

SOURCE = os.path.join(build.CSRC_DIR, "q4_matvec.cu")


@pytest.mark.parametrize("name", sorted(mvv.VARIANTS))
def test_variant_source_differs_only_by_its_replacements(name):
    """Each replaced text occurs exactly once in the source (else
    ``variant_source`` raises), and the variant is the source with just
    those replacements."""
    with open(SOURCE) as f:
        src = f.read()
    for old, _ in mvv.VARIANTS[name][0]:
        assert src.count(old) == 1, (name, old)
    out = mvv.variant_source(name)
    assert out != src
    for old, new in mvv.VARIANTS[name][0]:
        src = src.replace(old, new)
    assert out == src


def test_current_constants_match_the_plan():
    """The texts that the variants replace are the kernel's constants as
    ``ops/q4_matvec`` plans with them."""
    assert mvv._RING == f"constexpr int MV_RING = {mv.MV_RING};"
    assert mvv._WARPS == f"constexpr int MV_WARPS = {mv.MV_WARPS};"
    assert mvv._PER_SM == f"constexpr int MV_BLOCKS_PER_SM = {mv.MV_BLOCKS_PER_SM};"


def test_variant_text_not_found_raises(tmp_path):
    (tmp_path / "q4_matvec.cu").write_text("// an edited source\n")
    with pytest.raises(RuntimeError):
        mvv.variant_source("ring2", csrc_dir=str(tmp_path))
