"""``tools/block_variants.py`` against the sources it edits: each variant's
replaced text occurs exactly once in its kernel's file, so an edit of the
integer T product's or the attention block's kernel that moves a
variant's text breaks here, on the CPU, and not in a chip run.  No
``nvcc`` is needed."""

import os

import pytest

from llama_swift_torch.ops import build
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.tools import block_variants as bv


@pytest.mark.parametrize("name", sorted(bv.VARIANTS))
def test_variant_source_differs_only_by_its_replacements(name):
    stem, edits = bv.VARIANTS[name]
    with open(os.path.join(build.CSRC_DIR, stem + ".cu")) as f:
        src = f.read()
    for old, _ in edits:
        assert src.count(old) == 1, (name, old)
    out = bv.variant_source(name)
    assert out != src
    for old, new in edits:
        src = src.replace(old, new)
    assert out == src


def test_variant_text_not_found_raises(tmp_path):
    (tmp_path / "q4_matvec.cu").write_text("// an edited source\n")
    with pytest.raises(RuntimeError):
        bv.variant_source("terms_rounded", csrc_dir=str(tmp_path))


def test_current_constants_are_the_variants_texts():
    """The texts the variants replace are the kernels' constants as they
    stand: three ring stages from 33 rows (``int_matmul_plan``'s shared
    memory) and the attention block's 32 KB tiles."""
    assert mv.int_matmul_plan(4096, 4096, 64).launches[0][2].smem == 3 * (
        64 * (16 * 16 + 16) + 64 * (16 + 4) * 4 + 64 * (16 * 32 + 16) + 16 * 64 * 8)
    assert bv._TILE == "constexpr int BLOCK_STAGE_BYTES = 32768;"


def test_no_cluster_plan_drops_only_the_wide_launches_splits():
    """``ks1`` forces one block a tile on the 33-64-row launches and leaves
    row 6's launches as they are."""
    plan = bv._no_cluster(4096, 4096, 100)
    assert [(rows, p.splits) for _, rows, p in plan.launches] == [(64, 1), (36, 1)]
    assert bv._no_cluster(4096, 4096, 8) == mv.int_matmul_plan(4096, 4096, 8)
