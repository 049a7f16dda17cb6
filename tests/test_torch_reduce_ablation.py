"""``reduce_ablation.py`` builds its variants of the Int8 reduce kernel by
replacing text of ``kernels/csrc/dequant_reduce.cu``.  Each replaced text
must stand in the source exactly once, so an edit of the kernel that moves
one fails here, on the CPU, and not on the next card run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("reduce_ablation", ROOT / "reduce_ablation.py")
reduce_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reduce_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "dequant_reduce.cu").read_text()


@pytest.mark.parametrize("name", list(reduce_ablation.ABLATIONS))
def test_every_replaced_text_stands_once_in_the_kernel(name):
    edits = reduce_ablation.ABLATIONS[name]
    text = SOURCE
    for old, new in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert reduce_ablation.edited(SOURCE, name, edits) == text != SOURCE


def test_every_variant_keeps_the_entry_point_and_the_arithmetic():
    """The variants change how the kernel moves data, never what it
    computes: the entry point, the client-order weight sum, the IEEE
    division, the rounded product inside the fmaf chain and the product
    for normalize=False stay in every edited copy, as the script's bitwise
    check expects."""
    for name, edits in reduce_ablation.ABLATIONS.items():
        text = reduce_ablation.edited(SOURCE, name, edits)
        for needed in ('extern "C" int repro_dequant_reduce', "__fadd_rn(s, ",
                       "__fdiv_rn(wn[c], ws)", "fmaf(wc, __fmul_rn(x, sg), acc[4 * g + b])",
                       "__fmul_rn(o.x, ws)", "dequant_reduce_kernel<<<"):
            assert needed in text, (name, needed)
