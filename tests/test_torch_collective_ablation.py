"""``collective_ablation.py`` builds its variants of the int8 collective's
kernels by replacing text of ``kernels/csrc/collective_quant.cu``.  Each
replaced text must stand in the source exactly once, so an edit of the
kernels that moves one fails here, on the CPU, and not on the next card
run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("collective_ablation",
                                               ROOT / "collective_ablation.py")
collective_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(collective_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "collective_quant.cu").read_text()


@pytest.mark.parametrize("name", list(collective_ablation.ABLATIONS))
def test_every_replaced_text_stands_once_in_the_kernels(name):
    edits = collective_ablation.ABLATIONS[name]
    text = SOURCE
    for old, new in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert collective_ablation.edited(SOURCE, name, edits) == text != SOURCE


def test_every_variant_keeps_the_entry_points_and_the_arithmetic():
    """The variants change how the kernels move data, never what they
    compute: the three entry points, the fold's rounded product and sum,
    the NaN-keeping max, the IEEE divisions and the residual's rounded
    product and difference stay in every edited copy, as the script's
    bitwise check expects."""
    for name, edits in collective_ablation.ABLATIONS.items():
        text = collective_ablation.edited(SOURCE, name, edits)
        for needed in ('extern "C" int repro_collective_absmax',
                       'extern "C" int repro_collective_pack',
                       'extern "C" int repro_collective_unpack', "__fmul_rn(d, f.w)",
                       "__fadd_rn(x, r)", "(a > b || isnan(a)) ? a : b",
                       "__fdiv_rn(s, 127.0f)", "rintf(__fdiv_rn(v, scale))",
                       "__fsub_rn(e.x, sent.x)"):
            assert needed in text, (name, needed)
