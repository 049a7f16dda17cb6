"""``flash_ablation.py`` builds its variants of the bf16 flash kernel by
replacing lines of ``kernels/csrc/flash_attention.cu``.  Each replaced text
must stand in the source exactly once, so an edit of the kernel that moves
one fails here, on the CPU, and not on the next card run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("flash_ablation", ROOT / "flash_ablation.py")
flash_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(flash_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu").read_text()
VARIANTS = {**flash_ablation.ABLATIONS, "trace": flash_ablation.TRACE}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_every_replaced_text_stands_once_in_the_kernel(name):
    edits = VARIANTS[name]
    counts = [SOURCE.count(old) for old, _ in edits]
    assert counts == [1] * len(edits), counts
    text = flash_ablation.edited(SOURCE, name, edits)
    assert text is not None and text != SOURCE
