"""``decode_ablation.py`` builds its variants of the decode attention
kernel by replacing lines of ``kernels/csrc/decode_attention.cu``.  Each
replaced text must stand in the source exactly once, so an edit of the
kernel that moves one fails here, on the CPU, and not on the next card
run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("decode_ablation", ROOT / "decode_ablation.py")
decode_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(decode_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "decode_attention.cu").read_text()


@pytest.mark.parametrize("name", list(decode_ablation.ABLATIONS))
def test_every_replaced_text_stands_once_in_the_kernel(name):
    edits = decode_ablation.ABLATIONS[name]
    text = SOURCE
    for old, _ in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, dict(edits)[old])
    text = decode_ablation.edited(SOURCE, name, edits)
    assert text is not None and text != SOURCE
    assert text.count("#if 0") == text.count("#endif") - SOURCE.count("#endif")
