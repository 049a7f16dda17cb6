"""``codec_ablation.py`` builds its variants of the Int8 codec kernels by
replacing text of ``kernels/csrc/quantize.cu``.  Each replaced text must
stand in the source exactly once, so an edit of the kernels that moves one
fails here, on the CPU, and not on the next card run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("codec_ablation", ROOT / "codec_ablation.py")
codec_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(codec_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "quantize.cu").read_text()


@pytest.mark.parametrize("name", list(codec_ablation.ABLATIONS))
def test_every_replaced_text_stands_once_in_the_kernels(name):
    kernel, edits = codec_ablation.ABLATIONS[name]
    assert kernel in ("quantize", "dequantize")
    text = SOURCE
    for old, new in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert codec_ablation.edited(SOURCE, name, edits) == text != SOURCE


def test_every_variant_keeps_the_entry_points_and_the_arithmetic():
    """The variants change how the kernels move data, never what they
    compute: both entry points, the IEEE division and the rounded multiply
    stay in every edited copy, as the script's bitwise check expects."""
    for name, (_, edits) in codec_ablation.ABLATIONS.items():
        text = codec_ablation.edited(SOURCE, name, edits)
        for needed in ('extern "C" int repro_quantize_int8', 'extern "C" int repro_dequantize_int8',
                       "rintf(v / scale)", "m / 127.0f", "__fmul_rn(", "quantize_int8_kernel<<<",
                       "dequantize_int8_kernel<<<"):
            assert needed in text, (name, needed)
