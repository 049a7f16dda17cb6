"""``scan_ablation.py`` builds its variants of the selective scan kernels
(the forward's and the backward's) by replacing lines of
``kernels/csrc/selective_scan.cu``.  Each replaced
text must stand in the source exactly once, so an edit of the kernel that
moves one fails here, on the CPU, and not on the next card run."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("scan_ablation", ROOT / "scan_ablation.py")
scan_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scan_ablation)
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "selective_scan.cu").read_text()


@pytest.mark.parametrize("name", list(scan_ablation.ABLATIONS))
def test_every_replaced_text_stands_once_in_the_kernel(name):
    edits = scan_ablation.ABLATIONS[name]
    text = SOURCE
    for old, new in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert scan_ablation.edited(SOURCE, name, edits) == text != SOURCE


@pytest.mark.parametrize("name", list(scan_ablation.BWD_ABLATIONS))
def test_every_replaced_text_stands_once_in_the_backward(name):
    edits = scan_ablation.BWD_ABLATIONS[name]
    text = SOURCE
    for old, new in edits:  # in turn, as the script applies them
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert scan_ablation.edited(SOURCE, name, edits) == text != SOURCE


def test_the_whole_kernel_keeps_the_plain_roundings():
    """The source the ablations edit computes the state with rounded
    products and sums and the accurate expf; only the last variant leaves
    that contract."""
    assert scan_ablation._EXP in SOURCE and scan_ablation._UPDATE in SOURCE
    assert "__expf(" not in SOURCE and "ex2.approx" not in SOURCE


def test_the_bare_launch_takes_the_forwards_c_signature():
    """The variants are called through ctypes with ``SIGNATURES``' argtypes:
    the script's arguments are as many as the entry point takes, the
    checkpoint pointer NULL (the serving forward) and one group."""
    import torch

    from repro_torch.kernels import _cuda

    b, s, di, n = 2, 3, 8, 16
    x, y = torch.zeros(b, s, di, dtype=torch.bfloat16), torch.zeros(b, s, di,
                                                                    dtype=torch.bfloat16)
    dt, a, d = torch.zeros(b, s, di), torch.zeros(di, n), torch.zeros(di)
    bm, cm, h = torch.zeros(b, s, n), torch.zeros(b, s, n), torch.zeros(b, di, n)
    args = scan_ablation.bare_args(x, dt, a, bm, cm, d, y, h, 0)
    assert len(args) == len(_cuda.SIGNATURES["selective_scan"]["repro_selective_scan_bf16"])
    assert args[6] is None and args[9] is None and args[10:16] == (b, s, di, n, di, 1)


def test_the_bare_backward_takes_the_backwards_c_signature():
    """The backward variants' arguments: as many as the entry point takes,
    dh0 NULL, ld = Di, the groups and the partials' block count last."""
    import torch

    from repro_torch.kernels import _cuda

    b, s, di, n, g = 4, 3, 8, 16, 2
    x = torch.zeros(b, s, di, dtype=torch.bfloat16)
    ins = (x, torch.zeros(b, s, di), torch.zeros(g, di, n), torch.zeros(b, s, n),
           torch.zeros(b, s, n), torch.zeros(g, di), x.clone(), torch.zeros(b, 1, n, di),
           torch.zeros(b, di, n))
    outs = (x.clone(), torch.zeros(b, s, di), torch.zeros(b, s, n), torch.zeros(b, s, n),
            torch.zeros(g, di, n), torch.zeros(g, di))
    scratch = (torch.zeros(1, b, s, 2, n), torch.zeros(b, di, n), torch.zeros(b, di))
    args = scan_ablation.bwd_bare_args(ins, outs, scratch, g, 0)
    assert len(args) == len(_cuda.SIGNATURES["selective_scan"][scan_ablation._BWD_ENTRY])
    assert args[15] is None and args[19:26] == (b, s, di, n, di, g, 1)
