"""chip_smoke.py's phases at tiny sizes on the CPU (their logic and
checks), its last line, its refusal to run without a GPU, and — marked
`gpu`, skipped here — the same phases on the card."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY = dict(m=60, n=40)
TINY_LP = dict(m=300, n=200, density=0.05, block_size=16)
TINY_BATCH_LP = dict(B=2, m=320, n=160, density=0.05, block_size=16)


def test_phase_flagship_tiny():
    pobj, p_star, bound = chip_smoke.phase_flagship(B=4, **TINY)
    assert pobj.shape == p_star.shape == bound.shape == (4,)
    assert (bound > 0).all()


def test_phase_single_tiny():
    chip_smoke.phase_single(**TINY)


def test_phase_bell_tiny():
    chip_smoke.phase_bell(**TINY_LP)


def test_phase_bell_batch_tiny():
    chip_smoke.phase_bell_batch(**TINY_BATCH_LP)


def test_phase_mixed_and_polish_tiny():
    chip_smoke.phase_mixed_and_polish(B_mixed=2, B_hi=2, m_hi=60, n_hi=40)


def test_phase_kernels_tiny():
    chip_smoke.phase_kernels(
        m=300, n=200, density=0.05, B_bell=2, m_b=320, n_b=160, B_dense=2,
        m_d=60, n_d=40, block_size=16,
    )


def test_phase_four_cards_on_virtual_devices():
    """The four-card paths on four of the suite's virtual CPU devices."""
    chip_smoke.phase_four_cards(
        n_dev=4, B=8, m=60, n=40, m_lp=320, n_lp=160, density=0.05,
        block_size=16,
    )


def test_phase_check_fails_loudly():
    ph = chip_smoke.Phase("probe")
    ph.check("value", 2.0, 1.0)
    with pytest.raises(AssertionError, match="probe failed"):
        ph.done()


def test_result_line_is_the_contract():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_phases_on_gpu(gpu_device):
    """The phases at reduced sizes on the card (compiled kernels, no
    interpret mode)."""
    chip_smoke.phase_flagship(B=64, m=300, n=200)
    chip_smoke.phase_single(m=300, n=200)
    chip_smoke.phase_bell(m=3000, n=2000, density=0.01)
    chip_smoke.phase_bell_batch(B=2, m=3072, n=2048, density=0.01)
    chip_smoke.phase_kernels(
        m=3000, n=2000, density=0.01, B_bell=2, m_b=3072, n_b=2048,
        B_dense=2, m_d=300, n_d=200,
    )
