"""chip_smoke.py's phases at tiny size on the CPU, called directly, and its
refusal to run without a GPU. The full-size kernel references need the card
(``gpu`` marker)."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chip_smoke import TINY  # noqa: E402


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs an NVIDIA GPU" in out.err


def test_phase_a_structured_tiny():
    rec = chip_smoke.phase_a(TINY)
    assert rec["phase"] == "A_structured"
    assert rec["steps"] > 0 and rec["psi_max"] <= 1.001
    assert rec["steps_per_s"] > 0


def test_phase_b_unstructured_tiny():
    rec = chip_smoke.phase_b(TINY)
    assert rec["phase"] == "B_unstructured"
    assert rec["mean_cg_iters"] >= 1


def test_phase_c_screened_tiny():
    rec = chip_smoke.phase_c(TINY)
    assert rec["kernel"] == "fft"
    assert rec["mean_screening_iters"] >= 1


def test_phase_d_transport_tiny():
    rec = chip_smoke.phase_d(TINY)
    assert len(rec["measured_uA"]) == 5
    assert rec["max_rel_err"] <= 0.1


def test_phase_e_kernel_references_tiny():
    rec = chip_smoke.phase_e(TINY)
    for name in ("pairwise", "fft_screening", "vcycle", "coarsest_solve",
                 "amg_two_level"):
        assert rec[name]["err"] <= rec[name]["tol"], name
    assert rec["trajectory"]["psi_err"] <= rec["trajectory"]["psi_tol"]


def test_four_cards_tiny_on_virtual_devices():
    assert len(jax.devices()) >= 4
    rec = chip_smoke.four_cards(TINY)
    assert rec["members"] == 4
    assert len(rec["spatial_shard_rows"]) == 1


def test_gate_raises():
    with pytest.raises(chip_smoke.GateError, match="boom"):
        chip_smoke.gate(False, "boom")
    chip_smoke.gate(True, "fine")


def test_current_through_line_uniform_flow():
    """A uniform sheet current K = (1, 0) through a vertical cut of a film
    of height 4 carries 4 (no holes crossed)."""
    dev = chip_smoke.bridge_device(0.6)
    K = np.tile([1.0, 0.0], (len(dev.mesh.sites), 1))
    ys = np.linspace(-5, 5, 501)
    total = chip_smoke.current_through_line(
        dev, K, np.stack([10 * np.ones_like(ys), ys], axis=1))
    assert abs(abs(total) - 4.0) < 0.05


@pytest.mark.gpu
def test_kernel_references_on_card(gpu_device):
    rec = chip_smoke.phase_e(chip_smoke.FULL)
    assert rec["phase"] == "E_kernels"
