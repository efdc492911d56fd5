"""The port's copied constants, its JAX-free import graph, and device
selection.

``jsdr_tpu_torch.demod.bpsk``, ``demod.fft_tuner`` and ``ops.nco`` copy the
constants of their ``jsdr_tpu`` counterparts (those modules import jax);
they must stay equal.
The port must never import jax: the machine that runs it on the GPU has
none."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.demod import fft_tuner as JT
from jsdr_tpu.ops import nco as JN
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.demod import fft_tuner as TT
from jsdr_tpu_torch.ops import nco as TN
from jsdr_tpu_torch.runtime import device as D

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", [
    "DOWN_SAMPLE_RATE", "BIT_RATE", "SAMPLES_PER_BIT", "HOWARD_FUDGE_FACTOR",
    "BIT_SMOOTH1", "BIT_SMOOTH2", "ENERGY_GATE", "SYNC_THRESHOLD",
    "FEC_BITS", "SINCOS_SIZE", "NU_SCALE", "DS_FILTER", "DM_FILTER",
    "_VCO_COS", "_VCO_SIN", "_SYNC"])
def test_copied_constants_equal_reference(name):
    got, want = getattr(TB, name), getattr(JB, name)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mods,name", [
    ((TT, JT), n) for n in ("PSD_AVG", "PSD_INV", "SLICE_HALF", "BOX_HALF",
                            "EDGE", "MIN_CENTRE")] + [
    ((TN, JN), n) for n in ("SINCOS_SIZE", "TWO_PI")])
def test_tuner_and_nco_constants_equal_reference(mods, name):
    got, want = (getattr(m, name) for m in mods)
    assert type(got) is type(want) or float(got) == float(want)
    assert got == want
    assert TT.FftTunerState._fields == JT.FftTunerState._fields


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import jsdr_tpu_torch.demod.bpsk, jsdr_tpu_torch.fec.decoder, "
            "jsdr_tpu_torch.app.main, jsdr_tpu_torch.demod.fft_tuner, "
            "jsdr_tpu_torch.ops.nco\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_require_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        D.require_device("cuda")


def test_require_cpu_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert D.require_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
