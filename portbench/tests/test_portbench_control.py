"""The correctness check fails what it has to fail, at a size a CPU test
run holds (the tiny cell of tiny.py, bf16 like the real cells):

- the control, the reference computed in fp8 in the program's place, on
  three seeds;
- a whole run of the harness (everything but its look for a card) with
  the timed path broken underneath: the DiT step returning its state
  unchanged, one frame of each batch altered where it is produced, half of
  each batch's frames left out (the rest repeated), a request that fails;
  and an affine term left out: the VAE convolutions' bias, the GroupNorms'
  weight and bias, the linears' bias, the upsamplers' expansion in the
  fold;

while the sound program passes on the same seeds."""

import pytest

from portbench import control, faults, run
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, seed):
    return run.run_cell(tiny.CELL, seed, 0.5, False, "cpu", root)


@pytest.mark.parametrize("seed", [21, 2**33 + 7, 4_000_000_003])
def test_the_sound_program_passes(root, seed):
    r = _run(root, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert r["attempted"] % 2 == 0  # the window ends on a whole block of the mix's two sizes
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_fp8_control_fails(root, seed):
    r = control.readings(tiny.CELL, seed, 4, "cpu", root)
    assert not r["control_passes"], r["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    faults.FAULTS[fault](monkeypatch)
    r = _run(root, 41)
    assert not r["correct"], r["checks"]


def test_the_readings_tool_plants_and_removes_a_fault(root):
    bad = control.program_run(tiny.CELL, 43, 0.5, "conv_bias_dropped", "cpu", root)
    good = control.program_run(tiny.CELL, 43, 0.5, None, "cpu", root)
    assert not bad["correct"] and good["correct"], (bad["checks"], good["checks"])
