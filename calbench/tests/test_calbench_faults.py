"""A run with its timed path broken underneath comes out not correct, and so
does the control in the program's place.

Each fault of ``calbench/faults.py`` is planted in the port on the CPU at
cut width, the harness's look for a card skipped: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced, and a float32 phase of the
mixed schedule that moves nothing. One chip holds every cell, so no
exchange between chips can be left out. A float32 phase started from a
fresh Adamax state (``carry_dropped``) fits as well as a sound one and is
not among them."""

import time

import pytest
from calbench_cuts import CUTS, SEED

from calbench import control, faults, harness

CAUGHT = ["altered_answer", "half_batch", "phase2_frozen", "unchanged_state"]


@pytest.mark.parametrize("name", ["hera_full.fit1", "hera_full.campaign8"])
@pytest.mark.parametrize("fault", CAUGHT)
def test_a_fault_makes_the_run_not_correct(monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    code, res = harness.run(name, SEED, 0.0, False, time.perf_counter(), device="cpu",
                            overrides=CUTS[name])
    assert code == 0 and res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", sorted(CUTS))
def test_the_control_in_the_programs_place_is_not_correct(name):
    limits = CUTS[name]["limits"]
    got = control.readings(name, [SEED, 3], device="cpu", overrides=CUTS[name],
                           log=lambda m: None)
    for r in got.values():
        assert all(r["program"][k] <= limits[k] for k in harness.NUMBERS)
        # the control fails one of the numbers
        assert any(r["control"][k] > limits[k] for k in harness.NUMBERS)
