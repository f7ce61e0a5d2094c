"""A run of each configuration on the CPU at a tiny size, past the look
for a card, with the timed path sound and then broken underneath: the
sound fit run comes out correct, and each fault the cell can have makes
``correct`` false.  The faults (``portbench/faults.py``): an EM iteration
whose E-step and M-step return the state they were given while the fit
still records its loss (and an M-step alone that does); half of the
training rows left out of the likelihood and the rest counted twice; an
answer altered where it is produced (the predicted rates).  The cell runs
on one card, so no exchange between cards can be left out.

    python -m pytest -q portbench/tests/test_portbench_faults.py
"""

from __future__ import annotations

import pytest

from portbench import run
from portbench.faults import FAULTS

SEED = 2 ** 41 + 11


def tiny_spec(workload: str, root=run.ROOT) -> run.Spec:
    spec = run.Spec(workload, root)
    spec.traffic["params"].update(n_px_side=16, n_train=120,
                                  n_calibration=200, n_test=10, n_repeats=6)
    c = spec.config
    c.update(n_px_side=16, nbootstrap=20, nt=120, ntilde=48)
    c["fit"].update(maxiter=5, n_mstep=4)
    spec.traffic["params"]["panel_size"] = 2
    return spec


def measure(workload: str, root=run.ROOT) -> dict:
    return run.measure(tiny_spec(workload, root), SEED, 2.0, False, "cpu")


def test_sound_run_is_correct():
    result = measure("rf108.natural")
    assert result["attempted"] >= 1
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault,caught_by", [
    ("state_unchanged", ("estep", "mstep")),
    ("mstep_unchanged", ("mstep",)),
    ("half_batch", ("loss",)),
    ("rates_altered", ("rates",)),
])
def test_fault_makes_the_run_incorrect(fault, caught_by):
    with FAULTS[fault]():
        result = measure("rf108.natural")
    assert not result["correct"], result["checks"]
    for name in caught_by:
        c = result["checks"][name]
        assert c["value"] > c["limit"], (name, result["checks"])
