"""The control on the card: the plain reference computed in float32 with
TF32 products, put in the program's place, comes out not correct, while
the program itself comes out correct, for the cell at a reduced size
(108 px, the cell's own knobs, fewer rows and EM iterations).  At each
cell's own size the same readings come from ``python3 -m
portbench.calibrate``, which PERF.md's limits were set from.

    python -m pytest -q portbench/tests -m cuda       (on the card)
"""

from __future__ import annotations

import pytest
import torch

from portbench import run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist "
                    "only there")
    return torch.device("cuda", 0)


def reduced(workload: str) -> run.Spec:
    """The cell at 800 rows and 400 inducing rows, 6 EM iterations, each
    request a new cell from the seed."""
    spec = run.Spec(workload)
    spec.config.update(nt=800, ntilde=400)
    spec.config["fit"].update(maxiter=6)
    spec.traffic["params"]["n_train"] = 800
    spec.traffic["params"].pop("panel_size", None)
    return spec


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    spec = reduced("rf108.natural")
    driver = run.driver_for(spec.config)
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
        session = driver.setup(spec.config, spec.traffic, seed, card)
        win = driver.window(session, 2.0, False)
        limits = spec.config["limits"]
        program = run.judged(driver.check(session, win), limits)
        control = run.judged(driver.check(session, win, control=True),
                             limits)
        assert run.is_correct(program), (seed, program)
        assert not run.is_correct(control), (seed, control)
