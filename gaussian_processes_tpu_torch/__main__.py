"""The command line: ``python -m gaussian_processes_tpu_torch <command>``.

    fit         single-cell EM fit (examples/one_cell_fit.py flags)
    active      closed-loop active training (+ --ab-control)
    population  all cells in one batched program (--mesh-cells,
                --mesh-data: over a mesh of ranks, under torchrun)
    bench       not ported yet: the port bench is ROADMAP.md item 12

Every command takes ``--device`` (default: the CUDA card) and ``--help``.
"""

from __future__ import annotations

import sys

from .examples import active_training, one_cell_fit, population_fit

COMMANDS = {"fit": one_cell_fit, "active": active_training,
            "population": population_fit}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "bench":
        print("bench: the port has no bench yet (ROADMAP.md item 12); "
              "chip_smoke.py drives its main paths on the GPU")
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from "
              f"{sorted(COMMANDS) + ['bench']}")
        return 2
    COMMANDS[cmd].main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
