"""The command line: ``python -m gaussian_processes_tpu_torch <command>``.

    fit         single-cell EM fit (examples/one_cell_fit.py flags)
    active      closed-loop active training (+ --ab-control)
    population  all cells in one batched program (--mesh-cells,
                --mesh-data: over a mesh of ranks, under torchrun)
    bench       the headline benchmark: the single-cell fit at the
                reference's shape, its two quality gates and the kernel
                check, as one JSON line (--repeats)

Every command takes ``--device`` (default: the CUDA card) and ``--help``.
"""

from __future__ import annotations

import sys

from . import bench
from .examples import active_training, one_cell_fit, population_fit

COMMANDS = {"fit": one_cell_fit, "active": active_training,
            "population": population_fit, "bench": bench}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from {sorted(COMMANDS)}")
        return 2
    if cmd == "bench":
        return bench.main(rest)
    COMMANDS[cmd].main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
