"""The JAX package's example workflows (``examples/*.py``) on the port, as
modules with ``main(argv=None)``: ``one_cell_fit``, ``active_training``,
``population_fit`` and ``large_scale_posterior``.  Each takes the JAX
script's flags and defaults plus ``--device`` (default: the CUDA card).
``python -m gaussian_processes_tpu_torch fit|active|population`` runs the
first three."""
