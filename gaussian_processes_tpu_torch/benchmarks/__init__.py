"""The JAX bench's measurement scripts (the repository's ``benchmarks/``),
ported: each module's ``run(..., device=None, dtype=torch.float32)``
returns ``(record, values)``, the JSON record the script prints and the
tensors it computed, and its ``main()`` prints the record as its last line
(``python -m gaussian_processes_tpu_torch.benchmarks.<name>``).

The bench's five secondaries, which ``python -m
gaussian_processes_tpu_torch bench --secondary`` runs one subprocess each
(``bench.SECONDARY``), smallest first: ``acquisition``, ``active_refit``,
``large_ntilde``, ``active_pipelined`` and ``population``.  Besides them,
``parity_production``: the posterior's float32 arms against float64 at
production shape (BASELINE.json's 1e-5 acceptance).
"""
