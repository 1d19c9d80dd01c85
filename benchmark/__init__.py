"""The benchmark of ``fluidsim_tpu_torch`` on NVIDIA H100 cards.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own
here, found by its name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py``, and the adapter of the
configuration's system in ``systems/<system>.py`` with its plain reference
in ``reference/``.  Nothing here imports JAX or the JAX package, and
``reference/`` imports nothing of the program.
"""
