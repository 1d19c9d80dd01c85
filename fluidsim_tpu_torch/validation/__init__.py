"""The reference-scale validation runs of the JAX repo, on the port: each
module is the counterpart of the script it is named after
(``scripts/soak_500.py``, ``scripts/soak_mpm.py``,
``scripts/soak_mpm_scaled.py``, ``scripts/validate_config5.py``,
``scripts/validate_mpm_shape.py``; ``ke_parity`` of
``tests/test_ke_parity.py`` and ``scripts/mpm_parity.py``), and
``traces`` holds their oracles and reads the recorded traces under
``docs/`` (read only).  ``cg_trace`` records every CG residual of the
MPM frames whose solve stopped at its cap.

    python -m fluidsim_tpu_torch.validation.<module> [--device cpu] ...

Each runs on the card unless ``--device`` asks for another, prints one
JSON line of its figures (``--out PATH`` also writes them there) and exits
nonzero when its oracle fails.
"""
