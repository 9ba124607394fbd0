"""The port's command-line tools, each runnable as a file or with
``python -m symbolicregression_jl_tpu_torch.scripts.<name>``:
``sr_lint`` (the port's static analysis, ``analysis/lint.py``) and
``chaos_soak`` (the seeded chaos soak with its shrinker)."""
