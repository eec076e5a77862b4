"""The benchmark of ``aukit_tpu_torch``: see ``portbench/run.py``."""
