"""Analysis of the port's runtime artifacts: ``timeline`` merges the flight
recorder's dumps and attributes a fleet's wall clock (``python -m
distributed_ml_pytorch_tpu_torch.analysis timeline <dump-dir>``)."""

from distributed_ml_pytorch_tpu_torch.analysis.cli import main  # noqa: F401
