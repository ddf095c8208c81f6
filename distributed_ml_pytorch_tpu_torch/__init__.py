"""PyTorch + CUDA port of the DownPour parameter-server framework.

The JAX package ``distributed_ml_pytorch_tpu`` is the reference this package
is held against; module paths mirror it so each counterpart is found by
name. This package imports ``torch`` and numpy only — never JAX, and never
anything of the JAX package. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the hot ops (``ops/``) are hand-written Hopper
kernels (``csrc/*.cu``) built with ``nvcc`` at first use.

Importing the package is cheap: submodules are imported where used.
"""

__version__ = "0.1.0"
