"""M6 parity: packaging (the reference Makefile installs a missing setup.py as
``pytorch-distbelief``, Makefile:4,29,38)."""

import re

from setuptools import find_packages, setup

with open("distributed_ml_pytorch_tpu/version.py") as f:
    VERSION = re.search(r'__version__ = "([^"]+)"', f.read()).group(1)

setup(
    name="tpu-distbelief",
    version=VERSION,
    description=(
        "TPU-native distributed training framework with DownPour-SGD "
        "parameter-server, sync data-parallel, and local-SGD strategies"
    ),
    packages=find_packages(include=["distributed_ml_pytorch_tpu*"]),
    # ship the native transport source so installs can build it on demand
    # (native/__init__.py ensure_built compiles with the local g++)
    package_data={
        "distributed_ml_pytorch_tpu.native": ["transport.cpp", "Makefile"],
        # the PyTorch port's CUDA kernels, built with nvcc at first use
        # (distributed_ml_pytorch_tpu_torch/ops/_build.py)
        "distributed_ml_pytorch_tpu_torch": ["csrc/*.cu"],
        # the port's own copy of the native transport, built with g++ at
        # first use (distributed_ml_pytorch_tpu_torch/native/__init__.py)
        "distributed_ml_pytorch_tpu_torch.native": ["transport.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pandas",
        # default runtime paths use these: per-epoch classification report
        # (trainer.evaluate verbose) and the graph plotter
        "scikit-learn",
        "matplotlib",
        # checkpoint/resume subsystem (utils/checkpoint.py)
        "orbax-checkpoint",
    ],
    extras_require={
        "dev": ["pytest"],
    },
)
