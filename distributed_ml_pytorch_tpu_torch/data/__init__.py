from distributed_ml_pytorch_tpu_torch.data.cifar10 import (
    CIFAR10_CLASSES,
    get_dataset,
    iterate_batches,
    load_cifar10,
    synthetic_cifar10,
)

__all__ = [
    "CIFAR10_CLASSES",
    "get_dataset",
    "iterate_batches",
    "load_cifar10",
    "synthetic_cifar10",
]
