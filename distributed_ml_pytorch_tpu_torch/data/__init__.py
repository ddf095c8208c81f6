from distributed_ml_pytorch_tpu_torch.data.cifar10 import (
    CIFAR10_CLASSES,
    download_cifar10,
    get_dataset,
    iterate_batches,
    load_cifar10,
    prefetch_to_device,
    shard_for_process,
    synthetic_cifar10,
)

__all__ = [
    "CIFAR10_CLASSES",
    "download_cifar10",
    "get_dataset",
    "iterate_batches",
    "load_cifar10",
    "prefetch_to_device",
    "shard_for_process",
    "synthetic_cifar10",
]
