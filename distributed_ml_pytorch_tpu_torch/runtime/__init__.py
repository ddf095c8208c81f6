"""The port's runtime layer: the device mesh over a ``torch.distributed``
world (``runtime/mesh.py``)."""

from distributed_ml_pytorch_tpu_torch.runtime.mesh import (  # noqa: F401
    DeviceMesh,
    World,
    data_mesh,
    init_distributed,
    local_device_count,
    make_mesh,
    process_rank,
    run_threaded,
    world_size,
)
