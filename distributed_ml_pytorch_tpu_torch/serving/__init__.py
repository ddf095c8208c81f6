"""Serving layer: a continuous-batching inference engine for the
TransformerLM (counterpart of the JAX ``serving`` package, without
``fleet.py``).

- :mod:`serving.cache` — fixed-capacity KV slot pool over the ring-buffered
  blocked decode cache, per-slot live lengths, optional int8 ``kv_quant``;
- :mod:`serving.engine` — the scheduler: admission between decode blocks,
  per-request sampling, eviction, backpressure, SLO metrics;
- :mod:`serving.frontend` — request/response transport over
  ``utils/messaging.py``;
- :mod:`serving.cli` — the ``serve`` entry point.
"""

from distributed_ml_pytorch_tpu_torch.serving.cache import SlotKVPool
from distributed_ml_pytorch_tpu_torch.serving.engine import (
    QueueFullError,
    Request,
    SamplingParams,
    ServingEngine,
)
from distributed_ml_pytorch_tpu_torch.serving.frontend import (
    RequestRejected,
    ServingClient,
    ServingFrontend,
)

__all__ = [
    "SlotKVPool",
    "ServingEngine",
    "Request",
    "SamplingParams",
    "QueueFullError",
    "ServingFrontend",
    "ServingClient",
    "RequestRejected",
]
