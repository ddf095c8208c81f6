"""The elastic control plane (counterpart of the JAX ``coord/`` package):
membership by leases, versioned shard maps the coordinator renegotiates at
run time, and Sandblaster-style straggler speculation.

- :mod:`~.shardmap` — :class:`ShardMap` and its float32 wire frame;
- :mod:`~.coordinator` — :class:`Coordinator`, rank 0 of the coordination
  star;
- :mod:`~.member` — :class:`CoordClient`, a member's side, and
  :class:`FleetView`;
- :mod:`~.elastic` — ``ElasticShardServer``, a parameter server whose range
  follows the map, with its snapshot and rollback mailboxes;
- :mod:`~.manifest` — :class:`FleetManifest`, what a snapshot barrier
  publishes and a restore trusts;
- :mod:`~.demo` — the in-process elastic world and its scenario;
- :mod:`~.tenants` — :class:`Tenant` and :class:`TenantRegistry`, who may
  own fleet capacity;
- :mod:`~.sched` — :class:`FleetScheduler` and its ``CapacityLedger``:
  admit, preempt (park), resume;
- :mod:`~.grayhealth` — :class:`~.grayhealth.GrayHealth`, the gray-failure
  plane: adaptive suspicion and the probation, quarantine and evict ladder;
- :mod:`~.drill` — the recovery drill, the scheduler drill, the gray-failure
  drill and the coordinator-failure drill;
- :mod:`~.health` — the numerical-health scenario (poisoned worker,
  reputation, auto-rollback);
- :mod:`~.stages` — the MPMD stage plane's placement, its coordinator
  and the fleet scenario;
- :mod:`~.cli` — the coordinator process (``python -m
  distributed_ml_pytorch_tpu_torch.coord.cli``).
"""

from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardEntry, ShardMap
from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator, MemberInfo
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient, FleetView
from distributed_ml_pytorch_tpu_torch.coord.sched import CapacityLedger, FleetScheduler, Slot
from distributed_ml_pytorch_tpu_torch.coord.tenants import (
    TENANT_MPMD,
    TENANT_SERVING,
    TENANT_TRAINING,
    Tenant,
    TenantRegistry,
)

__all__ = ["ShardEntry", "ShardMap", "Coordinator", "MemberInfo", "CoordClient",
           "FleetView", "CapacityLedger", "FleetScheduler", "Slot", "Tenant",
           "TenantRegistry", "TENANT_TRAINING", "TENANT_SERVING", "TENANT_MPMD"]
