"""Tenants, the scheduler's unit of ownership (counterpart of the JAX
``coord/tenants.py``).

DistBelief ran on a shared cluster: training jobs, pipelines and serving
fleets competed for the same machines. A *tenant* is one such job, a named
demand for slots at a priority. :class:`TenantRegistry` is the scheduler's
bounded directory of who may own capacity; the ``CapacityLedger`` of
``coord/sched.py`` records who owns it now.

The registry is small and synchronous: an operator (or a drill or bench
harness) registers tenants before or during the run, and the scheduler
reads them under the registry's lock. Nothing here touches the wire.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

#: tenant kinds: the member kind a granted slot turns into
TENANT_TRAINING = 0  # a shard/worker pair of an elastic training job
TENANT_SERVING = 1   # an engine member of a serving fleet
TENANT_MPMD = 2      # a pipeline stage member

_KIND_NAMES = {
    TENANT_TRAINING: "training",
    TENANT_SERVING: "serving",
    TENANT_MPMD: "mpmd",
}


@dataclasses.dataclass
class Tenant:
    """One job's standing claim on fleet capacity.

    ``priority`` orders preemption: a higher-priority tenant's unmet demand
    may park a lower-priority tenant's member, never the other way round and
    never below ``min_slots``, the floor that keeps a preempted training job
    alive in degraded local-SGD mode instead of evicted. ``demand`` is the
    tenant's current want: set by the load signal (serving) or left static
    (training)."""

    tenant_id: int
    name: str
    kind: int = TENANT_TRAINING
    priority: int = 0
    demand: int = 0
    min_slots: int = 0

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, str(self.kind))


class TenantRegistry:
    """Bounded directory of tenants, keyed by small integer id.

    Ids ride the wire in ``SlotGrant`` frames, so they must be exact in
    float32: the registry enforces ``0 <= tenant_id < 2**16``."""

    MAX_TENANTS = 64

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tenants: Dict[int, Tenant] = {}

    def register(self, tenant: Tenant) -> Tenant:
        if not (0 <= tenant.tenant_id < (1 << 16)):
            raise ValueError(f"tenant_id {tenant.tenant_id} not wire-exact")
        with self._mu:
            if tenant.tenant_id not in self._tenants and len(self._tenants) >= self.MAX_TENANTS:
                raise ValueError(f"tenant registry full ({self.MAX_TENANTS})")
            self._tenants[tenant.tenant_id] = tenant
        return tenant

    def get(self, tenant_id: int) -> Optional[Tenant]:
        with self._mu:
            return self._tenants.get(tenant_id)

    def set_demand(self, tenant_id: int, demand: int) -> None:
        with self._mu:
            t = self._tenants.get(tenant_id)
            if t is None:
                raise KeyError(f"unknown tenant {tenant_id}")
            t.demand = int(demand)

    def all(self) -> List[Tenant]:
        """Priority-descending, then by id."""
        with self._mu:
            return sorted(self._tenants.values(), key=lambda t: (-t.priority, t.tenant_id))

    def by_priority_asc(self) -> List[Tenant]:
        """The order victims are picked in: lowest priority first."""
        with self._mu:
            return sorted(self._tenants.values(), key=lambda t: (t.priority, t.tenant_id))

    def __len__(self) -> int:
        with self._mu:
            return len(self._tenants)
