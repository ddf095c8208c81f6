"""Fleet snapshot manifests (counterpart of the JAX ``coord/manifest.py``):
what a coordinator-aligned snapshot proves.

Per-shard checkpoints alone cannot restore a fleet: each shard checkpoints
on its own clock, so a multi-shard crash could restore shard A at version
900 beside shard B at version 400 with nothing detecting the skew. The
snapshot barrier (``Coordinator.trigger_snapshot`` → ``SnapshotRequest`` /
``SnapshotDone``) stamps one snapshot id, has every live shard checkpoint at
its next version boundary, and assembles the reports into a
:class:`FleetManifest`: the one file that says "these shard checkpoints, at
these ranges, under this shard-map version, form one consistent fleet
state".

Restore goes through :meth:`FleetManifest.load`, which refuses a bad
manifest loudly:

- ``incomplete``: the barrier never finished (``complete`` is false), or
  the recorded ranges do not tile ``[0, n_params)`` exactly;
- ``mixed``: a shard record stamped with another shard-map version than
  the manifest's.

The file's bytes are the JAX package's for the same manifest (``json.dumps``
with ``indent=1`` through ``utils/durability.atomic_write``), so either
package restores from the other's manifest.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardEntry, ShardMap
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write

MANIFEST_NAME = "fleet_manifest.json"


class ManifestError(ValueError):
    """A manifest that must not be restored from (incomplete, mixed or
    malformed), always raised, never degraded around."""


@dataclasses.dataclass(frozen=True)
class ShardRecord:
    """One shard's report into the barrier: its range under the snapshot's
    map version, and the checkpoint clock it persisted."""

    server_id: int
    lo: int
    hi: int
    map_version: int
    apply_seq: int
    push_count: int


@dataclasses.dataclass(frozen=True)
class FleetManifest:
    """A complete, mutually consistent fleet snapshot."""

    snapshot_id: int
    map_version: int
    n_params: int
    shards: Tuple[ShardRecord, ...]
    complete: bool = True

    def validate(self) -> "FleetManifest":
        if not self.complete:
            raise ManifestError(
                f"manifest for snapshot {self.snapshot_id} is incomplete — "
                "the barrier never finished; refusing to restore from it")
        if not self.shards:
            raise ManifestError(f"manifest for snapshot {self.snapshot_id} records no shards")
        ids = [s.server_id for s in self.shards]
        if len(set(ids)) != len(ids):
            raise ManifestError(
                f"manifest for snapshot {self.snapshot_id} records server ids more than "
                f"once: {sorted(ids)}")
        mixed = {s.server_id: s.map_version for s in self.shards
                 if s.map_version != self.map_version}
        if mixed:
            raise ManifestError(
                f"MIXED manifest for snapshot {self.snapshot_id}: map version "
                f"{self.map_version} but shard records at {mixed} — a cross-version restore "
                "would resurrect exactly the inconsistent fleet the barrier exists to prevent")
        cursor = 0
        for lo, hi in sorted((s.lo, s.hi) for s in self.shards):
            if lo != cursor or hi <= lo:
                raise ManifestError(
                    f"manifest for snapshot {self.snapshot_id} does not tile "
                    f"[0, {self.n_params}): gap/overlap at [{lo}, {hi}) vs cursor {cursor}")
            cursor = hi
        if cursor != self.n_params:
            raise ManifestError(
                f"manifest for snapshot {self.snapshot_id} covers [0, {cursor}) of "
                f"{self.n_params} params — incomplete")
        return self

    def entry_for(self, server_id: int) -> ShardRecord:
        for s in self.shards:
            if s.server_id == int(server_id):
                return s
        raise ManifestError(
            f"manifest for snapshot {self.snapshot_id} has no record for server "
            f"{server_id} — this shard is not part of the restored fleet")

    @property
    def shard_map(self) -> ShardMap:
        """The shard map the snapshot was taken under (ranges only: the
        install bookkeeping belongs to live rebalances)."""
        return ShardMap(self.map_version, self.n_params,
                        [ShardEntry(s.server_id, s.lo, s.hi)
                         for s in sorted(self.shards, key=lambda s: s.lo)])

    # ------------------------------------------------------------------ io
    def to_dict(self) -> Dict:
        return {
            "snapshot_id": self.snapshot_id,
            "map_version": self.map_version,
            "n_params": self.n_params,
            "complete": self.complete,
            "shards": [dataclasses.asdict(s) for s in self.shards],
        }

    def write(self, path: str) -> None:
        """Publish the manifest atomically and durably, validated first: the
        coordinator never publishes what a restore would refuse."""
        self.validate()
        atomic_write(path, json.dumps(self.to_dict(), indent=1).encode())

    @classmethod
    def from_dict(cls, d: Dict) -> "FleetManifest":
        try:
            shards = tuple(
                ShardRecord(server_id=int(s["server_id"]), lo=int(s["lo"]), hi=int(s["hi"]),
                            map_version=int(s["map_version"]),
                            apply_seq=int(s["apply_seq"]), push_count=int(s["push_count"]))
                for s in d["shards"])
            return cls(snapshot_id=int(d["snapshot_id"]), map_version=int(d["map_version"]),
                       n_params=int(d["n_params"]), shards=shards,
                       complete=bool(d.get("complete", False)))
        except (KeyError, TypeError, ValueError) as e:
            raise ManifestError(f"malformed manifest: {e!r}") from e

    @classmethod
    def load(cls, path: str) -> "FleetManifest":
        """Read and validate; :class:`ManifestError` on anything a restore
        must not trust."""
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ManifestError(f"unreadable manifest at {path}: {e!r}") from e
        return cls.from_dict(d).validate()
