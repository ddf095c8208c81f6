"""A revoked worker's ``finish`` (the coordinator's revocation notice).

The coordinator revokes a worker (reputation, or the gray plane's evict
rung) through ``revoke_member``; the worker is then no longer among the
live workers, so the shards may leave once the others are done, without
taking its last pushes. The coordinator tells the revoked life so (a
``CoordLeave`` of its incarnation, repeated in answer to each renewal of
its cooldown), the member's ``CoordClient.revoked`` is set until a fleet
broadcast shows it readmitted, and the worker's ``finish`` then shares one
second among its flushes instead of waiting 10 s a link. An unacked push
stays unacked; every acked push was applied.
"""

import threading
import time

from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode


def _close(world):
    for t in world.values():
        t.close()

def test_a_revoked_member_is_told_and_the_flag_clears_on_readmission():
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient

    world = tmsg.InProcessTransport.create_world(2)
    now = [100.0]
    coord = tco.Coordinator(world[0], 8, lease=8.0, speculation=False, clock=lambda: now[0],
                            reputation_cooldown=5.0)
    client = CoordClient(world[1], "worker", renew_interval=60.0)
    try:
        coord.handle(1, MessageCode.CoordJoin, tco.encode_join(tco.KIND_WORKER,
                                                                 client.incarnation))
        coord.revoke_member(1, "test")

        def pump():
            while (msg := world[0].recv(timeout=0.05)) is not None:
                coord.handle(*msg)
            time.sleep(0.2)

        pump()
        assert client.revoked
        client.revoked = False  # a renewal in the cooldown is answered again
        client._send(MessageCode.LeaseRenew, tco.encode_renew(client.incarnation))
        pump()
        assert client.revoked
        now[0] += 6.0  # the cooldown is over: the re-join is admitted
        client._send(MessageCode.CoordJoin, tco.encode_join(tco.KIND_WORKER,
                                                             client.incarnation))
        pump()
        assert 1 in coord.members and not client.revoked
    finally:
        client.stop()
        _close(world)


def test_a_revoked_workers_finish_does_not_wait_out_its_ack_timeouts(tmp_path):
    """A worker revoked by the coordinator is no longer among the live
    workers, so the shards may stop before taking its last pushes: its
    ``finish`` returns within about a second instead of waiting out 10 s a
    link, an unacked push stays unacked, and every acked one was applied."""
    import torch

    from distributed_ml_pytorch_tpu_torch.coord.drill import (
        DRILL_UNRELIABLE,
        PsStars,
        resolve_fixture,
        serve,
        stop_servers,
    )
    from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosLog, ChaosPlan

    x, y, make_model, flat0 = resolve_fixture(None, "lenet", "cpu", 0)
    world = tmsg.InProcessTransport.create_world(3)
    stars = PsStars(1, 1, [ChaosPlan(seed=0)], ChaosLog(), DRILL_UNRELIABLE)
    coord = tco.Coordinator(world[0], flat0.size, lease=5.0, speculation=False)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 120}, daemon=True)
    coord_thread.start()
    threads = []
    servers = [serve(ElasticShardServer(
        server_id=1, n_params=flat0.size, transport=stars.server_transport(0),
        coord=CoordClient(world[1], "shard", renew_interval=0.1), init_params=flat0,
        ckpt_dir=str(tmp_path / "shard0"), ckpt_every=0, wal=True), threads)]
    client = CoordClient(world[2], "worker", renew_interval=0.1)
    try:
        m = client.join(timeout=30)
        net = make_model()
        factory = stars.factory(1)
        opt = ShardedAsynchronous(net, lr=0.05, n_push=1, n_pull=2,
                                  transports=[factory(e) for e in m.entries], coord=client,
                                  transport_factory=factory, shard_map=m)
        gen = torch.Generator().manual_seed(0)
        for step in range(4):
            loss_and_grads(net, torch.as_tensor(x[:8]), torch.as_tensor(y[:8]),
                           generator=gen)
            opt.step()
        coord.revoke_member(2, "reputation: test")
        deadline = time.monotonic() + 5
        while not getattr(client, "revoked", False) and time.monotonic() < deadline:
            time.sleep(0.02)  # the notice reaches the member's listener
        stop_servers(servers, threads)  # the fleet leaves without it
        loss_and_grads(net, torch.as_tensor(x[:8]), torch.as_tensor(y[:8]), generator=gen)
        opt.step()  # a push no server takes
        t0 = time.monotonic()
        opt.finish()
        took = time.monotonic() - t0
        acked, applied = stars.accounting(servers)
        assert took < 2.0, f"finish took {took:.1f}s"
        assert acked[0][1] <= applied[0][1]
        assert acked[0][1] < opt.idx  # the last push was never acked
    finally:
        client.stop()
        coord.stop()
        coord_thread.join(timeout=30)
        stars.close(servers)
        _close(world)
