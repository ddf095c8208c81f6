"""``chip_smoke.py`` phase 20 (a)'s world (three processes: a durable int8
+ Adasum server and two chunked AlexNet workers on the native reliable
wire) run alone, with every frame's timings in every rank: when a worker
handed it to the wire (and how long its send was blocked at the server's
credit), when the server took it in, handed it to its application and
committed the log group that released its ack. It prints, for each run,
each rank's longest ack wait and the per-frame waits; ``--no-lag`` runs a
variant without the lagging receiver's credit bound
(``utils/messaging.LAG_CREDIT_SHARE`` made unbounded), the comparison that
priced the bound.

Run it from the repository's root (it imports ``chip_smoke``)::

    python -m distributed_ml_pytorch_tpu_torch.bench_wire_lag --runs 3 --variants lag,nolag
    python -m distributed_ml_pytorch_tpu_torch.bench_wire_lag --device cpu --runs 1

Each rank's timings go to ``--out`` (``chiprun_out/wire_lag`` by default)
as JSON lists, and one line a run to stdout.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: run inside each rank process, before ``run_ps_process``: the timings
_RECORD = r'''
import os
EV = []
_RT = msg.ReliableTransport
if os.environ.get("WIRE_LAG_NOLAG") == "1":
    msg.LAG_CREDIT_SHARE = 1e9
_real_process = _RT._process
def _process(self, m, read_at=None):
    if m is not None and m[1] == MessageCode.ReliableFrame and m[2].size >= 9:
        EV.append((time.time(), "take", int(m[0]), msg._join16(m[2][2], m[2][3])))
    return _real_process(self, m, read_at)
_RT._process = _process
_real_recv = _RT.recv
def _recv(self, timeout=None):
    out = _real_recv(self, timeout)
    if out is not None and self.last_delivery is not None:
        EV.append((time.time(), "handout", int(out[0]), self.last_delivery[1]))
    return out
_RT.recv = _recv
_real_ackd = _RT.ack_delivered
def _ackd(self):
    EV.append((time.time(), "commit"))
    return _real_ackd(self)
_RT.ack_delivered = _ackd
_real_send = _RT.send
def _send(self, code, payload, dst=0):
    t0 = time.time()
    seq = self._next_seq.get(dst, 0)
    out = _real_send(self, code, payload, dst)
    if int(code) not in self.unreliable_codes:
        EV.append((t0, "send", dst, seq, int(code), time.time() - t0))
    return out
_RT.send = _send
'''
_DUMP = r'''
with open(os.path.join(os.environ["WIRE_LAG_OUT"],
                       f"rank{args.rank}_{os.environ['WIRE_LAG_TAG']}.json"), "w") as fh:
    json.dump(EV, fh)
'''


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def frame_waits(server: list, worker: list, rank: int) -> list:
    """Per frame a worker sent to the server: ``(seq, code, blocked at the
    credit, handed to the wire -> taken in, taken in -> handed out, handed
    out -> the group's commit)`` in seconds (``None`` where unknown)."""
    takes = {(e[2], e[3]): e[0] for e in server if e[1] == "take"}
    hands = {}
    for e in server:
        if e[1] == "handout":
            hands.setdefault((e[2], e[3]), e[0])
    commits = sorted(e[0] for e in server if e[1] == "commit")
    rows = []
    for t0, _, dst, seq, code, blocked in (e for e in worker if e[1] == "send"):
        if dst != 0:
            continue
        left, tk, hd = t0 + blocked, takes.get((rank, seq)), hands.get((rank, seq))
        i = bisect.bisect_left(commits, hd) if hd is not None else len(commits)
        cm = commits[i] if i < len(commits) else None
        rows.append((seq, code, round(blocked, 3),
                     None if tk is None else round(tk - left, 3),
                     None if tk is None or hd is None else round(hd - tk, 3),
                     None if hd is None or cm is None else round(cm - hd, 3)))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", type=int, default=3, help="runs of each variant")
    p.add_argument("--variants", default="lag", help="comma-separated: lag, nolag")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the workers' device (the CPU runs LeNet)")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "wire_lag"))
    args = p.parse_args(argv)
    cs = _chip_smoke()
    model = "alexnet" if args.device == "cuda" else "lenet"
    if args.device == "cuda":
        from distributed_ml_pytorch_tpu_torch.ops import _build

        _build.load("fused_update")
        _build.load("fused_conv")
    os.makedirs(args.out, exist_ok=True)
    src = cs._PS_RANK_SRC
    cs._PS_RANK_SRC = src.replace("rc = tps.run_ps_process(args)",
                                  _RECORD + "\nrc = tps.run_ps_process(args)\n" + _DUMP)
    os.environ["WIRE_LAG_OUT"] = args.out
    i = 0
    try:
        for _ in range(args.runs):
            for variant in args.variants.split(","):
                tag = f"{i}_{variant}"
                os.environ["WIRE_LAG_TAG"] = tag
                os.environ["WIRE_LAG_NOLAG"] = "1" if variant == "nolag" else "0"
                lines, wall = cs._ps_processes(
                    cs.CODEC_WIRE, os.path.join(ROOT, "build", f"wire_lag_{i}"), args.device,
                    model, cs.WORKER_STEPS)
                ev = {}
                for r in (0, 1, 2):
                    with open(os.path.join(args.out, f"rank{r}_{tag}.json")) as fh:
                        ev[r] = json.load(fh)
                print(json.dumps({
                    "run": i, "variant": variant, "wall_s": wall,
                    "max_ack_s": {r: ln["max_ack_s"] for r, ln in lines.items()},
                    "timeouts": {r: ln["stats"]["rto_expired"] for r, ln in lines.items()},
                    "credit_blocked_s": {r: ln["stats"].get("credit_blocked_s")
                                         for r, ln in lines.items()},
                    "server_queue": cs._server_queue(lines),
                    "frames": {r: frame_waits(ev[0], ev[r], r) for r in (1, 2)}}), flush=True)
                i += 1
    finally:
        cs._PS_RANK_SRC = src
    return 0


if __name__ == "__main__":
    sys.exit(main())
