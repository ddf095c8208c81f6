#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name, count and power limit, and the nvcc
   build of ``distributed_ml_pytorch_tpu_torch/csrc/*.cu``;
2. every kernel against its plain PyTorch version on the card, at the shapes
   of the main path (flat_axpy at AlexNet's padded length; relu_pool2
   forward and backward at AlexNet's three epilogue shapes at batch 64,
   ties included), bit-identical; with the kernel's, the plain version's and
   one library call's time (CUDA events, the launches queued behind a busy
   wait so the card runs them back to back) and the byte bound at 3.35 TB/s;
3. trainer steps of AlexNet(fused_epilogue=True) against the same steps of
   fused_epilogue=False (cuDNN deterministic, full float32): equal losses
   and parameters;
4. the main path: a parameter server and two workers in one process
   (threads, in-process transport) through ``run_server``/``train_worker``
   with the CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10)
   on synthetic CIFAR-10; the kernels' launch counts are zeroed just before
   and read just after, and every kernel must have run.

Then the ``kernels`` line, the ``nvidia-smi`` name/power line, and last the
result line ``{"ok": true, "device": {...}}``. Without a card, or without
the package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
ALEXNET_PADDED = 2_472_320
POOL_SHAPES = [(64, 8, 8, 64), (64, 4, 4, 192), (64, 2, 2, 256)]
WORKER_STEPS = 80


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches: the
    launches are queued behind a busy wait so host overhead does not show."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------------ phase 1

def phase_device_and_build(torch):
    from distributed_ml_pytorch_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    t0 = time.monotonic()
    _build.load("fused_update")
    _build.load("fused_conv")
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for ln in _build.build_logs().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device_and_build", "device": name,
          "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_build_s": _build.build_seconds,
          "ptxas": ptxas})


# ------------------------------------------------------------------ phase 2

def phase_kernels(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K1 flat_axpy at AlexNet's padded length, two alphas, bit-identical
    n = ALEXNET_PADDED
    y0 = torch.randn(n, generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    err = 0.0
    for alpha in (1.0, -0.008):
        yk = fu.flat_axpy_cuda(y0.clone(), x, alpha)
        yp = fu.flat_axpy_plain(y0.clone(), x, alpha)
        torch.cuda.synchronize()
        require(torch.equal(yk, yp), f"flat_axpy kernel != plain at alpha={alpha}")
        err = max(err, float((yk - yp).abs().max()))
    # cold: eight operand pairs in turn (158 MB) so no launch finds its
    # operands in the 50 MB L2; warm: one pair, which fits in L2
    pairs = [(y0.clone(), x.clone()) for _ in range(8)]
    turn = [0]

    def cold(fn):
        def call():
            yb, xb = pairs[turn[0] % len(pairs)]
            turn[0] += 1
            fn(yb, xb)
        return call

    ybuf = y0.clone()
    out["flat_axpy"] = {
        "max_abs_err": err,
        "ms": device_ms(torch, cold(lambda yb, xb: fu.flat_axpy_cuda(yb, xb, 1.0))),
        "plain_ms": device_ms(torch, cold(lambda yb, xb: fu.flat_axpy_plain(yb, xb, 1.0))),
        "library_ms": device_ms(torch, cold(lambda yb, xb: yb.add_(xb, alpha=1.0))),
        "warm_ms": device_ms(torch, lambda: fu.flat_axpy_cuda(ybuf, x, 1.0)),
        "warm_library_ms": device_ms(torch, lambda: ybuf.add_(x, alpha=1.0)),
        "bound_ms": bound_ms(3 * 4 * n),
        "note": f"n={n}: {3 * 4 * n} B; ms/plain_ms/library_ms cold (L2 flushed "
                f"by rotation), warm_* with the operands L2-resident",
    }

    # K2a/K2b relu_pool2 at AlexNet's three epilogue shapes, batch 64
    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "shapes": []}
    bwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
           "bound_ms": 0.0, "shapes": []}
    for shape in POOL_SHAPES:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        # forced ties: half-step values repeat inside windows, and windows of
        # negatives all tie at 0 after relu
        xt = torch.round(xr * 2) / 2
        pooled = (nb, h // 2, w // 2, c)
        gr = torch.randn(pooled, generator=g, device=dev)
        for xin in (xr, xt):
            for bias in (None, torch.randn(c, generator=g, device=dev)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                require(torch.equal(mk, mp), f"relu_pool2 fwd kernel != plain at {shape}")
                require(torch.equal(dk, dp), f"relu_pool2 bwd kernel != plain at {shape}")
                fwd["max_abs_err"] = max(fwd["max_abs_err"], float((mk - mp).abs().max()))
                bwd["max_abs_err"] = max(bwd["max_abs_err"], float((dk - dp).abs().max()))
        m = fc.relu_pool2_fwd_cuda(xr)
        x_cl = xr.permute(0, 3, 1, 2)  # NCHW shape, channels_last memory
        t_fwd = device_ms(torch, lambda: fc.relu_pool2_fwd_cuda(xr))
        t_bwd = device_ms(torch, lambda: fc.relu_pool2_bwd_cuda(xr, None, m, gr))
        row = {
            "shape": list(shape),
            "fwd_ms": t_fwd, "bwd_ms": t_bwd,
            "fwd_plain_ms": device_ms(torch, lambda: fc.relu_pool2_fwd_plain(xr)),
            "bwd_plain_ms": device_ms(torch, lambda: fc.relu_pool2_bwd_plain(xr, None, m, gr)),
            "fwd_library_ms": device_ms(torch, lambda: F.max_pool2d(F.relu(x_cl), 2)),
            "fwd_bound_ms": bound_ms(4 * (xr.numel() + m.numel())),
            "bwd_bound_ms": bound_ms(4 * (2 * xr.numel() + 2 * m.numel())),
        }
        for key, agg in (("fwd", fwd), ("bwd", bwd)):
            agg["ms"] += row[f"{key}_ms"]
            agg["plain_ms"] += row[f"{key}_plain_ms"]
            agg["bound_ms"] += row[f"{key}_bound_ms"]
        fwd["library_ms"] += row["fwd_library_ms"]
        fwd["shapes"].append(row)
    out["relu_pool2_fwd"] = fwd
    out["relu_pool2_bwd"] = bwd
    emit({"phase": "kernels_vs_plain", "ok": True, **{
        k: {kk: vv for kk, vv in v.items() if kk != "shapes"} for k, v in out.items()},
        "pool_shapes": fwd["shapes"]})
    return out


# ------------------------------------------------------------------ phase 3

def phase_trainer(torch, device="cuda", steps=5, batch=64):
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        make_train_step,
        to_device,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    x, y, *_ = load_cifar10(synthetic=True, n_train=steps * batch, n_test=16)
    runs = {}
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, seed=0, device=device)
        step = make_train_step(model, SGD(0.008))
        before = dict(fc.launches)
        losses = [float(step(*to_device(x[i * batch:(i + 1) * batch],
                                        y[i * batch:(i + 1) * batch], device)))
                  for i in range(steps)]
        runs[fused] = (losses, ravel_model_params(model),
                       {k: fc.launches[k] - before[k] for k in before})
    (lf, pf, kf), (lu, pu, _ku) = runs[True], runs[False]
    bit_equal = lf == lu and torch.equal(pf, pu)
    param_err = float((pf - pu).abs().max())
    loss_err = max(abs(a - b) for a, b in zip(lf, lu))
    emit({"phase": "trainer_fused_vs_unfused", "steps": steps, "batch": batch,
          "losses_fused": lf, "losses_unfused": lu, "bit_equal": bit_equal,
          "max_param_abs_err": param_err, "max_loss_abs_err": loss_err,
          "k2_launches": kf})
    # the kernels reproduce the unfused chain's numbers exactly, so equality
    # is expected; 1e-6 absolute is allowed only for cuDNN picking a
    # different deterministic algorithm between the two models' calls
    require(param_err <= 1e-6 and loss_err <= 1e-6,
            f"fused and unfused trainer steps disagree: params {param_err}, loss {loss_err}")
    if torch.device(device).type == "cuda":
        require(kf["relu_pool2_fwd"] == 3 * steps and kf["relu_pool2_bwd"] == 3 * steps,
                f"fused trainer steps launched the K2 kernels {kf} times")


# ------------------------------------------------------------------ phase 4

def phase_downpour(torch, device="cuda", steps=WORKER_STEPS, batch=64):
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import run_server, train_worker
    from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        MessageCode,
    )

    args = build_parser().parse_args([
        "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
        "--batch-size", str(batch), "--log-interval", str(10 * steps),
        "--worker-timeout", "0", "--log-dir", os.path.join(ROOT, "build", "smoke_runs"),
    ])
    world = InProcessTransport.create_world(3)
    results, errors = {}, []

    def guard(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    fu.launches = 0
    for k in fc.launches:
        fc.launches[k] = 0
    t0 = time.monotonic()
    # daemon threads: a hung world fails the run below instead of keeping
    # the process alive
    server = threading.Thread(target=guard, daemon=True,
                              args=("server", lambda: run_server(args, world[0])))
    workers = [threading.Thread(target=guard, daemon=True, args=(
        r, lambda r=r: train_worker(args, world[r], device=device))) for r in (1, 2)]
    server.start()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=600)
    server.join(timeout=60)
    wall = time.monotonic() - t0
    launches = {"flat_axpy": fu.launches, **fc.launches}
    require(not errors, "; ".join(errors))
    require(not server.is_alive() and not any(t.is_alive() for t in workers),
            "the DownPour world did not shut down")
    srv = results["server"]
    per_worker = {}
    for r in (1, 2):
        _model, logger = results[r]
        recs = logger.records
        losses = [rec["training_loss"] for rec in recs]
        span = (recs[-1]["timestamp"] - recs[5]["timestamp"]).total_seconds()
        sps = (len(recs) - 6) / span
        per_worker[r] = {"steps": len(recs), "early_loss": sum(losses[:10]) / 10,
                         "late_loss": sum(losses[-10:]) / 10,
                         "steps_per_s": sps, "images_per_s": sps * batch}
    counts = {c.name: n for c, n in srv.message_counts.items() if n}
    emit({"phase": "downpour_world", "workers": 2, "batch": batch, "wall_s": wall,
          "per_worker": per_worker, "server_messages": counts,
          "central_finite": bool(__import__("numpy").isfinite(srv.central).all()),
          "launches": launches})
    total_steps = sum(w["steps"] for w in per_worker.values())
    require(all(w["steps"] == steps for w in per_worker.values()), "workers took too few steps")
    require(srv.message_counts[MessageCode.GradientUpdate] >= 2 * (steps // 10),
            "server counted too few GradientUpdates")
    require(srv.message_counts[MessageCode.ParameterRequest] >= 2 * (steps // 10),
            "server counted too few ParameterRequests")
    require(__import__("numpy").isfinite(srv.central).all(), "central vector not finite")
    for r, w in per_worker.items():
        require(w["late_loss"] < w["early_loss"], f"worker {r} loss did not fall: {w}")
    if torch.device(device).type == "cuda":
        require(launches["flat_axpy"] == total_steps,
                f"flat_axpy launched {launches['flat_axpy']} times for {total_steps} steps")
        require(launches["relu_pool2_fwd"] > 0 and launches["relu_pool2_bwd"] > 0,
                f"relu_pool2 kernels not launched on the main path: {launches}")
    return launches


# ------------------------------------------------------------------ main

KERNEL_ROWS = [
    ("flat_axpy", "distributed_ml_pytorch_tpu_torch/csrc/fused_update.cu",
     "distributed_ml_pytorch_tpu/ops/fused_update.py:57"),
    ("relu_pool2_fwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:321"),
    ("relu_pool2_bwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:311"),
]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import distributed_ml_pytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAILED: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    try:
        phase_device_and_build(torch)
        measured = phase_kernels(torch)
        phase_trainer(torch)
        launches = phase_downpour(torch)
        smi = nvidia_smi_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": "bytes", "library_ms": m["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
