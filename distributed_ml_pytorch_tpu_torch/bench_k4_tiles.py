"""Tile shapes of the tensor-core flash forward (K4, ``csrc/flash_fwd_tc.cu``)
timed in turns at GPT-2-small's attention shape (b8 h12 s2048 d64, bf16,
causal), beside SDPA's forward.

    python -m distributed_ml_pytorch_tpu_torch.bench_k4_tiles

Each variant is a copy of the source with its ``kWarps`` (16 query rows per
warp) and ``kBN`` (keys per tile) rewritten, built by ``nvcc`` with the
port's flags under ``build/k4_tiles/`` and loaded on its own, so the
package's kernel is not touched. Every variant is held against
``flash_fwd_plain`` at the bfloat16 tolerance before it is timed; the times
are ``utils/devtime.device_time`` means, taken in the order variants,
reversed, with SDPA first and last. Prints one JSON object. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys

import torch

SHAPE = (8, 12, 2048, 64)  # b, h, s, d
WARPS = (4, 8)             # warps per block, 16 query rows each
KEYS = (64, 128)           # keys per tile
CALLS = 50


def build_variants(warps, bns, root):
    """``{(warps, bn): (entry point, ptxas lines)}``, built in parallel."""
    from distributed_ml_pytorch_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_fwd_tc.cu").read_text()
    procs = {}
    for w in warps:
        for bn in bns:
            d = root / f"w{w}_bn{bn}"
            d.mkdir(parents=True, exist_ok=True)
            shutil.copy(_build.CSRC / "tc_frag.cuh", d)
            text = re.sub(r"constexpr int kWarps = \d+;", f"constexpr int kWarps = {w};", src)
            text = re.sub(r"constexpr int kBN = \d+;", f"constexpr int kBN = {bn};", text)
            (d / "k.cu").write_text(text)
            procs[(w, bn)] = (d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (d, proc) in procs.items():
        log = proc.communicate()[0]
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(d / "k.so")).dmt_flash_fwd_tc
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[key] = (fn, lines)
    return out


def main() -> int:
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import _build
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    if not torch.cuda.is_available():
        print("bench_k4_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    b, h, s, d = SHAPE
    fns = build_variants(WARPS, KEYS, _build.BUILD_ROOT.parent / "k4_tiles")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b * h, s, d), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    out_p, lse_p = at.flash_fwd_plain(q, k, v, True)
    scale = at.flash_error_scales(q, k, v, q, lse_p, torch.zeros_like(lse_p), True)["out"]
    atol, rtol = 1e-6, 2.0 ** -6  # chip_smoke.ATTN_TOL["bfloat16"]
    out, lse = torch.empty_like(q), torch.empty((b * h, s), device="cuda")

    def call(fn):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                b * h, s, s, d, 1, 1, d ** -0.5 * at.LOG2_E, _build.stream_of(q))
        _build.check(rc, "flash forward variant")
        return out

    res = {}
    for key, (fn, lines) in fns.items():
        call(fn)
        torch.cuda.synchronize()
        err = (out.float() - out_p.float()).abs()
        res[f"warps{key[0]}_bn{key[1]}"] = {
            "ptxas": lines, "ms": [],
            "err_over_bound": float((err / (atol + rtol * scale)).max()),
            "lse_err_over_bound": float(((lse - lse_p).abs()
                                         / (1e-5 + 1e-6 * lse_p.abs())).max())}
    q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
    res["sdpa"] = {"ms": []}
    order = ["sdpa", *fns, *reversed(list(fns)), "sdpa"]
    for key in order:
        if key == "sdpa":
            fn = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            name = "sdpa"
        else:
            fn = lambda key=key: call(fns[key][0])
            name = f"warps{key[0]}_bn{key[1]}"
        res[name]["ms"].append(device_time(fn, calls=CALLS, warmup=5).per_call_ms)
    flops = 4 * b * h * s * s * d / 2  # two products over the causal half
    for r in res.values():
        r["tflops"] = flops / (min(r["ms"]) * 1e-3) / 1e12
    print(json.dumps({"shape": SHAPE, "causal": True, "device":
                      torch.cuda.get_device_name(0), "variants": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
