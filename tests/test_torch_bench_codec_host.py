"""``bench_codec_host`` at a tiny size: one JSON object with every call's
times."""

import json

from distributed_ml_pytorch_tpu_torch import bench_codec_host


def test_bench_codec_host_prints_every_call(capsys):
    assert bench_codec_host.main(["--size", "3000", "--reps", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["size"] == 3000 and rec["reps"] == 2
    assert set(rec["ms"]) == {"adasum", "decode_int8", "encode_int8", "wal_record", "ddot_f64"}
    assert all(0.0 <= v["min_ms"] <= v["mean_ms"] for v in rec["ms"].values())
