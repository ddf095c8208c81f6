"""The analysis CLI: ``python -m distributed_ml_pytorch_tpu_torch.analysis``.

    python -m distributed_ml_pytorch_tpu_torch.analysis timeline <dump-dir> [--json]

``timeline`` merges the flight recorder's dumps of one run and attributes
the bubble and the wire (``analysis/timeline.py``). It is the only
subcommand: any other is refused by the parser.
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_ml_pytorch_tpu_torch.analysis import timeline


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(prog="python -m distributed_ml_pytorch_tpu_torch.analysis")
    sub = parser.add_subparsers(dest="command", required=True)
    tl = sub.add_parser("timeline", help="merge flight-recorder dumps; attribute the "
                                         "bubble and the wire")
    tl.add_argument("dump_dir", help="directory of flight_*.jsonl dumps (e.g. <run>/obs)")
    tl.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    args = parser.parse_args(argv)
    report = timeline.analyze(args.dump_dir)
    print(json.dumps(report, indent=2, sort_keys=True) if args.json
          else timeline.render(report))
    return 0 if report["n_dumps"] else 1
