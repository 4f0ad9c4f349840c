"""Run one cell of the port's benchmark once; print its result line.

    python benchmark/run.py --workload gcn_arxiv-clustered --seed 7 --seconds 10 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` the
per-layer metrics and ``breakdown``; ``compared`` last: each number the
check compared, with its limit). The compared numbers are also the last
lines of standard error. Needs a CUDA card: without one, or without the
cards the cell asks for, it exits with code 3 and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # the benchmark package and the program under test

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                  bool(args.trace), t0=T0)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"refused: modules {found} are loaded in the benchmark's process", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
