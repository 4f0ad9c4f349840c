"""``calibrate.py`` for a cell whose mix names another driver than
``fullgraph``: the same readings, taken through the mix's own driver (its
``build_graph`` and ``Run``); not run by the benchmark.

    python benchmark/calibrate_driver.py --workload gcn_products-clustered \\
        --seeds 11,12,13 --control-seeds 21,22,23 --out readings.jsonl
"""

from __future__ import annotations

import argparse
import importlib
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import calibrate, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    args, _ = ap.parse_known_args(argv)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    _, _, mix, _ = harness.cell_files(spec, args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    # calibrate.main builds the graph and its runs through these two names
    calibrate.fullgraph = types.SimpleNamespace(build_graph=driver.build_graph,
                                                FullGraphRun=driver.Run)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
