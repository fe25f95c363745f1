"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload chrom256.stream_k3 --seed 7 --seconds 30 --trace 0

From the root of a checkout. Needs a CUDA card (as many as the cell asks
for) and the ``apm_torch`` package beside this folder; exits non-zero and
prints no result without either. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``compared``:
each number compared with its limit); the last lines of standard error
repeat the numbers compared.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[0] = ROOT  # the packages live at the checkout's root, not in this folder
    import torch

    from benchmark import harness, spec

    chips = int(spec.find_cell(ROOT, args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2

    def log(line, file=sys.stdout):
        print(line, file=file, flush=True)

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START, log=log)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
