"""``python3 -m bench_h100 --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on this machine's cards."""

import time

# set-up is timed from here, before torch is imported
T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m bench_h100", description=__doc__)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from bench_h100 import core

    sys.exit(core.main(parse(), T_START))
