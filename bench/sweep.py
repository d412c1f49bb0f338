"""Find a serving cell's knee: offered rates one after another on one
engine, a row a rate on standard error and all rows as JSON on standard
output.

    python3 bench/sweep.py --workload <cell> --seed <n> --rates 1.5,2,2.5 \\
        --lead-in 20 --seconds 30

The knee is the highest rate at which the requests admitted keep pace with
arrivals: the queue waiting for admission does not grow over the window
(``waiting_last_fifth`` against ``waiting_first_fifth``) and the output
tokens follow the offered ones. The cell's ``rate_rps`` is 0.8 of it.
"""
import argparse
import json
import sys

import run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--lead-in", type=float, default=20.0)
    ap.add_argument("--seconds", type=float, default=30.0)
    a = ap.parse_args()
    run.setup_environment()
    import torch

    from pbench.manifest import Manifest

    man = Manifest()
    args = argparse.Namespace(workload=a.workload, seed=a.seed, seconds=a.seconds, trace=0,
                              control=0)
    ctx = run.Context(args, man, torch.device("cuda"), run.T_START)
    rows = man.kind(ctx.cell["kind"]).sweep(ctx, [float(r) for r in a.rates.split(",")],
                                            a.lead_in, a.seconds)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
