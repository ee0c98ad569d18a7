"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the step below the program's float32
integer regime, judged by the same check as a run, against the same
limits: ``max_support``'s is the configuration's ``exact_limit`` less 1.
A control has to come out as not correct.

    python3 tipbench/control.py --workload chunglu_marvel.decompose \
        --seeds 1 2 3 --answers 8

For each seed it prints one JSON line with the numbers compared, at the
cell's own sizes, on the answers a run would produce first (the mix's
graphs or cycles, drawn from that seed).  The benchmark's runs never run
it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE.parent))


def control_readings(spec, seed: int, answers: int, device) -> dict:
    """The check's numbers for the bfloat16 reference's answers to the
    first ``answers`` requests of the cell under ``seed``."""
    import torch

    from tipbench import harness, loops

    traffic = spec["traffic"]
    loop = loops.LOOPS[traffic["loop"]](spec["config"], traffic, seed,
                                        device)
    loop.prepare()
    got = {k: loop.expected(k, dtype=torch.bfloat16)[0]
           for k in range(answers)}
    return harness.check(loop, list(range(answers)), answer_of=got.get)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--answers", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    from tipbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_readings(spec, seed, args.answers, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "answers": args.answers, "checks": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
