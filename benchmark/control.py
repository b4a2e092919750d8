"""The control of a served cell's check, run on the card.

For each seed: one run of the cell as the benchmark makes it (its window
of ``--seconds`` and its check against the plain reference), then the
control: the reference itself with both operands of every projection
rounded to FP8-e4m3 (the precision below the bf16 that the
configurations state), put in the program's place. A served cell's
control runs over the same sampled prompts and served tokens, and at
each position the token that FP8 puts first is read against the float32
reference like a served one; a training cell's follows the checked
steps. (The program's own INT8 weight-only path keeps every activation
in bf16 and reads within 2-3x of the bf16 program; see PERF.md.)

``--faults`` also runs the program with each named fault of
``faults.py`` planted underneath. Prints one JSON line a seed with the
readings of the program (a sound run), the control and each fault.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 40
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_readings(ctx, shape, sample, rows) -> dict:
    """The readings of the tokens the FP8 reference puts first at every
    served position, against the float32 reference's ``rows``."""
    from benchmark import correctness
    firsts = [r.argmax(-1).tolist() for r in correctness.reference_rows(
        ctx, shape, sample, ctx.cell["kv_storage"], fp8=True)]
    changed = sum(a != b for f, (_, s) in zip(firsts, sample)
                  for a, b in zip(f, s))
    return dict(correctness.readings(rows, firsts), changed=changed)


def measure(name: str, seeds, seconds: float, faults=(), device="cuda:0"):
    """One row a seed: the program's readings, the control's, and each
    planted fault's (a run of the program with the fault underneath)."""
    from benchmark import arith, core
    from benchmark import faults as planted
    from benchmark.drivers import training
    for seed in seeds:
        t = time.perf_counter()
        ctx, out = core.run_driver(name, seed=seed, seconds=seconds,
                                   trace=False, device=device, t_start=t)
        shape = arith.Shape.from_config(ctx.config)
        if ctx.cell["driver"] == "training":
            control = training.compare(
                training.reference_steps(ctx, shape, fp8=True), out["ref"])
        else:
            control = control_readings(ctx, shape, out["sample"],
                                       out["rows"])
        row = {"workload": name, "seed": seed, "program": out["readings"],
               "control": control, "limits": ctx.cell["limits"],
               "correct": all(c["value"] <= c["limit"]
                              for c in out["checks"].values())}
        del out
        for fault in faults:
            with planted.FAULTS[fault]():
                _, bad = core.run_driver(name, seed=seed, seconds=seconds,
                                         trace=False, device=device,
                                         t_start=time.perf_counter())
            row[fault] = bad["readings"]
            del bad
        row["seconds"] = time.perf_counter() - t
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults of benchmark/faults.py")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for row in measure(args.workload,
                       [int(s) for s in args.seeds.split(",")],
                       args.seconds,
                       [f for f in args.faults.split(",") if f]):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
