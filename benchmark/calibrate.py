"""The readings that a configuration's limits are set from, on the card:

    python3 benchmark/calibrate.py --config NAME --traffic MIX --seeds S1 S2 ... [--controls K] [--out FILE]

For each seed, in one process: a run's set-up up to the compared steps
(`harness.Program`: the same data, weights, feed and call), then the
reference's steps, and the numbers `correctness.compare` gives for the
program (the lower readings). On the first K seeds also the control, the
reference with its float32 matmuls in TF32, and a planted fault, the
reference with every loss over half of each batch's crystals (the upper
readings). A step that leaves the state unchanged reads 1 on `grad_gap`
and `change_gap` without a run. One JSON line per seed and side.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["OMP_NUM_THREADS"] = "1"  # as benchmark/run.py runs
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import correctness
    from benchmark.harness import Program, load

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    config, mix = load("configs", args.config), load("traffic", args.traffic)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix="bench-cal-") as tmp:
            t = time.perf_counter()
            prog = Program(config, mix, seed, device, Path(tmp))
            program = prog.first.readings()
            weights, rows, files = prog.weights, prog.rows, prog.files
            prog.free()
            del prog
            ref_data = correctness.ReferenceData(config, files)
            reference = correctness.reference_readings(ref_data, rows, weights, device)
            sides = {"program": program}
            if i < args.controls:
                sides["control_tf32"] = correctness.reference_readings(ref_data, rows, weights, device, tf32=True)
                sides["fault_half_batch"] = correctness.reference_readings(ref_data, rows, weights, device,
                                                                           half_batch=True)
            for side, readings in sides.items():
                line = {"config": args.config, "seed": seed, "side": side,
                        "losses": reference.losses.tolist(), "eval_losses": reference.eval_losses.tolist(),
                        **correctness.compare(readings, reference),
                        "seconds": time.perf_counter() - t}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            del program, reference, sides, weights
            torch.cuda.empty_cache()
    print(f"calibrate: {len(args.seeds)} seeds in {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
