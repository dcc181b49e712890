"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs `matten_tpu_torch` on the card: set-up, a window of whole
`Trainer.fit` epochs (`--trace 0`: the cell's end-to-end metrics) or a
profiled span of whole epochs (`--trace 1`: its per-layer metrics), then
the comparison with the plain reference that decides `correct`
(`harness.py`, `correctness.py`). The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers
compared, each beside its limit. Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 2; if JAX or the JAX
package is loaded once the run is over, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one intra-op thread: the fit loop's host work is one thread's, and idle
# OpenMP workers spinning beside it took three more cores of the host
os.environ["OMP_NUM_THREADS"] = "1"
# the checkout's root, not this folder, is the first place to import from
sys.path[0] = str(ROOT)
# the build and kernel caches of the program, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "matten_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    if cell["chips"] != 1:
        print(f"{args.workload} asks for {cell['chips']} cards; the harness drives one", file=sys.stderr)
        return 2

    from benchmark.harness import run_cell

    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
