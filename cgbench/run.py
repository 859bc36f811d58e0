"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m cgbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the earlier
lines of standard error say what the run saw, and its last lines give each
number the correctness check compared beside its limit.  It exits non-zero,
and prints no result, where no CUDA card is there (or fewer than the cell
asks for), where the port cannot be imported, or where JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .spec import REPO, Bench  # noqa: E402

#: the build and kernel caches, at fixed paths inside the checkout, so that
#: only a cell's first run there builds (the port's own CUDA library goes
#: to build/cuda/ beside it)
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"cgbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(REPO / rel)
    bench = Bench()
    chips = int(bench.workload(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return fail(f"needs {chips} CUDA card(s), found {found}", 2)
    from .harness import forbidden_modules, run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    loaded = forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package was loaded: {', '.join(loaded)}", 3)
    for name, c in result["compared"].items():
        if not math.isfinite(c["value"]):
            c["value"] = None  # JSON has no NaN; a missing number is not within a limit
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
