#!/usr/bin/env python3
"""One run of one benchmark cell of panda_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``panda_tpu_torch/``)
and ``BENCHMARK.json``.  Prints what it does on standard error, ends it
with each number compared beside its limit, and prints one JSON object as
the last line of standard output.  Exits non-zero, with no result, when
there is no CUDA card (or fewer than the cell asks for), when the checkout
holds no program, or when the process has loaded jax, jaxlib, flax or the
JAX package (``panda_tpu``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r}", 2)
    chips = cells[args.workload]["chips"]
    # Every build cache stays inside the checkout at a fixed path: the
    # program's kernels build into build/panda_tpu_torch/ by themselves,
    # and these two hold whatever PyTorch or Triton would build.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}", 3)
    if not (ROOT / "panda_tpu_torch" / "__init__.py").is_file():
        return fail("no panda_tpu_torch in this checkout", 4)

    from benchmark.core import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda:0", root=ROOT,
                      t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded modules it must not: {bad}", 5)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['ok_if']} "
              f"{c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
