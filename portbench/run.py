"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/`` and
the program, ``eco_tpu_torch``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
check compared, with its limit); standard error ends with the same numbers,
one a line.  Exits non-zero, printing no result, without enough CUDA
devices, or when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "eco_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program builds its kernels into eco_tpu_torch/_build/ of this
    # checkout; keep any other compiler cache here too, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "portbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "portbench_cache" / "extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    work = {w["name"]: w for w in spec.benchmark(ROOT)["workloads"]}
    if args.workload not in work:
        print(f"no workload {args.workload!r}; there are {sorted(work)}", file=sys.stderr)
        return 2
    chips = int(work[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                device="cuda:0", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures eco_tpu_torch alone",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
