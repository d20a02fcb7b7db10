"""Benchmark of the PyTorch and CUDA port, ``dyglib_tpu_torch``: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints one JSON line (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with --trace 1 ``breakdown``, then ``checks``)
and exits 0; exits non-zero and prints no result where there is no card,
where the run loads JAX or the JAX package, or where anything fails.
The kernels' and the host library's builds stay in the checkout
(``dyglib_tpu_torch/build/``), and every other cache, Python's compiled
bytecode included, goes to ``.port_bench_cache/`` beside it.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".port_bench_cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("--seed must be a non-negative integer", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    # compiled bytecode of what the run imports (torch's own included, where
    # its installation keeps none): written by a checkout's first run, read
    # by the next ones
    sys.pycache_prefix = str(CACHE / "pycache")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(CHECKOUT))
    from port_bench import catalog, harness

    clock = harness.Clock()
    at_main = clock.since_start()
    try:
        cell = catalog.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    chips = cell.get("chips", 1)
    at_import = clock.since_start()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {count}",
              file=sys.stderr)
        return 1
    print(f"set-up: process start to main {at_main:.3f} s, torch imported at {at_import:.3f} s, "
          f"card found at {clock.since_start():.3f} s", file=sys.stderr)
    return harness.execute(cell, args.seed, args.seconds, bool(args.trace), clock)


if __name__ == "__main__":
    sys.exit(main())
