"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``rangeclip_tpu_torch``, on a machine with a CUDA card.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its
limit); the line before it holds the program's kernel launches in the
measured window.  The numbers compared are also the last lines of
standard error.  Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded, it prints no result and exits with
a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "portbench_cache"


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    """The card's name and power limit, which its peaks assume at 700 W."""
    import subprocess

    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() \
        else done.stderr.strip()


def main(argv=None) -> None:
    args = parse(argv)
    # the program's caches live inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA devices, "
             f"{torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    card = card_line()
    found = harness.forbidden_modules()
    if found:
        fail("modules of JAX or the JAX package were loaded: "
             + ", ".join(found))
    line = harness.result_line(cell, out, bool(args.trace), device)
    print("launch_counts " + json.dumps(out.launches, sort_keys=True))
    print(f"card {card}", file=sys.stderr)
    print(f"timing setup_s {out.setup_s!r} check_s {out.check_s!r} "
          f"phases {json.dumps(out.phases)}", file=sys.stderr)
    if out.detail:
        print("readings " + json.dumps(out.detail["gaps"]), file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              + (f" (worst leaf {c['leaf']})" if "leaf" in c else ""),
              file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
