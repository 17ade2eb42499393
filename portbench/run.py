"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It builds the cell's scene from its configuration file, warms the
program up (its kernel libraries are built into the checkout's
`metalpathtracer_torch/_build/` on a checkout's first run, and every graph
of the cell's shape is captured), then runs passes back to back for
`--seconds`, and checks the images the passes produced against the plain
reference. The last line of standard output is the result object; with
`--trace 0` it holds the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics and the device's busy time from a profile of the first
passes. Without a card, or with fewer than the cell asks for, it exits
with code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(CHECKOUT))

# one host thread for the libraries' pools: the load is one process with
# few threads, which keeps the host's share of a pass steady
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# caches inside the checkout, at fixed paths, so that a checkout's later
# runs find what its first run built
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CHECKOUT / ".portbench_cache" / sub)


def card_line(torch) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return (f"[card] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
            f"device(s), torch {torch.__version__} CUDA {torch.version.cuda}; {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import bench, manifest

    cell = manifest.Cell(manifest.load_json(CHECKOUT / "BENCHMARK.json"), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        bench.log(f"no result: {cell.name} needs {cell.chips} CUDA card(s), "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(1)
    prog = None
    if int(cell.traffic.get("ranks", 1)) > 1:
        from harness import sharded

        prog = sharded.Leader(cell, args.seed, "cuda:0")
    try:
        result, lines = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                                  "cuda:0", T_START, prog)
    except BaseException:
        if prog is not None:
            prog.close(kill=True)
        raise
    bench.log(card_line(torch))
    found = bench.forbidden_modules()
    if found:
        bench.log(f"no result: forbidden modules loaded: {', '.join(found)}")
        return 4
    for line in lines:
        bench.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
