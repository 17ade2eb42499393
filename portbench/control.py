"""The control of the check: the plain reference computed in bfloat16, the
precision below the float32 the configurations state, put in the
program's place and judged by the same comparison as the program.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --passes <n>

For each seed it draws the checked pixels and passes as a run of `n`
passes would, computes the float32 reference's images and the bfloat16
reference's, and prints the compared numbers beside the cell's limits
(one JSON line a seed). The benchmark's own runs do not run it. Without a
card it runs on the CPU (`--device cpu`, at the tests' tiny sizes).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def control_numbers(cell, seed: int, passes: int, device) -> dict:
    import torch

    from harness import compare, reference, scene

    traffic, config = cell.traffic, cell.config
    width, height = int(traffic["width"]), int(traffic["height"])
    spp = int(traffic["spp_per_pass"])
    render = dict(config["render"], max_depth=int(traffic["max_depth"]))
    arrays = scene.build(config["scene"], cell.root)
    basis = reference.camera_basis(config["camera"], width, height)
    geo = reference.Geometry(arrays, device)
    pixels = compare.checked_pixels(geo, basis, width, height, seed,
                                    int(traffic["check_pixels"]))
    kept = sorted({0, min(compare.mid_pass(seed), passes - 1), passes - 1})
    counts = [(i + 1) * spp for i in kept]
    ref = compare.reference_images(geo, basis, width, height, render, seed, pixels,
                                   counts)
    low = reference.Geometry(arrays, device, torch.bfloat16)
    ctl = compare.reference_images(low, basis, width, height, render, seed, pixels,
                                   counts)
    return compare.numbers(ctl, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from harness import manifest

    cell = manifest.Cell(manifest.load_json(HERE.parent / "BENCHMARK.json"),
                         args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, args.passes, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed, "passes": args.passes,
                          "control": nums, "limits": cell.limits,
                          "fails": [k for k in nums if nums[k] > cell.limits[k]],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
