"""The control of a cell's correctness check: the plain reference put in the
program's place and computed in the nearest precision below the one the
configuration states (float32 -> TF32), judged by the same numbers as the
program. It must come out not correct. The benchmark's own runs never run
it.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

prints one JSON line per seed: the numbers beside the cell's limits.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.harness import manifest  # noqa: E402
from benchmark.inputs import recordings  # noqa: E402
from benchmark.reference import identify_check, rigid_body  # noqa: E402


def control_numbers(root, workload, seed, device) -> dict:
    man = manifest.load(root)
    cell = manifest.workload(man, workload)
    config = manifest.config(root, man, cell["config"])
    spec = manifest.traffic(root, cell["traffic"])
    if spec["kind"] != "identify":
        raise ValueError(f"no control for kind {spec['kind']!r}")
    robot = rigid_body.load_urdf(os.path.join(root, config["urdf"]))
    recs = [recordings.make(robot, spec, seed, k, device) for k in range(int(spec["recordings"]))]
    refs = identify_check.reference_side(robot, recs, spec["options"], device)
    units, base_rows = identify_check.control_units(robot, recs, spec["options"], device)
    numbers = identify_check.judge(units, refs, robot.num_links, base_rows)
    return {k: {"value": numbers[k], "limit": spec["limits"][k]} for k in spec["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for seed in (int(s) for s in a.seeds.split(",")):
        checks = control_numbers(root, a.workload, seed, a.device)
        correct = all(v["value"] <= v["limit"] for v in checks.values())
        print(json.dumps({"workload": a.workload, "seed": seed, "correct": correct,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
