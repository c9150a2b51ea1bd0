"""The control of ``correct``, at a cell's own size: for each seed, the
cell's set-up and a short window, then the numbers compared for the
program and for the reference in bfloat16 put in the program's place.
The control has to come out not correct; the program's readings are the
lower ones the limits are set above.  Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 1
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, device,
             overrides=None) -> dict:
    """{"program": numbers, "control": numbers, "events": n} of one
    seed."""
    import torch

    from portbench import harness
    from portbench.reference import system as ref_system

    cell, conf, traffic = harness.load_cell(ROOT, workload)
    sys_ = ref_system.load_system(conf["system"])
    seeds = harness.sub_seeds(seed)
    prog = harness.import_program()
    su = harness.set_up(prog, conf, traffic, seeds, device, sys_,
                        overrides or {})
    try:
        win = harness.run_window(prog, su, traffic, seeds, seconds, device,
                                 False)
        out = harness.program_step(prog, su, win, seeds, device)
        mine, events = harness.compare(sys_, su, out, seeds, device)
        ctl, _ = harness.compare(sys_, su, out, seeds, device,
                                 torch.bfloat16)
    finally:
        if su.table_dir:
            import shutil
            shutil.rmtree(su.table_dir, ignore_errors=True)
    limits = cell["limits"]
    from portbench.check import judge
    return {"seed": seed, "events": events, "program": mine,
            "program_correct": judge(mine, limits), "control": ctl,
            "control_correct": judge(ctl, limits)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(readings(a.workload, seed, a.seconds, "cuda:0")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
