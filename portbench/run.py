"""The benchmark of the PyTorch and CUDA port (``chemlab_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with an NVIDIA GPU.  One run:
set-up from the seed (build, descent, cap retune, initiators, an untimed
block, regrowth), then whole 200-step blocks until ``--seconds`` have
passed, then the comparison with the plain reference
(``portbench/check.py``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
compared, each with its limit, are the last lines of standard error.
With ``--trace 0`` the metrics are the end-to-end ones, with
``--trace 1`` the per-layer ones of ``BENCHMARK.json``.

Exits with 2, printing no result, without a CUDA card, and with 3 if JAX
or the JAX package (``chemlab_tpu``) is loaded after the set-up or the
window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at a fixed path
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / ".portbench_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one process with few threads: the host paces the step, and thread pools
# that spin beside it only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


class BannedModules(RuntimeError):
    pass


def guard(when: str):
    from portbench.harness import banned_modules

    found = banned_modules()
    if found:
        raise BannedModules("loaded after the %s: %s"
                            % (when, ", ".join(found)))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cells_chips(workload: str) -> int:
    with open(ROOT / "portbench" / "workloads" / (workload + ".json")) as f:
        return int(json.load(f)["chips"])


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)
    need = cells_chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print("portbench: the cell needs %d CUDA card(s); %s" % (
            need, "found %d" % torch.cuda.device_count()
            if torch.cuda.is_available() else "CUDA is not available"),
            file=sys.stderr)
        return 2
    from portbench import harness

    try:
        result, checks = harness.run(
            ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
            device="cuda:0", guard=guard)
        guard("result")
    except BannedModules as exc:
        print("portbench: JAX must not run here: %s" % exc, file=sys.stderr)
        return 3
    for name, c in checks.items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
