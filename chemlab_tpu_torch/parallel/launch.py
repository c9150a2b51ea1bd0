"""Start D ranks of a ``torch.distributed`` process group and run named
jobs of the port (``parallel.jobs``) on each.

    from chemlab_tpu_torch import bridge
    from chemlab_tpu_torch.parallel import launch
    (per_rank,) = launch.run_jobs(
        [("run_blocks", dict(system=bridge.to_numpy(cfg, spec, state),
                             n_blocks=2, block_steps=200, seed=1))],
        4, store_dir, backend="nccl")

Each rank is a fresh interpreter running this module with one intra-op
thread, so nothing of the caller's process (its imports, its threads)
reaches the ranks.  The group
is initialised from a ``file://`` store in ``store_dir``, a directory the
caller owns: no TCP port is shared, so launches from concurrent test
workers never collide.  The jobs and their arguments go to the ranks as a
pickle in ``store_dir`` and each rank's results come back the same way,
tensors as numpy arrays, one list per job with one entry per rank.

The backend is the caller's: ``nccl`` across cards, ``gloo`` on the CPU
and for several ranks sharing one card (NCCL refuses two ranks on one
GPU); nothing switches backend on a failure.  ``device`` is every rank's
device (``sharding.make_mesh``): None gives rank r ``cuda:r``.  If a rank
fails, the others are stopped and ``run_jobs`` raises with its traceback.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

PKG_PARENT = Path(__file__).resolve().parent.parent.parent


def run_jobs(jobs, n_ranks: int, store_dir, *, backend: str, device=None,
             timeout: float = 600.0) -> list:
    """Run ``jobs`` ([(name, kwargs), ...], in order) on ``n_ranks`` ranks;
    returns, per job, the list of the ranks' results."""
    store = Path(store_dir).resolve()
    store.mkdir(parents=True, exist_ok=True)
    for stale in [store / "group", *store.glob("result.*.pkl")]:
        stale.unlink(missing_ok=True)
    with open(store / "jobs.pkl", "wb") as f:
        pickle.dump(dict(jobs=list(jobs), backend=backend, device=device,
                         world=n_ranks), f)
    env = dict(os.environ, WORLD_SIZE=str(n_ranks))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG_PARENT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                             else []))
    procs, logs = [], []
    try:
        for r in range(n_ranks):
            log = open(store / ("rank%d.log" % r), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name, str(store), str(r)],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT, cwd=str(PKG_PARENT)))
        deadline = time.monotonic() + timeout
        # a rank that fails would leave the others waiting in a collective
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError("the %d ranks did not finish in %.0f s"
                                   % (n_ranks, timeout))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    outs = {}
    for r in range(n_ranks):
        res = store / ("result.%d.pkl" % r)
        if res.exists():
            with open(res, "rb") as f:
                outs[r] = pickle.load(f)
    # a rank's own error first: the others may only have been stopped
    for r, out in sorted(outs.items()):
        if not out["ok"]:
            raise RuntimeError("rank %d failed:\n%s" % (r, out["error"]))
    for r, p in enumerate(procs):
        if r not in outs:
            tail = (store / ("rank%d.log" % r)).read_text()[-4000:]
            raise RuntimeError("rank %d exited with %s and no result:\n%s"
                               % (r, p.returncode, tail))
    return [[outs[r]["results"][j] for r in range(n_ranks)]
            for j in range(len(jobs))]


def _to_numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _rank_main(store: Path, rank: int) -> int:
    """One rank: join the group, run the jobs, write the results."""
    import torch
    import torch.distributed as dist

    with open(store / "jobs.pkl", "rb") as f:
        plan = pickle.load(f)
    torch.set_num_threads(1)
    out = {"ok": False}
    try:
        dist.init_process_group(plan["backend"],
                                init_method="file://%s" % (store / "group"),
                                rank=rank, world_size=plan["world"])
        from . import jobs
        from .sharding import make_mesh

        mesh = make_mesh(device=plan["device"])
        if mesh.device.startswith("cuda"):
            torch.cuda.set_device(mesh.device)
        out["results"] = [_to_numpy(jobs.JOBS[name](mesh, **kwargs))
                          for name, kwargs in plan["jobs"]]
        out["ok"] = True
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        with open(store / ("result.%d.tmp" % rank), "wb") as f:
            pickle.dump(out, f)
        os.replace(store / ("result.%d.tmp" % rank),
                   store / ("result.%d.pkl" % rank))
        if out["ok"] and dist.is_initialized():
            dist.destroy_process_group()
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(_rank_main(Path(sys.argv[1]), int(sys.argv[2])))
