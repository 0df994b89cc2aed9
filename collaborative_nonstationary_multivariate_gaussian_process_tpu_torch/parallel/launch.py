"""Spawn the ranks of a gloo process group on this host and collect what
each returns.

    results = spawn("collaborative_..._torch.drivers.graft_entry:dryrun_rank", 2,
                    {"n_devices": 2}, timeout=300)

Each rank is a fresh `python -m <this module>` process that joins the group
at `tcp://127.0.0.1:<a free port>`, imports the target function by its
module path (the repository root and the caller's PYTHONPATH are on its
path; a child never imports the caller's script, so the bodies of ranks
live in importable modules), calls it with the keyword arguments, and
writes its JSON-able dict back, with the kernel launches it made
(`ops.cuda_kernels.LAUNCHES` is per process).  The caller waits at most
`timeout` seconds: a rank that fails or hangs fails the call, every rank
is then killed and the error carries each rank's last output.  The group's
own timeout is the same, so a collective that one rank never joins raises
in the others.  The backend is gloo, so every rank may share one card
(NCCL refuses two ranks on one GPU); a multi-GPU launch with NCCL is
torchrun's, joined by `parallel.mesh.initialize_distributed`.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["free_port", "spawn"]

_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def spawn(target: str, world: int, kwargs: Optional[dict] = None, *,
          timeout: float = 600.0) -> List[dict]:
    """Run `target` ("module:function") in `world` ranks; returns each
    rank's dict, in rank order, with its "launches".  Raises RuntimeError
    if a rank exits non-zero or the ranks outlast `timeout` seconds."""
    work = Path(tempfile.mkdtemp(prefix="ranks-"))
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the ranks share the host's cores
    child_env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            cmd = [sys.executable, "-m", __name__, "--target", target, "--rank", str(rank),
                   "--world", str(world), "--port", str(port),
                   "--timeout", str(timeout), "--kwargs", json.dumps(kwargs or {}),
                   "--out", str(work / f"rank{rank}.json")]
            with open(work / f"rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(cmd, env=child_env, stdout=log,
                                              stderr=subprocess.STDOUT, cwd=str(_ROOT)))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            logs = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                             f"{_tail(work / f'rank{r}.log')}" for r in range(world))
            late = "" if time.monotonic() <= deadline else f" (timed out after {timeout} s)"
            raise RuntimeError(f"{target} failed on ranks {failed} of {world}{late}:\n{logs}")
        return [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _main() -> int:
    ap = argparse.ArgumentParser(description="one rank of `spawn`")
    for name in ("--target", "--kwargs", "--out"):
        ap.add_argument(name, required=True)
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--timeout", type=float, required=True)
    a = ap.parse_args()

    import torch.distributed as dist

    from ..ops import cuda_kernels

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a.port}",
                            world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=a.timeout))
    try:
        module, name = a.target.split(":")
        fn = getattr(importlib.import_module(module), name)
        cuda_kernels.reset_launches()
        result = dict(fn(**json.loads(a.kwargs)))
        result["launches"] = dict(cuda_kernels.LAUNCHES)
        tmp = a.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, a.out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
