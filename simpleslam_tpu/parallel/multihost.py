"""Multi-host execution layer: ``jax.distributed`` + a multi-process harness.

The reference is single-process (SURVEY.md §2.3: no distributed code of any
kind); this layer is the framework's own multi-host component demanded by
the original brief (BASELINE.json). Responsibilities:

- ``init_distributed``: one-call ``jax.distributed.initialize`` wrapper a
  multi-host deployment uses on every host before building meshes; the
  coordinator address and process counts are explicit arguments.
- ``global_mesh`` / ``make_global_array``: build a mesh spanning every
  process's devices and assemble globally-sharded arrays from process-local
  shards (the multi-host analogue of ``jax.device_put`` — each host only
  touches its own partition; collectives ride the device interconnect
  within a host and the network across hosts, as XLA lays them out).
- ``run_hosts``: a subprocess launcher that simulates an N-host deployment
  on CPU (SURVEY.md §4: "simulate multi-host with jax.distributed
  multi-process CPU"). Each simulated host is one OS process with its own
  XLA CPU device(s) and a gRPC link to the coordinator — cross-process
  collectives exercise the same jax.distributed machinery a DCN deployment
  uses. Workers are addressed as ``module:function`` taking a JSON payload
  and returning a JSON-serializable result; optional core pinning gives each
  simulated host dedicated CPU cores so measured scaling is genuine
  (otherwise N processes share the same cores and speedups are fiction).

No reference counterpart to cite — SURVEY.md §5 "Distributed communication
backend" names this as a to-build component.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     platform: Optional[str] = None) -> None:
    """Initialize the jax.distributed runtime (no-op for a 1-process world).

    Call before any backend/device use on every host. ``platform`` forces
    the backend (the CPU simulation passes "cpu"; on a pod leave it None).
    """
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_names: Sequence[str] = ("kf",),
                shape: Optional[Sequence[int]] = None):
    """Mesh over ALL processes' devices (jax.devices() is global post-init)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    if shape is None:
        shape = [len(devs)] + [1] * (len(axis_names) - 1)
    return Mesh(np.asarray(devs).reshape(tuple(shape)), tuple(axis_names))


def make_global_array(local_np, mesh, spec):
    """Assemble a global array from this process's local shard data.

    ``local_np`` is the full logical array built identically on every process
    (cheap at SLAM scales); each process uploads only the rows its devices
    own. Uses ``make_array_from_callback`` so the same call works single- and
    multi-process.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        local_np.shape, sharding, lambda idx: local_np[idx])


def tree_make_global(tree_np, mesh, specs):
    """make_global_array over a pytree of (array, spec) pairs."""
    import jax

    return jax.tree.map(
        lambda a, s: make_global_array(a, mesh, s), tree_np, specs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_hosts(n_hosts: int, target: str, payload: Dict[str, Any],
              devices_per_host: int = 1, pin_cores: bool = False,
              timeout: float = 600.0) -> List[Any]:
    """Launch ``n_hosts`` CPU host processes running ``target`` (module:fn).

    Returns each host's JSON result (index = process id). The worker function
    receives ``(payload, num_processes, process_id)`` AFTER
    ``init_distributed`` has run, so jax.devices() spans all hosts.

    ``pin_cores`` assigns each host a distinct physical core via taskset
    (round-robin if n_hosts > cores) — required for honest scaling numbers.
    """
    coord = f"127.0.0.1:{_free_port()}"
    tmp = tempfile.mkdtemp(prefix="ssl_mh_")
    procs = []
    try:
        payload_path = os.path.join(tmp, "payload.json")
        with open(payload_path, "w") as f:
            json.dump(payload, f)
        n_cores = os.cpu_count() or 1
        for pid in range(n_hosts):
            env = dict(os.environ)
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "").replace(
                    "--xla_force_host_platform_device_count=8", "").strip()
                + f" --xla_force_host_platform_device_count={devices_per_host}"
            ).strip()
            cmd = [sys.executable, "-m", "simpleslam_tpu.parallel.multihost",
                   "--coordinator", coord, "--num-processes", str(n_hosts),
                   "--process-id", str(pid), "--target", target,
                   "--payload", payload_path,
                   "--out", os.path.join(tmp, f"out_{pid}.json")]
            if pin_cores:
                cmd = ["taskset", "-c", str(pid % n_cores)] + cmd
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        results: List[Any] = [None] * n_hosts
        errs = []
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()  # exact child PIDs only
                raise
            if p.returncode != 0:
                errs.append(f"host {pid} rc={p.returncode}:\n"
                            f"{err.decode(errors='replace')[-2000:]}")
                continue
            with open(os.path.join(tmp, f"out_{pid}.json")) as f:
                results[pid] = json.load(f)
        if errs:
            raise RuntimeError("multihost run failed:\n" + "\n".join(errs))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _worker_main() -> int:
    import argparse
    import importlib

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--payload", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     platform="cpu")
    mod_name, fn_name = args.target.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    with open(args.payload) as f:
        payload = json.load(f)
    result = fn(payload, args.num_processes, args.process_id)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
