"""Scaling-efficiency harness: 1 process vs N processes on the virtual
CPU mesh (or a real pod when run there).

Usage:  python tools/scaling_bench.py [nprocs] [mb]

Spawns `measure_encode_throughput` workers under jax.distributed for
P = 1 and P = nprocs (each process gets devices_per_proc virtual CPU
devices) over the same total corpus, and reports

    efficiency = (bytes_per_s_P / P) / bytes_per_s_1

the ≥90% 2-host metric from BASELINE.json.  Every process — including
the P = 1 baseline — is taskset-pinned to its own physical core
(round-robin when nprocs > cores), so per-process compute resources
are equal across topologies and the ratio isolates PROTOCOL overhead
instead of core contention (round-3 harness lacked pinning and
measured 0.28 that was mostly timeslicing).  Each worker also reports
its compute vs collective split (the final all-gather), so a low
efficiency is attributable.  On a real multi-host cluster the same
harness measures the interconnect overhead.

Writes SCALING.json at the repo root.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import jax
jax.config.update("jax_platforms", "cpu")
port, pid, nproc, nbytes = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
sys.path.insert(0, %r)
from data_compression_tpu.config import CodecConfig
from data_compression_tpu.parallel.multihost import measure_encode_throughput

cfg = CodecConfig(codec="huffman", arity=2, block_size=65536, chunk_syms=512)
r = measure_encode_throughput(cfg, nbytes)
print("THROUGHPUT " + json.dumps(r), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_topology(nproc: int, dev_per_proc: int, nbytes: int) -> dict:
    port = _free_port()
    script = _WORKER % (dev_per_proc, REPO)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    ncores = os.cpu_count() or 1
    procs = [
        subprocess.Popen(
            # pin each worker (and the 1-proc baseline) to its own core:
            # equal per-process compute across topologies
            ["taskset", "-c", str(pid % ncores), sys.executable, "-c",
             script, str(port), str(pid), str(nproc), str(nbytes)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=REPO,
        )
        for pid in range(nproc)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{err[-2000:]}")
        for line in out.splitlines():
            if line.startswith("THROUGHPUT"):
                results.append(json.loads(line.split(" ", 1)[1]))
    return results[0]


def main() -> int:
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    mb = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    nbytes = mb * 1024 * 1024
    dev_per_proc = 4

    r1 = run_topology(1, dev_per_proc, nbytes)
    rN = run_topology(nproc, dev_per_proc, nbytes)
    eff = (rN["bytes_per_s"] / nproc) / r1["bytes_per_s"]
    report = {
        "metric": "multihost_scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction (per-process throughput at N procs / 1 proc)",
        "processes": nproc,
        "devices_per_process": dev_per_proc,
        "corpus_mb": mb,
        "single_proc": r1,
        "multi_proc": rN,
        "cores": os.cpu_count(),
        "note": "virtual CPU mesh, one pinned core per process (incl. the "
        "P=1 baseline): the ratio isolates protocol overhead; compute_s vs "
        "collective_s in the worker reports attributes any residual",
    }
    with open(os.path.join(REPO, "SCALING.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
