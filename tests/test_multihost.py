"""Genuine multi-process sweep: two local processes, 4 virtual CPU devices
each, jax.distributed + Gloo collectives — the code path a multi-host
cluster runs over its network (global NamedSharding over an 8-device "sweep"
mesh, result table allgathered to every process).  The reference has no
multi-node story at all (SURVEY §2.3); this pins ours numerically against a
single-process run."""

import json
import os
import subprocess
import sys

import numpy as np

from slb2d_tpu.config import SimConfig
from slb2d_tpu.parallel import ParameterSweep

WORKER = r'''
import json, os, sys
proc_id, nprocs, port, outfile = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nprocs, process_id=proc_id)
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

import numpy as np
from slb2d_tpu.config import SimConfig
from slb2d_tpu.parallel import ParameterSweep, make_mesh

cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
                alpha=0.9495, n_harmonics=8, phi_y_min=-10.0,
                phi_y_max=10.0, B=0.1, t_start=0.3, g_grid=24, dt=1e-3,
                quiet=True)
mesh = make_mesh((8,), ("sweep",))     # spans both processes
res = ParameterSweep(cfg, {"E_dc": np.linspace(0.25, 2.0, 8)},
                     mesh=mesh).run()
# every process has the full allgathered table; each writes its own copy
with open(outfile + f".{proc_id}", "w") as fh:
    json.dump({k: np.asarray(v, np.float64).tolist()
               for k, v in res.items()}, fh)
'''


def _free_port() -> str:
    """OS-assigned free TCP port (closed before use — a tiny race window,
    but unlike a fixed pid-derived port it cannot collide with an
    already-bound service and hang the Gloo rendezvous for the full
    subprocess timeout)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_sweep_matches_single_process(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outfile = str(tmp_path / "res.json")
    # children configure their own backend: scrub the parent's device env
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port, outfile],
        env=env, cwd="/root/repo",
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-3000:]

    results = [json.load(open(f"{outfile}.{i}")) for i in range(2)]
    # both processes hold the identical full table
    for k in results[0]:
        np.testing.assert_array_equal(results[0][k], results[1][k],
                                      err_msg=k)

    # single-process reference (8 virtual devices in THIS process)
    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
                    alpha=0.9495, n_harmonics=8, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=0.3, g_grid=24, dt=1e-3,
                    quiet=True)
    ref = ParameterSweep(cfg, {"E_dc": np.linspace(0.25, 2.0, 8)}).run()
    for k in ref:
        np.testing.assert_allclose(results[0][k], np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
