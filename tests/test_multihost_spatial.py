"""Multi-process SPATIAL simulation: two Gloo-backed CPU processes, the
phi_y grid halo-sharded over an 8-device "space" mesh that spans both.

This drives the REAL Simulation driver across a process boundary — the
code path a multi-host pod slice runs when one grid is too large for a
single host's chips: lockstep schedules, ppermute halos over the global
mesh, allgathered state fetches (Simulation._fetch_np), process-0-only
file writes, and the broadcast parameter server.  Pinned numerically
against an unsharded single-process run (f64: disagreement beyond
reduction-order noise is a wiring bug)."""

import os
import subprocess
import sys

import numpy as np

from slb2d_tpu.config import SimConfig
from slb2d_tpu.runtime.loop import Simulation

WORKER = r'''
import io, os, sys
proc_id, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # dtype=f64 runs below
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nprocs, process_id=proc_id)
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

os.chdir(outdir)
from slb2d_tpu.config import SimConfig
from slb2d_tpu.runtime.loop import Simulation

COMMON = dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9495,
              n_harmonics=8, phi_y_min=-5.0, phi_y_max=5.0, B=0.1,
              t_start=0.2, g_grid=32, dt=1e-3, quiet=True, dtype="f64",
              shards=8)

# run 1: movie frames (emission fetches are collectives; p0 writes files)
Simulation(SimConfig(display=7, out_file="d7.txt", **COMMON)).run()

# run 2: display-4 with one broadcast parameter-server mutation
sim = Simulation(SimConfig(display=4, out_file="d4.txt",
                           checkpoint="ck.npz", **COMMON))
sim.run(repl_stream=io.StringIO("E_dc 1.5 0.1\nexit\n"))

print("worker", proc_id, "done")
'''


def _free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_spatial_matches_unsharded(tmp_path, monkeypatch):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outdir = tmp_path / "mh"
    outdir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port, str(outdir)],
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
        assert p.returncode == 0, o.decode()[-3000:]

    # single-process unsharded reference
    ref = tmp_path / "ref"
    ref.mkdir()
    monkeypatch.chdir(ref)
    COMMON = dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9495,
                  n_harmonics=8, phi_y_min=-5.0, phi_y_max=5.0, B=0.1,
                  t_start=0.2, g_grid=32, dt=1e-3, quiet=True,
                  dtype="f64")
    import io as _io
    Simulation(SimConfig(display=7, out_file="d7.txt", **COMMON)).run()
    sim = Simulation(SimConfig(display=4, out_file="d4.txt", **COMMON))
    sim.run(repl_stream=_io.StringIO("E_dc 1.5 0.1\nexit\n"))

    # display-4 lines (initial round + one mutation round)
    for fname in ("d4.txt",):
        mh = [np.array(l.split(), float)
              for l in open(outdir / fname) if not l.startswith("#")]
        rf = [np.array(l.split(), float)
              for l in open(ref / fname) if not l.startswith("#")]
        assert len(mh) == len(rf) == 2
        for a, b in zip(mh, rf):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)

    # movie frames: identical files from the sharded multi-process run
    frames_mh = sorted(f for f in os.listdir(outdir)
                       if f.startswith("frame"))
    frames_ref = sorted(f for f in os.listdir(ref)
                        if f.startswith("frame"))
    assert frames_mh == frames_ref and len(frames_mh) >= 5
    for f in frames_mh[::4]:
        va = [l for l in open(outdir / f) if not l.startswith("#")]
        vb = [l for l in open(ref / f) if not l.startswith("#")]
        assert len(va) == len(vb)
        for la, lb in zip(va[::37], vb[::37]):
            np.testing.assert_allclose(
                float(la.split()[2]), float(lb.split()[2]),
                rtol=1e-12, atol=1e-14)

    # checkpoint written once, by process 0
    assert os.path.exists(outdir / "ck.npz")
