"""Absorption map over an (E_dc, omega) grid — BASELINE config #5.

The workflow arXiv:1401.6047's figures come from: for each drive point,
run to steady state and record the period-averaged drift velocity and
absorption A(omega).  With the reference this meant one process per point
driven through the stdin parameter server; here the whole grid is one
vmapped (optionally mesh-sharded) program.

Run (CPU demo):   python examples/absorption_map.py
Paper scale:      SLB2D_EXAMPLE_CPU=0 python examples/absorption_map.py paper
                  (BASELINE #2 point shape N=40 M=500, a 16x16
                  (E_dc, omega) grid; run it on a GPU)
On several GPUs:  the mesh line picks up all available devices.
"""

import os
import sys
import time

import numpy as np

if os.environ.get("SLB2D_EXAMPLE_CPU", "1") == "1":
    import jax
    jax.config.update("jax_platforms", "cpu")

from slb2d_tpu.config import SimConfig               # noqa: E402
from slb2d_tpu.parallel import ParameterSweep, make_mesh  # noqa: E402


def main():
    import jax
    paper = len(sys.argv) > 1 and sys.argv[1] == "paper"
    if paper:
        cfg = SimConfig(
            display=4, E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0,
            alpha=0.9495, n_harmonics=40, phi_y_min=-10.0, phi_y_max=10.0,
            B=0.1, t_start=5.0, g_grid=500, dt=1e-3, quiet=True)
        e_dc = np.linspace(0.0, 3.0, 16)
        omega = np.linspace(6.0, 14.0, 16)
    else:
        cfg = SimConfig(
            display=4, E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0,
            alpha=0.9495, n_harmonics=12, phi_y_min=-10.0,
            phi_y_max=10.0, B=0.1, t_start=2.0, g_grid=64, dt=1e-3,
            quiet=True)
        e_dc = np.linspace(0.0, 3.0, 7)
        omega = np.linspace(6.0, 14.0, 5)
    E, W = np.meshgrid(e_dc, omega, indexing="ij")

    n_dev = len(jax.devices())
    B = E.size
    mesh = make_mesh((n_dev,), ("sweep",)) if (n_dev > 1 and B % n_dev == 0) \
        else None

    sweep = ParameterSweep(cfg, {"E_dc": E.ravel(), "omega": W.ravel()},
                           mesh=mesh)
    print(f"# {B} points x {sweep.n_steps} steps on {n_dev} device(s) "
          f"[vmapped-xla engine]", file=sys.stderr)
    wall0 = time.perf_counter()
    res = sweep.run()
    wall = time.perf_counter() - wall0
    sites = 2 * (cfg.n_harmonics + 1) * (cfg.g_grid + 1)
    print(f"# wall {wall:.2f}s incl. compile; aggregate "
          f"{sites * sweep.n_steps * B / wall:.3e} site-updates/s",
          file=sys.stderr)

    A = res["A"].reshape(E.shape)
    v = res["v_dr_av"].reshape(E.shape)
    print("# absorption A(E_dc, omega):")
    print("# rows: E_dc = " + " ".join(f"{x:g}" for x in e_dc))
    print("# cols: omega = " + " ".join(f"{x:g}" for x in omega))
    for i in range(len(e_dc)):
        print(" ".join(f"{A[i, j]: .6e}" for j in range(len(omega))))
    print("# <v_dr>/v_p:")
    for i in range(len(e_dc)):
        print(" ".join(f"{v[i, j]: .6e}" for j in range(len(omega))))


if __name__ == "__main__":
    main()
