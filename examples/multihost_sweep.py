"""Multi-host absorption-map sweep (DCN scale-out of BASELINE config #5).

The sweep mesh is host-count agnostic: the same ParameterSweep call that
vmaps a grid on one device shards it over every device of a multi-host
cluster.  Launch one copy of this script per host, naming the
coordinator:

    SLB2D_COORD=host0:8476 SLB2D_NPROCS=4 SLB2D_PROC_ID=k \
        python examples/multihost_sweep.py

Every process receives the full allgathered result table (the sweep
engine allgathers across hosts in ParameterSweep._fetch); process 0
prints it.  tests/test_multihost.py runs this exact code path as two
local CPU processes over Gloo.
"""

import os
import sys

import numpy as np

from slb2d_tpu.config import SimConfig
from slb2d_tpu.parallel import ParameterSweep, make_mesh
from slb2d_tpu.parallel.mesh import init_distributed
from slb2d_tpu.sweep_cli import HEADER


def main():
    import jax

    coord = os.environ.get("SLB2D_COORD")
    nprocs = os.environ.get("SLB2D_NPROCS")
    pid = os.environ.get("SLB2D_PROC_ID")
    init_distributed(
        coordinator_address=coord,
        num_processes=int(nprocs) if nprocs else None,
        process_id=int(pid) if pid else None)

    n_dev = len(jax.devices())
    if jax.process_index() == 0:
        print(f"# {jax.process_count()} process(es), {n_dev} global "
              f"device(s)", file=sys.stderr)

    cfg = SimConfig(
        display=4, E_dc=0.0, E_omega=1.5, omega=1.0, mu=1.0, alpha=0.9495,
        n_harmonics=12, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
        t_start=2.0, g_grid=100, dt=1e-3, quiet=True)

    # four E_dc points per device by default (SLB2D_POINTS_PER_DEV);
    # scale freely — B just has to divide evenly over the mesh
    B = n_dev * int(os.environ.get("SLB2D_POINTS_PER_DEV", "4"))
    e_dcs = np.linspace(0.1, 3.0, B)
    mesh = make_mesh((n_dev,), ("sweep",)) if n_dev > 1 else None

    res = ParameterSweep(cfg, {"E_dc": e_dcs}, mesh=mesh).run()

    if jax.process_index() == 0:
        sys.stdout.write(HEADER)
        for i in range(B):
            vals = [e_dcs[i], cfg.E_omega, cfg.omega, cfg.mu, cfg.alpha,
                    cfg.B]
            obs = [res[k][i] for k in (
                "v_dr_av", "v_y_av", "m_over_m_x_av", "A", "Asin",
                "v_dr_inst", "v_y_inst", "m_over_m_x_inst", "norm")]
            sys.stdout.write(
                " ".join(f"{float(v):.12e}" for v in vals + obs) + "\n")


if __name__ == "__main__":
    main()
