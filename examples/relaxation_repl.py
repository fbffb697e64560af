"""Relaxation study through the interactive parameter server — the
reference's signature workflow (src/boltzmann_cli.c:71-91): run to a
steady state, print the display-4 observable line, then mutate ONE drive
parameter and continue from the LIVE distribution (it is never reset),
letting the system relax for `timeout` before averaging restarts.

Here the same protocol drives the device engines; the distribution stays
device-resident across mutations.

Run (CPU demo):   python examples/relaxation_repl.py
"""

import io
import os
import sys

if os.environ.get("SLB2D_EXAMPLE_CPU", "1") == "1":
    import jax
    jax.config.update("jax_platforms", "cpu")

from slb2d_tpu.config import parse_cmd              # noqa: E402
from slb2d_tpu.runtime.loop import Simulation       # noqa: E402


def main():
    cfg = parse_cmd([
        "display=4", "E_dc=0.5", "E_omega=1.5", "omega=10.0", "mu=1.0",
        "alpha=0.9495", "n-harmonics=12", "PhiYmin=-8", "PhiYmax=8",
        "B=0.1", "t-max=0.6", "g-grid=64", "dt=0.001", "quiet=1",
        "read-from=stdin", "o=stdout"])

    # protocol: "name value timeout" per round, "exit" to stop —
    # exactly what the reference's scan_for_new_parameters reads
    script = io.StringIO(
        "E_dc 1.0 0.3\n"
        "E_dc 1.5 0.3\n"
        "B    0.3 0.3\n"
        "exit\n")

    print("# relaxation study: each line below is one steady state; the "
          "distribution persists across parameter changes", file=sys.stderr)
    Simulation(cfg).run(repl_stream=script)


if __name__ == "__main__":
    main()
