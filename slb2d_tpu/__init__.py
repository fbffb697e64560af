"""slb2d: superlattice Boltzmann solver in JAX.

A reimplementation of priimak/super-lattice-boltzmann-2d: the
finite-difference time-stepping over the (harmonics x phi_y grid)
distribution arrays runs as fused XLA stencils inside lax.scan, with
vmapped/sharded parameter sweeps as the scale-out axis.
"""

from .config import SimConfig, parse_cmd  # noqa: F401
from .models.superlattice import SuperlatticeModel  # noqa: F401
from .ops.stencil import State, bootstrap_state, consts_from_model  # noqa: F401


def run_simulation(cfg, out=None, repl_stream=None):
    """Convenience: build and run a Simulation; returns the final State."""
    from .runtime.loop import Simulation
    return Simulation(cfg, out=out).run(repl_stream=repl_stream)

__version__ = "0.1.0"
