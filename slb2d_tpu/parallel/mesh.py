"""Device mesh helpers.

The scale-out axes of this solver (SURVEY.md §2.2): "sweep" — data-parallel
over parameter sets (the genuinely new capability vs the reference's serial
stdin parameter server) — and "space" — sharding the phi_y grid with halo
exchange for grids too large for one device.  Both are jax.sharding
collectives, which XLA hands to NCCL on GPUs; the reference has no
multi-device analogue to port.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape=None, axis_names=("sweep", "space"), devices=None) -> Mesh:
    """Build a mesh over the available devices.

    shape: tuple matching axis_names; None = all devices on the first axis.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {n}")
    dev_array = np.asarray(devices[:need]).reshape(shape)
    return Mesh(dev_array, axis_names)


def default_split(n: int) -> tuple[int, int]:
    """Factor n into (sweep, space) with space <= sweep, space in {1,2,4}."""
    for space in (4, 2, 1):
        if n % space == 0 and n // space >= space:
            return (n // space, space)
    return (n, 1)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize jax.distributed for multi-process meshes.

    Give the coordinator address (host:port), the process count and this
    process's id; where no cluster can be found (a single process) it
    returns False and the run stays single-process.  Sweep grids shard
    across processes exactly like across devices — the mesh code in this
    package is process-count agnostic.
    """
    import jax
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        return True
    except (ValueError, RuntimeError):
        return False
