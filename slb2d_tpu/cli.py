"""Command-line entry point: `slb2d key=value ...` or
`python -m slb2d_tpu.cli key=value ...` — the exact reference CLI surface
(reference: src/boltzmann_cli.c, README.md:30-66) plus extensions
(impl=, dtype=, steps-per-chunk=, checkpoint=, resume=, profile-dir=,
compile-cache-dir=, shards=, frame-batch=, warmup=).
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import config as cfgmod
    try:
        cfg = cfgmod.parse_cmd(argv)
    except cfgmod.ConfigError:
        return 1

    import jax
    cfgmod.apply_jax_options(cfg)    # x64 mode, persistent compile cache

    if cfg.device:
        devs = jax.devices()
        if not (0 <= cfg.device < len(devs)):
            # the reference aborts when cudaSetDevice fails
            # (src/boltzmann_solver.c:77 via HANDLE_ERROR :14)
            print(f"invalid device ordinal in {__file__}",
                  file=sys.stderr)
            return 1
        jax.config.update("jax_default_device", devs[cfg.device])

    from .runtime.loop import Simulation

    sim = Simulation(cfg)
    if cfg.warmup:
        sim.warmup()
    if cfg.profile_dir:
        with jax.profiler.trace(cfg.profile_dir):
            sim.run()
    else:
        sim.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
