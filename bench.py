"""Benchmark: lattice-site updates/sec of the solver on one GPU.

Metric (BASELINE.md): site-updates/sec = 2*(N+1)*(M+1)*steps / wall.
Default mode: the end-to-end Simulation driver at BASELINE config #4
(n-harmonics=100, g-grid=4000, float32, display 4), compile excluded.
Baseline to beat: 1e9 updates/sec (BASELINE.json).

Usage:
  python bench.py                       end-to-end driver, impl=auto
  python bench.py driver [impl] [exact|fast] [display]
  python bench.py xla [M] [N]           step loop only (no driver)
  python bench.py f64 [M] [N]           XLA scan, float64
  python bench.py sweep [E_dc|omega]    64-point sweep, N=40 M=500
  python bench.py movie [frame-batch]   display-7 movie, N=20 M=1000

Prints ONE JSON line naming the device it ran on (platform, device_kind,
device count, power limit) and the engine that ran.  It runs on a GPU;
on any other backend it exits 1 without a number, unless --cpu-smoke is
given (the CPU test of this harness).
"""

import json
import subprocess
import sys
import time

import jax
import numpy as np

from slb2d_tpu.config import SimConfig, open_out as cfgmod_open_out
from slb2d_tpu.models.superlattice import SuperlatticeModel
from slb2d_tpu.ops import stencil
from slb2d_tpu.utils import env

BASELINE = 1e9  # updates/sec north star (BASELINE.json)


def power_limit():
    """`name, power.limit` of the first GPU as nvidia-smi reports them
    (a child process that stays off JAX), or None without nvidia-smi."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = r.stdout.strip().splitlines()
    return line[0].strip() if r.returncode == 0 and line else None


def device_info():
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "power_limit": power_limit()}


def build(impl: str, N=100, M=4000, dtype="f32"):
    """(model, state, run, engine): run(state, n_steps) advances the
    fast-trig step loop n_steps on the engine impl resolves to."""
    cfg = SimConfig(display=8, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
                    alpha=0.9495, n_harmonics=N, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=10.0, g_grid=M, dt=1e-3,
                    impl=impl, dtype=dtype)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model)
    state = stencil.bootstrap_state(c, model)
    plan = env.plan(impl, dtype)
    step = stencil.make_step_fn(c, av_enabled=False, exact_trig=False)

    def body(s, n_steps):
        return jax.lax.scan(step, s, None, length=n_steps,
                            unroll=env.SCAN_UNROLL)[0]

    run = jax.jit(body, static_argnums=1, donate_argnums=0)
    return model, state, run, plan.engine


def bench(impl: str, chunk=1000, reps=20, N=100, M=4000, dtype="f32"):
    model, state, run, engine = build(impl, N, M, dtype)
    state = jax.block_until_ready(run(state, chunk))   # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        state = run(state, chunk)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    assert np.all(np.isfinite(np.asarray(state.a))), "state went non-finite"
    steps = chunk * reps
    updates = 2 * (model.N + 1) * (model.M + 1) * steps
    return updates / wall, wall, steps, engine


def rerun(sim):
    """Run a warmed-up Simulation again from its initial state; returns
    the wall seconds of sim.run() (compile excluded by the warm-up)."""
    sim.state = stencil.bootstrap_state(sim.c, sim.model)
    sim.t0 = 0.0
    sim.steps_done = 0
    sim.frame_number = 1
    sim.frame_time = 0.0
    sim.out = cfgmod_open_out(sim.cfg)
    t0 = time.perf_counter()
    sim.run()
    return time.perf_counter() - t0


def bench_driver(impl: str, N=100, M=4000, t_start=10.0, exact_time=True,
                 display=4):
    """End-to-end product throughput: the real Simulation driver (schedule
    generation, chunked scan, emission machinery, final output write).
    Compile time is excluded via Simulation.warmup(); best of 3 runs."""
    import os
    import tempfile

    from slb2d_tpu.runtime.loop import Simulation

    cfg = SimConfig(display=display, E_dc=1.0, E_omega=2.0, omega=1.0,
                    mu=1.0, alpha=0.9495, n_harmonics=N, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=t_start, g_grid=M,
                    dt=1e-3, impl=impl, quiet=True, exact_time=exact_time,
                    out_file="obs.txt")
    cwd = os.getcwd()
    os.chdir(tempfile.mkdtemp())
    try:
        sim = Simulation(cfg)
        sim.warmup()
        wall = min(rerun(sim) for _ in range(3))
    finally:
        os.chdir(cwd)
    steps = sim.steps_done
    updates = 2 * (sim.model.N + 1) * (sim.model.M + 1) * steps
    return updates / wall, wall, steps, sim.impl


# Device-memory bandwidth by jax device_kind (NVIDIA H100 SXM data sheet:
# 3.35 TB/s at the 700 W limit).  A device not listed has no assumed peak.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_bytes_per_s(device_kind: str) -> float:
    if device_kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no device-memory peak known for {device_kind!r}")
    return PEAK_BYTES_PER_S[device_kind]


def step_bytes(model) -> int:
    """Compulsory device-memory traffic of one time step: the four state
    arrays (a, b, a_hs, b_hs) read and written once each, a0 and a0_ghost
    read once -- ten (NHP, MP) arrays.  The averaging rows are negligible."""
    return 10 * model.NHP * model.MP * np.dtype(model.np_dtype).itemsize


def _union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_trace_summary(trace_dir: str, n_steps: int,
                         plane_prefix: str = "/device:GPU") -> dict:
    """Reduce a jax.profiler trace of n_steps time steps to per-step device
    metrics: kernel launches, memory copies, device busy time (the union
    of the op intervals on the device's stream lines), the window from the
    first op's start to the last op's end, and the idle share of that
    window.  top: the eight ops (kernels or copies) with the most device
    time, in us per step."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise FileNotFoundError(f"{len(paths)} .xplane.pb under {trace_dir}")
    kernels, copies, spans, per_name, lines = 0, 0, [], {}, set()
    for plane in ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if "memcpy" in ev.name.lower():
                    copies += 1
                else:
                    kernels += 1
                per_name[ev.name] = per_name.get(ev.name, 0) + \
                    ev.duration_ns
    if not spans:
        return {"kernels_per_step": 0.0, "copies_per_step": 0.0,
                "busy_us_per_step": 0.0, "window_us_per_step": 0.0,
                "idle_share": None, "lines": sorted(lines), "top": []}
    busy = _union_ns(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return {"kernels_per_step": kernels / n_steps,
            "copies_per_step": copies / n_steps,
            "busy_us_per_step": busy / 1e3 / n_steps,
            "window_us_per_step": window / 1e3 / n_steps,
            "idle_share": 1 - busy / window if window else 0.0,
            "lines": sorted(lines),
            "top": [(k, v / 1e3 / n_steps) for k, v in top]}


def _sweep_params(B, axis="E_dc"):
    """The swept grid: E_dc (BASELINE #2) or omega."""
    if axis == "omega":
        return {"omega": np.linspace(0.8, 1.2, B)}
    return {"E_dc": np.linspace(0.1, 3.0, B)}


def bench_sweep(B=64, K=1000, reps=6, N=40, M=500, axis="E_dc"):
    """Aggregate sweep throughput (BASELINE #2 shape, vmapped XLA engine),
    compile-excluded: a 64-point sweep advanced in timed chunks."""
    from slb2d_tpu.parallel import sweep as sweepmod

    cfg = SimConfig(display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0,
                    alpha=0.9495, n_harmonics=N, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=0.1, g_grid=M, dt=1e-3)
    sw = sweepmod.ParameterSweep(cfg, _sweep_params(B, axis))
    consts, in_axes = sw.consts, sw.in_axes

    def point_step(c, st):
        trig = stencil.device_trig(c, st.t)
        do_av = (c.E_omega > 0) & (st.t >= c.t_start) & (st.t < c.t_end)
        return stencil.full_step(c, st, trig, do_av)

    def run_all(consts, states):
        def body(st, _):
            return jax.vmap(point_step, in_axes=(in_axes, 0))(consts, st), None
        return jax.lax.scan(body, states, None, length=K,
                            unroll=sweepmod.SWEEP_UNROLL)[0]

    run = jax.jit(run_all, donate_argnums=1)
    states = jax.block_until_ready(run(consts, sw._initial_states()))
    t0 = time.perf_counter()
    for _ in range(reps):
        states = run(consts, states)
    jax.block_until_ready(states)
    wall = time.perf_counter() - t0
    agg = 2 * (N + 1) * (M + 1) * K * reps * B
    return agg / wall, wall, K * reps


def bench_movie(frame_batch=8, N=20, M=1000, t_start=0.3, omega=10.0):
    """Display-7 (movie mode) wall clock at BASELINE #3 shape: frames
    reconstructed on the device, batched device->host, formatted."""
    import glob
    import os
    import tempfile

    from slb2d_tpu.runtime.loop import Simulation

    cfg = SimConfig(display=7, E_dc=1.0, E_omega=2.0, omega=omega, mu=1.0,
                    alpha=0.9495, n_harmonics=N, phi_y_min=-10.0,
                    phi_y_max=10.0, B=0.1, t_start=t_start, g_grid=M,
                    dt=1e-3, quiet=True, frame_batch=frame_batch)
    cwd = os.getcwd()
    os.chdir(tempfile.mkdtemp())
    try:
        sim = Simulation(cfg)
        sim.warmup()
        t0 = time.perf_counter()
        sim.run()
        wall = time.perf_counter() - t0
        frames = len(glob.glob("frame*.data"))
    finally:
        os.chdir(cwd)
    return wall, frames, sim.steps_done


def _record(metric, value, unit, engine, vs_baseline=None):
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline, "engine": engine,
            "device": device_info()}


def _dispatch(args):
    mode = args[0] if args else "auto"
    if mode == "movie":
        fb = int(args[1]) if len(args) > 1 else 8
        wall, frames, steps = bench_movie(frame_batch=fb)
        return _record(f"display-7 movie frames/sec (N=20 M=1000, "
                       f"frame-batch={fb})", frames / wall, "frames/sec",
                       "xla")
    if mode == "sweep":
        axis = args[1] if len(args) > 1 else "E_dc"
        ups, wall, steps = bench_sweep(axis=axis)
        return _record(f"aggregate sweep site-updates/sec (64-point {axis} "
                       f"sweep, N=40 M=500)", ups, "updates/sec",
                       "xla-vmapped", ups / BASELINE)
    if mode == "f64":
        jax.config.update("jax_enable_x64", True)
        M = int(args[1]) if len(args) > 1 else 4000
        N = int(args[2]) if len(args) > 2 else 100
        ups, wall, steps, engine = bench("xla", M=M, N=N, dtype="f64")
        return _record(f"lattice-site updates/sec (N={N} M={M}, f64)", ups,
                       "updates/sec", engine, ups / BASELINE)
    if mode in ("auto", "driver"):
        impl = args[1] if mode == "driver" and len(args) > 1 else "auto"
        exact = (args[2] != "fast") if len(args) > 2 else True
        display = int(args[3]) if len(args) > 3 else 4
        ups, wall, steps, engine = bench_driver(impl, exact_time=exact,
                                                display=display)
        return _record(f"end-to-end slb2d driver updates/sec (N=100 M=4000, "
                       f"display={display}, "
                       f"{'exact' if exact else 'fast'}-time)", ups,
                       "updates/sec", engine, ups / BASELINE)
    if mode == "xla":
        M = int(args[1]) if len(args) > 1 else 4000
        N = int(args[2]) if len(args) > 2 else 100
        ups, wall, steps, engine = bench(mode, M=M, N=N)
        return _record(f"lattice-site updates/sec (N={N} M={M}, step loop)",
                       ups, "updates/sec", engine, ups / BASELINE)
    raise SystemExit(f"bench.py: unknown mode {mode!r}")


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    cpu_smoke = "--cpu-smoke" in args
    args = [a for a in args if a != "--cpu-smoke"]
    env.apply_compile_cache()
    platform = env.platform()
    if platform != "gpu" and not cpu_smoke:
        print(f"bench.py: no GPU (JAX backend {platform!r}); refusing to "
              f"report a number", file=sys.stderr)
        return 1
    print(json.dumps(_dispatch(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
