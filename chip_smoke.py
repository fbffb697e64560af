#!/usr/bin/env python3
"""Proof that slb2d runs on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py           one GPU: phases 1-3
    python chip_smoke.py --multi   four GPUs: the mesh phase only

Phase 1 prints the card's name and power limit (nvidia-smi, from a child
process that stays off JAX) and fails unless JAX's default device is a
GPU.  Phase 2 drives the main path -- the slb2d CLI and Simulation, the
stdin parameter server, the display-7 movie, ParameterSweep -- at the
BASELINE shapes and checks each result against its reference: golden
outputs of the C reference binary, float64 runs on the card, and the host
float64 frame reconstruction.  Phase 3 times the engine end to end
through Simulation and reads a profiler trace of its step.

Every failed check raises, so the script exits non-zero; the last line of
standard output, printed only when every phase passed, is one JSON object
naming the device.  The card-only tests run with
    SLB2D_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
"""

import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                    "golden")

# the physics of the golden runs (tests/test_golden.py COMMON)
COMMON = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
              phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=1e-3, quiet=True)
BASE1 = dict(n_harmonics=20, g_grid=200, t_start=10.0)    # BASELINE #1
N40 = dict(n_harmonics=40, g_grid=500, t_start=2.0)       # d4_n40 golden
BASE4 = dict(n_harmonics=100, g_grid=4000, t_start=0.5)   # BASELINE #4
MOVIE = dict(n_harmonics=20, g_grid=1000, omega=10.0, t_start=0.3,
             frame_start=0.85)                            # BASELINE #3
SWEEP = dict(n_harmonics=40, g_grid=500, t_start=0.1)     # BASELINE #2
SWEEP_POINTS = 64
REPL_SCRIPT = "E_dc 1.5 0.5\nB 0.2 0.5\nexit\n"          # two mutations
GOLD_REPL_SCRIPT = ("E_dc 1.5 0.5\nB 0.2 0.5\nmu 1.3 0.3\nomega 12.0 0.3\n"
                    "exit\n")
NORM_COL = 6            # display-4 columns: E_dc E_om om mu v_dr A NORM ...

# f32 against the f32 reference binary: the reference's own measured FMA
# rebuild envelope (docs/DEVIATIONS.md D7; tests/test_golden.py)
F32_GOLD = dict(rtol=2e-5, atol=8e-6)
# f64 against the f64 reference binary: the <=1e-6 bar with margin
F64_GOLD = dict(rtol=1e-8, atol=1e-9)
# float32 against float64 at #4: about twice the reference's own f32/f64
# gap (phase2_float64)
F32_VS_F64 = dict(rtol=1e-3, atol=3e-4)


def d4_values(text: str) -> list:
    """The numeric display-4 lines of an output text."""
    return [np.array(ln.split(), float) for ln in text.splitlines()
            if ln.strip() and not ln.startswith("#")]


def compare(name: str, got, want, *, rtol: float, atol: float) -> float:
    """assert_allclose with a printed verdict; returns the largest
    |got - want| / (atol + rtol |want|), which must stay <= 1."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    ratio = float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want)),
                         initial=0.0))
    print(f"  {name}: max err/tol {ratio:.3g} (rtol {rtol:g}, atol "
          f"{atol:g}) {'ok' if ratio <= 1 else 'FAIL'}", flush=True)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)
    return ratio


def check_norm(name: str, line, tol: float = 1e-3):
    norm = float(line[NORM_COL])
    print(f"  {name}: NORM {norm!r}", flush=True)
    if not abs(norm - 1.0) <= tol:
        raise AssertionError(f"{name}: NORM {norm} not within {tol} of 1")


def frame_values(path: str) -> np.ndarray:
    """The (phi_x, phi_y, f) rows of a frame file."""
    with open(path) as fh:
        rows = [ln.split() for ln in fh if ln.strip()
                and not ln.startswith("#")]
    return np.asarray(rows, float)


def simulate(workdir: str, repl: str | None = None, prepare=None,
             **kw) -> tuple:
    """Run one Simulation in workdir; returns (output text, simulation).
    prepare(sim), if given, runs before the simulation does."""
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.runtime.loop import Simulation

    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim = Simulation(SimConfig(out_file="out.txt", **{**COMMON, **kw}))
        if prepare is not None:
            prepare(sim)
        sim.run(repl_stream=io.StringIO(repl) if repl is not None else None)
        with open("out.txt") as fh:
            return fh.read(), sim
    finally:
        os.chdir(cwd)


def read_gold(name: str) -> str:
    with open(os.path.join(GOLD, name)) as fh:
        return fh.read()


# ---------------------------------------------------------------- phase 2

def phase2_float32(tmp: str) -> dict:
    """The f32 main-path runs; returns what the f64 phase compares to."""
    from slb2d_tpu import cli

    print("phase 2: main path on the card (float32)", flush=True)
    # BASELINE #4 through the CLI, as a user would call it
    d4 = os.path.join(tmp, "d4_base4_f32.txt")
    argv = ["display=4", "E_dc=1.0", "E_omega=2.0", "omega=1.0", "mu=1.0",
            "alpha=0.9495", f"n-harmonics={BASE4['n_harmonics']}",
            "PhiYmin=-10", "PhiYmax=10", "B=0.1",
            f"t-max={BASE4['t_start']}", f"g-grid={BASE4['g_grid']}",
            "dt=1e-3", f"o={d4}"]
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("slb2d CLI at BASELINE #4 failed")
    with open(d4) as fh:
        base4 = d4_values(fh.read())
    print(f"  #4 display-4 line (f32, impl=auto, "
          f"{time.perf_counter() - t0:.2f} s with compile): "
          f"{' '.join(f'{v:.9g}' for v in base4[0])}", flush=True)
    check_norm("#4 f32", base4[0])

    # BASELINE #1 against the f32 reference binary
    text, sim = simulate(os.path.join(tmp, "b1"), display=4, **BASE1)
    print(f"  #1 f32 engine: {sim.impl}")
    compare("#1 f32 vs golden d4_base1_f32", d4_values(text)[0],
            d4_values(read_gold("d4_base1_f32.txt"))[0], **F32_GOLD)

    # the parameter server at the #1 shape: two mutations, three rounds;
    # round 1 is the plain #1 run, so it meets the same golden
    text, _ = simulate(os.path.join(tmp, "repl"), repl=REPL_SCRIPT,
                       display=4, read_from="stdin", **BASE1)
    repl = d4_values(text)
    if len(repl) != 3:
        raise AssertionError(f"parameter server: {len(repl)} rounds, not 3")
    compare("REPL round 1 vs golden d4_base1_f32", repl[0],
            d4_values(read_gold("d4_base1_f32.txt"))[0], **F32_GOLD)
    for i, line in enumerate(repl):
        check_norm(f"REPL round {i + 1}", line)

    phase2_movie(tmp)
    phase2_sweep(tmp)
    return {"base4": base4[0]}


def phase2_movie(tmp: str):
    """Display-7 frames reconstructed on the device against the host
    float64 reconstruction of the same states."""
    import glob

    from slb2d_tpu.utils import env

    plan = env.plan("auto", "f32")
    print(f"  movie (#3, display 7): device frames {plan.device_frames}")

    def host_frames(sim):
        sim.plan = sim.plan._replace(device_frames=False)

    dev_dir = os.path.join(tmp, "m_dev")
    host_dir = os.path.join(tmp, "m_host")
    simulate(dev_dir, display=7, **MOVIE)
    simulate(host_dir, prepare=host_frames, display=7, **MOVIE)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(dev_dir, "frame*.data")))
    if not names:
        raise AssertionError("display 7 wrote no frames")
    print(f"  movie: {len(names)} frames")
    for name in names:
        dev = frame_values(os.path.join(dev_dir, name))
        host = frame_values(os.path.join(host_dir, name))
        # float32 products of the (X, NHP) x (NHP, M) reconstruction,
        # summed on the device against the host's float64 sums rounded to
        # f32: a few f32 ulps of the largest |f|; values are printed with
        # 20 significant digits, so the file keeps them all
        scale = float(np.max(np.abs(host[:, 2])))
        compare(f"movie {name} device vs host", dev, host, rtol=1e-5,
                atol=1e-6 * scale)


def phase2_sweep(tmp: str):
    """The 64-point E_dc sweep (BASELINE #2) against single runs."""
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.parallel.sweep import ParameterSweep

    e_dc = np.linspace(0.1, 3.0, SWEEP_POINTS)
    cfg = SimConfig(display=4, **{**COMMON, **SWEEP})
    t0 = time.perf_counter()
    res = ParameterSweep(cfg, {"E_dc": e_dc}).run()
    print(f"  sweep: {SWEEP_POINTS} points x N=40 M=500 in "
          f"{time.perf_counter() - t0:.2f} s with compile", flush=True)
    norm = np.asarray(res["norm"])
    if norm.shape != (SWEEP_POINTS,) or not np.all(np.abs(norm - 1) < 1e-3):
        raise AssertionError(f"sweep NORM out of range: {norm}")
    for i in (0, SWEEP_POINTS - 1):
        text, _ = simulate(os.path.join(tmp, f"sw{i}"), display=4,
                           **{**SWEEP, "E_dc": float(e_dc[i])})
        v = d4_values(text)[0]
        # sweep points evaluate the drive's trig on the device from the
        # carried t, single runs take the host-exact table: the
        # sweep-equals-independent-runs envelope of tests/test_parallel.py
        compare(f"sweep point {i} vs single run",
                [res[k][i] for k in ("v_dr_av", "A", "norm")],
                v[[9, 5, NORM_COL]], rtol=5e-5, atol=1e-7)


def phase2_float64(tmp: str, f32: dict):
    """The f64 runs: goldens at #1 and N=40, and #4 f32 against #4 f64."""
    print("phase 2: main path on the card (float64)", flush=True)
    text, _ = simulate(os.path.join(tmp, "b1_64"), display=4, dtype="f64",
                       **BASE1)
    compare("#1 f64 vs golden d4_base1_f64", d4_values(text)[0],
            d4_values(read_gold("d4_base1_f64.txt"))[0], **F64_GOLD)
    text, _ = simulate(os.path.join(tmp, "n40_64"), display=4, dtype="f64",
                       **N40)
    compare("N=40 M=500 f64 vs golden d4_n40_f64", d4_values(text)[0],
            d4_values(read_gold("d4_n40_f64.txt"))[0], **F64_GOLD)
    text, _ = simulate(os.path.join(tmp, "b4_64"), display=4, dtype="f64",
                       **BASE4)
    b4 = d4_values(text)[0]
    print(f"  #4 display-4 line (f64): {' '.join(f'{v:.9g}' for v in b4)}")
    # the C reference's own float32 build differs from its float64 build
    # at #1 by up to 5.5e-4 relative and 1.7e-4 absolute (golden pair
    # d4_base1_f32/f64: float32 time accumulation shifts the drive phase
    # of the instantaneous columns); the card must stay within about twice
    # that gap
    compare("#4 f32 vs #4 f64", f32["base4"], b4, **F32_VS_F64)
    # the parameter server against the reference binary's session (four
    # mutations, five rounds; the golden of tests/test_golden.py)
    text, _ = simulate(os.path.join(tmp, "repl64"), repl=GOLD_REPL_SCRIPT,
                       display=4, dtype="f64", read_from="stdin",
                       n_harmonics=8, g_grid=24, t_start=0.5, omega=10.0)
    compare("REPL session f64 vs golden repl_f64",
            np.concatenate(d4_values(text)),
            np.concatenate(d4_values(read_gold("repl_f64.txt"))),
            rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------- phase 3

def timed_cell(tmp: str, label: str, card: str, reps: int = 4,
               **kw) -> None:
    """End-to-end walls through Simulation at one cell: the warm-up
    (compile) timed on its own, then reps runs from the initial state."""
    import bench
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.runtime.loop import Simulation

    d = os.path.join(tmp, label.replace("#", "b").replace(" ", "_"))
    os.makedirs(d)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = Simulation(SimConfig(out_file="out.txt", **{**COMMON, **kw}))
        t0 = time.perf_counter()
        sim.warmup()
        setup = time.perf_counter() - t0
        walls = [bench.rerun(sim) for _ in range(reps)]
    finally:
        os.chdir(cwd)
    med = statistics.median(walls)
    steps = sim.steps_done
    ups = 2 * (sim.model.N + 1) * (sim.model.M + 1) * steps / med
    print(f"  {label} {sim.impl} ({card}): setup {setup:.3f} s; {steps} "
          f"steps, median {med:.4f} s = {med / steps * 1e6:.2f} us/step = "
          f"{ups:.4g} updates/s; runs "
          f"{' '.join(f'{w:.4f}' for w in walls)}", flush=True)


def step_profile(tmp: str, card: str, n: int = 512):
    """At #4: compile time and memory analysis of an n-step Simulation
    runner, then a profiler trace of one such run, reduced to per-step
    device metrics (bench.device_trace_summary)."""
    import jax

    import bench
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.runtime import schedule
    from slb2d_tpu.runtime.loop import Simulation

    kind = jax.devices()[0].device_kind
    sim = Simulation(SimConfig(display=4, out_file=os.devnull,
                               **{**COMMON, **BASE4}))
    chunk = next(schedule.iter_chunks(**sim._schedule_kwargs()))
    xs = {k: v[:n] for k, v in chunk.xs.items()}
    runner = sim._runner(n)
    t0 = time.perf_counter()
    compiled = runner.lower(sim.state, xs).compile()
    t_comp = time.perf_counter() - t0
    print(f"  #4 {sim.impl}: compile of the {n}-step runner {t_comp:.3f} s;"
          f" {compiled.memory_analysis()}", flush=True)
    state = jax.block_until_ready(runner(sim.state, xs)[0])
    trace_dir = os.path.join(tmp, "trace")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(runner(state, xs)[0])
    s = bench.device_trace_summary(trace_dir, n)
    if not s["kernels_per_step"]:
        raise AssertionError(f"no device kernels in the trace (lines "
                             f"{s['lines']})")
    byts = bench.step_bytes(sim.model)
    rate = byts / (s["busy_us_per_step"] * 1e-6)
    print(f"  #4 {sim.impl} trace ({card}): {s['kernels_per_step']:.2f} "
          f"kernels/step, {s['copies_per_step']:.2f} copies/step, device "
          f"busy {s['busy_us_per_step']:.2f} us/step of "
          f"{s['window_us_per_step']:.2f} (idle share "
          f"{s['idle_share']:.3f}); {byts / 1e6:.2f} MB/step compulsory = "
          f"{rate / 1e12:.3f} TB/s while busy = "
          f"{rate / bench.peak_bytes_per_s(kind):.3f} of the peak",
          flush=True)
    print(f"    top ops (us/step): "
          f"{[(k[:60], round(v, 2)) for k, v in s['top']]}", flush=True)


def phase3(tmp: str, card: str):
    print(f"phase 3: the engine end to end ({card})", flush=True)
    timed_cell(tmp, "#4 d4", card, display=4, **BASE4)
    timed_cell(tmp, "#1 d4", card, display=4, **BASE1)
    timed_cell(tmp, "#4 d77", card, display=77, **BASE4)
    step_profile(tmp, card)


# ------------------------------------------------------------------ multi

def multi(n: int = 4):
    """The four-card paths, each against the same run on one device."""
    import jax

    import __graft_entry__
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.parallel.mesh import make_mesh
    from slb2d_tpu.parallel.sweep import ParameterSweep

    print(f"multi: {n} devices {[d.id for d in jax.devices()[:n]]}",
          flush=True)
    # the 64-point sweep over a "sweep" mesh against one device: points
    # are independent, so only XLA's per-shape fusion choices differ
    e_dc = np.linspace(0.1, 3.0, SWEEP_POINTS)
    cfg = SimConfig(display=4, **{**COMMON, **SWEEP})
    mesh = make_mesh((n,), ("sweep",))
    if len({d.id for d in mesh.devices.flat}) != n:
        raise AssertionError(f"sweep mesh spans {mesh.devices}")
    t0 = time.perf_counter()
    sharded = ParameterSweep(cfg, {"E_dc": e_dc}, mesh=mesh).run()
    t1 = time.perf_counter()
    plain = ParameterSweep(cfg, {"E_dc": e_dc}).run()
    t2 = time.perf_counter()
    print(f"  sweep: {n} devices {t1 - t0:.2f} s, one device "
          f"{t2 - t1:.2f} s (with compile)")
    for k in ("v_dr_av", "A", "norm", "v_y_av", "m_over_m_x_av"):
        compare(f"sweep mesh vs one device: {k}", sharded[k], plain[k],
                rtol=1e-6, atol=1e-7)

    # shards=4 display=4 at #4 against unsharded: the stencil and halo
    # exchange are exact, only the observables' row sums are taken in
    # n partial sums plus a psum instead of one sum (f32, 4096 columns)
    with tempfile.TemporaryDirectory() as tmp:
        text_s, sim = simulate(os.path.join(tmp, "s"), display=4, shards=n,
                               **BASE4)
        used = len(sim.state.a.sharding.device_set)
        if used != n:
            raise AssertionError(f"shards={n} state on {used} devices")
        text_u, _ = simulate(os.path.join(tmp, "u"), display=4, **BASE4)
    compare(f"#4 shards={n} vs unsharded", d4_values(text_s)[0],
            d4_values(text_u)[0], rtol=1e-5, atol=1e-7)

    # the (2, 2) sweep x space mesh checks of __graft_entry__
    __graft_entry__.mesh_checks(n)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    want = 4 if "--multi" in argv else 1
    import bench
    import jax

    card = bench.power_limit()
    if card is None:
        print("chip_smoke: nvidia-smi reports no GPU", file=sys.stderr)
        return 1
    print(f"phase 1: {card}", flush=True)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device: {devs[0].platform})",
              file=sys.stderr)
        return 1
    if len(devs) < want:
        print(f"chip_smoke: {want} GPUs needed, {len(devs)} found",
              file=sys.stderr)
        return 1
    print(f"phase 1: jax {jax.__version__} on {devs[0].device_kind} x "
          f"{len(devs)}", flush=True)
    from slb2d_tpu.utils import env
    env.apply_compile_cache()
    if want > 1:
        multi(want)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            f32 = phase2_float32(tmp)
            phase3(tmp, card)
            with jax.enable_x64(True):
                phase2_float64(tmp, f32)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
