"""Randomized config fuzz: the vectorized stepper must track the literal
C transcription across the parameter space — not just the hand-picked
oracle config — including degenerate corners (dc-only drive, B=0,
minimum grid, single harmonic, asymmetric phi_y range).

Tolerance: XLA contracts mul+add into FMA (docs/DEVIATIONS.md D7), so
bitwise equality with the scalar-numpy transcription is impossible; the
bound is the FMA-noise class scaled by the step count."""

import numpy as np
import pytest

import jax

from slb2d_tpu.config import SimConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel
from slb2d_tpu.ops import stencil

from tests.oracle.c_transcription import CTranscription

f32 = np.float32


def _case(seed):
    rng = np.random.default_rng(seed)
    return dict(
        E_dc=float(rng.uniform(-2, 3)),
        E_omega=float(rng.uniform(0, 3)),
        omega=float(rng.uniform(0.5, 30)),
        mu=float(rng.uniform(0.3, 3)),
        alpha=float(rng.uniform(0.3, 1.5)),
        B=float(rng.uniform(-0.5, 0.5)),
        N=int(rng.integers(1, 14)),
        M=int(rng.integers(3, 40)),
        PhiYmin=float(rng.uniform(-9, -1)),
        PhiYmax=float(rng.uniform(1, 9)),
        dt=float(rng.choice([1e-3, 5e-4, 2e-3])),
    )


EDGE_CASES = [
    # dc-only drive: averaging gate must never fire
    dict(E_dc=1.5, E_omega=0.0, omega=10.0, mu=1.0, alpha=0.9, B=0.2,
         N=6, M=12, PhiYmin=-3.0, PhiYmax=3.0, dt=1e-3),
    # no magnetic field: bdt = 0, neighbor coupling vanishes
    dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9, B=0.0,
         N=6, M=12, PhiYmin=-3.0, PhiYmax=3.0, dt=1e-3),
    # single harmonic (N=1: only n=0 updates; w_n/n_ge2 corners)
    dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9, B=0.3,
         N=1, M=12, PhiYmin=-3.0, PhiYmax=3.0, dt=1e-3),
    # minimum grid
    dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9, B=0.3,
         N=6, M=3, PhiYmin=-3.0, PhiYmax=3.0, dt=1e-3),
    # asymmetric phi_y window (phi=0 not on the grid)
    dict(E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0, alpha=0.9, B=0.3,
         N=6, M=17, PhiYmin=-1.0, PhiYmax=7.0, dt=1e-3),
]


@pytest.mark.parametrize("case", [_case(s) for s in range(8)] + EDGE_CASES)
def test_stepper_tracks_transcription(case):
    n_steps = 120
    cfg = SimConfig(display=4, E_dc=case["E_dc"], E_omega=case["E_omega"],
                    omega=case["omega"], mu=case["mu"], alpha=case["alpha"],
                    n_harmonics=case["N"], phi_y_min=case["PhiYmin"],
                    phi_y_max=case["PhiYmax"], B=case["B"], t_start=0.05,
                    g_grid=case["M"], dt=case["dt"], quiet=True)
    model = SuperlatticeModel(cfg)
    c = stencil.consts_from_model(model)
    state = stencil.bootstrap_state(c, model)
    oracle = CTranscription(
        E_dc=case["E_dc"], E_omega=case["E_omega"], omega=case["omega"],
        mu=case["mu"], alpha=case["alpha"], N=case["N"],
        PhiYmin=case["PhiYmin"], PhiYmax=case["PhiYmax"], B=case["B"],
        t_start=0.05, dt=case["dt"], M=case["M"])

    # bootstrap must agree bitwise (no FMA-sensitive chains yet)
    np.testing.assert_array_equal(
        np.asarray(state.a)[:model.NH, :model.MS], oracle.a[0])

    step = jax.jit(
        lambda s, trig, do_av: stencil.full_step(c, s, trig, do_av))
    t = f32(0.0)
    for _ in range(n_steps):
        om = oracle.omega
        th = f32(t + oracle.dt / 2)
        trig = (
            f32(np.cos(np.float64(f32(om * t)))),
            f32(np.cos(np.float64(f32(om * f32(t + oracle.dt))))),
            f32(np.cos(np.float64(f32(om * th)))),
            f32(np.cos(np.float64(f32(om * f32(th + oracle.dt))))),
            f32(np.cos(np.float64(f32(om * t)))),
            f32(np.sin(np.float64(f32(om * t)))),
        )
        do_av = bool(oracle.E_omega > 0 and t >= oracle.t_start)
        state = step(state, trig, np.bool_(do_av))
        oracle.run_steps(1, do_av="after_t_start")
        t = f32(t + oracle.dt)

    cur, ch = oracle.current, oracle.current_hs
    scale = max(1.0, abs(case["E_dc"]) + case["E_omega"])
    tol = dict(rtol=2e-4, atol=5e-6 * scale * n_steps / 100)
    got = np.asarray(state.a)[:model.NH, :model.MS]
    np.testing.assert_allclose(got, oracle.a[cur], **tol)
    np.testing.assert_allclose(
        np.asarray(state.b)[:model.NH, :model.MS], oracle.b[cur], **tol)
    np.testing.assert_allclose(
        np.asarray(state.a_hs)[:model.NH, :model.MS], oracle.a[ch], **tol)
    np.testing.assert_allclose(
        np.asarray(state.av)[:6], oracle.av_data, **tol)
    # dc-only: no averaging samples ever
    if case["E_omega"] == 0:
        assert float(state.av[0]) == 0 == oracle.av_data[0]
