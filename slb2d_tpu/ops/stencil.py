"""The semi-implicit leapfrog stencil, as whole-array operations.

Replaces the reference's zoo of CUDA kernel variants (BLTZM_KERNEL
1/2/310/311/321/341/342/4, reference: src/boltzmann_gpu.cu:84-1167) and the
OpenMP C loops (src/boltzmann_c_solver.c:355-411) with ONE branch-free
formulation: the n=0 / n=1 special cases become data (mask and weight
vectors), shifts (n±1, m±1) become rolls whose wrap-around lands only in
masked-out ghost rows/columns, and XLA fuses the whole update into a few
elementwise loops.

Update scheme per grid point and harmonic (src/boltzmann_c_solver.c:363-378):

    mu_t   = n * (E_dc + E_omega*cos(w t)      + B*phi_y) * dt/2
    mu_t1  = n * (E_dc + E_omega*cos(w (t+dt)) + B*phi_y) * dt/2
    g = dt*a0 + a*nu_tilde - b*mu_t
        + bdt*( b~[n+1,m+1] - b~[n+1,m-1] - [n>=2]*(b~[n-1,m+1] - b~[n-1,m-1]) )
    h = b*nu_tilde + a*mu_t
        + bdt*( w_n*(a~[n-1,m+1] - a~[n-1,m-1]) - a~[n+1,m+1] + a~[n+1,m-1] )
    xi = nu2 + mu_t1^2
    a' = (g*nu - h*mu_t1)/xi ;  b' = (g*mu_t1 + h*nu)/xi   (b' only for n>0)

where ~ marks the time-staggered neighbor arrays and w_n = [0, 2, 1, 1, ...].

Buffer-staleness quirks of the reference's 4-buffer rotation are reproduced
so float32 runs pin against the C solver:
  * the half-step writes only m=1..M, so column M+1 of the half-step arrays
    alternates between its bootstrap value and 0 — carried here as the
    `hs_edge_*` vectors (see SURVEY.md §0 "Buffering");
  * main-grid harmonic row N alternates between a0[N] and 0 but is never
    read by the dynamics; output code reconstructs it from the step parity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class State(NamedTuple):
    """Scan carry: full solver state at one main-grid time."""
    a: jax.Array        # (NHP, MP) cosine harmonics, main grid
    b: jax.Array        # (NHP, MP) sine harmonics, main grid
    a_hs: jax.Array     # (NHP, MP) half-step grid
    b_hs: jax.Array
    hs_edge_a: jax.Array  # (NHP,) stale column M+1 for the next hs write
    hs_edge_b: jax.Array  # (NHP,)
    av: jax.Array       # (8,) running observables (av_data, :413-437) +
                        # Kahan compensations for av[4]/av[5] in [6]/[7]
    t: jax.Array        # scalar, loop time (f32 in reference mode)
    step: jax.Array     # int32 number of completed steps


class StencilConsts(NamedTuple):
    """Everything the stencil math reads besides the state.

    May hold numpy constants (closed-over, single run) or traced arrays
    (vmapped parameter sweeps) — the math is written against either.
    """
    a0: jax.Array           # (NHP, MP) equilibrium
    a0_ghost: jax.Array     # (NHP, MP) a0 on the never-rewritten ghost cells
    phi: jax.Array          # (MP,) phi_y values
    n_float: jax.Array      # (NHP, 1) float harmonic index
    row_update: jax.Array   # (NHP, 1) bool: n < N
    n_ge2: jax.Array        # (NHP, 1) float: 1.0 where n >= 2
    w_n: jax.Array          # (NHP, 1) float: 0/2/1 weights
    b_row_mask: jax.Array   # (NHP, 1) bool: n > 0
    col_main: jax.Array     # (1, MP) bool: 1 <= m <= M+1
    col_half: jax.Array     # (1, MP) bool: 1 <= m <= M
    w_av: jax.Array         # (MP,) dPhi over av bounds
    w_av_phi: jax.Array     # (MP,) dPhi*phi over av bounds
    # scalars (0-d, possibly traced)
    E_dc: jax.Array
    E_omega: jax.Array
    omega: jax.Array
    B: jax.Array
    dt: jax.Array
    nu: jax.Array
    nu2: jax.Array
    nu_tilde: jax.Array
    bdt: jax.Array
    t_start: jax.Array
    t_end: jax.Array        # averaging window end (t_max); +inf normally
    col_edge: jax.Array     # (1, MP) bool one-hot at column M+1


def consts_from_model(model, t_start=None) -> StencilConsts:
    f = model.np_dtype
    return StencilConsts(
        a0=model.a0, a0_ghost=model.a0_ghost, phi=model.phi,
        n_float=model.n_float,
        row_update=model.row_update, n_ge2=model.n_ge2, w_n=model.w_n,
        b_row_mask=model.b_row_mask, col_main=model.col_main,
        col_half=model.col_half, w_av=model.w_av, w_av_phi=model.w_av_phi,
        E_dc=model.E_dc, E_omega=model.E_omega, omega=model.omega,
        B=model.B, dt=model.dt, nu=model.nu, nu2=model.nu2,
        nu_tilde=model.nu_tilde, bdt=model.bdt,
        t_start=f(model.cfg.t_start if t_start is None else t_start),
        t_end=f(np.inf),
        col_edge=np.arange(model.MP)[None, :] == model.M + 1,
    )


def _shift(arr, dn: int, dm: int):
    """Value at (n+dn, m+dm); wrap-around lands only in masked positions."""
    return jnp.roll(arr, shift=(-dn, -dm), axis=(0, 1))


def apply_half_step(c: StencilConsts, a_src, b_src, a_nb, b_nb,
                    cos_t, cos_t_dt, *, main: bool, shift=_shift):
    """One stencil application.

    a_src/b_src are read pointwise at (n, m) (the arrays being advanced);
    a_nb/b_nb are the time-staggered arrays read at (n±1, m±1).
    `main=True` uses the main-grid write bounds m=1..M+1
    (src/boltzmann_c_solver.c:361), else the half-grid bounds m=1..M (:391).
    shift(arr, dn, dm): the value of arr at (n+dn, m+dm).
    """
    # operand order mirrors the C expressions so float32 rounding matches
    mu_t_part = (c.E_dc + c.E_omega * cos_t + c.B * c.phi) * c.dt / 2
    mu_t1_part = (c.E_dc + c.E_omega * cos_t_dt + c.B * c.phi) * c.dt / 2
    mu_t = c.n_float * mu_t_part          # (NHP, MP)
    mu_t1 = c.n_float * mu_t1_part

    # shared m-difference: X[n, m] = nb[n, m+1] - nb[n, m-1]; the n±1 reads
    # are then single-axis shifts of it.  g and h follow the C expressions'
    # associativity (g: fl(d1 - d2) with both differences pre-formed,
    # :370-371; h: fl(fl(W - a1) + a2) with the n+1 neighbors subtracted
    # INDIVIDUALLY, :372-373).
    dm_b = shift(b_nb, 0, 1) - shift(b_nb, 0, -1)
    dm_a = shift(a_nb, 0, 1) - shift(a_nb, 0, -1)
    g = (c.dt * c.a0 + a_src * c.nu_tilde - b_src * mu_t
         + c.bdt * (shift(dm_b, 1, 0) - c.n_ge2 * shift(dm_b, -1, 0)))
    h_np1 = (c.w_n * shift(dm_a, -1, 0)
             - shift(a_nb, 1, 1) + shift(a_nb, 1, -1))
    h = b_src * c.nu_tilde + a_src * mu_t + c.bdt * h_np1

    # Row masking folds into the nu factor: nu_a/nu_b are (NHP, 1)
    # vectors equal to nu at updated rows and 0 at n >= N (and n == 0 for
    # b), and n_float is zeroed there too, so mu_t1 vanishes — outputs at
    # masked rows are exactly 0 without any full-array select.  At live
    # rows g*nu_a is bitwise g*nu.  Only the (cheap, broadcast) column
    # select remains for the ghost columns.
    dtype = a_src.dtype
    nu_a = c.nu * jnp.asarray(c.row_update).astype(dtype)
    nu_b = nu_a * jnp.asarray(c.b_row_mask).astype(dtype)
    xi = c.nu2 + mu_t1 * mu_t1
    cols = c.col_main if main else c.col_half
    a_new = (g * nu_a - h * mu_t1) / xi
    b_new = (g * mu_t1 + h * nu_b) / xi
    zero = jnp.zeros((), dtype=dtype)
    a_new = jnp.where(cols, a_new, zero)
    b_new = jnp.where(cols, b_new, zero)
    return a_new, b_new


def tiptoe_half_step(c: StencilConsts, a, cos_wdt):
    """The bootstrap tiptoe (reference src/boltzmann_c_solver.c:141-145):
    one main-grid half-step reading the initial arrays for both roles.
    Shared body for the single-run and batched-sweep bootstraps so their
    numerics cannot diverge."""
    b = jnp.zeros_like(a)
    return apply_half_step(c, a, b, a, b, jnp.ones((), a.dtype), cos_wdt,
                           main=True)


def bootstrap_cos_wdt(model):
    """cos(omega*dt) through the reference's float->double->float
    rounding (src/boltzmann_c_solver.c:141's cos argument path)."""
    f = model.np_dtype
    return f(np.cos(np.float64(f(model.omega) * f(model.dt))))


# jitted: one dispatch instead of ~20 eager op-by-op ones
_bootstrap_tiptoe = jax.jit(tiptoe_half_step)


def bootstrap_state(c: StencilConsts, model) -> State:
    """Initial state: a = a0, b = 0, plus the tiptoe first half-step
    (reference: src/boltzmann_c_solver.c:136-145)."""
    dtype = model.np_dtype
    a = jnp.asarray(model.initial_a())
    b = jnp.zeros_like(a)
    a_hs, b_hs = _bootstrap_tiptoe(c, a, bootstrap_cos_wdt(model))
    return State(
        a=a, b=b, a_hs=a_hs, b_hs=b_hs,
        hs_edge_a=jnp.zeros((a.shape[0],), dtype),
        hs_edge_b=jnp.zeros((a.shape[0],), dtype),
        av=jnp.zeros((8,), dtype),
        t=jnp.asarray(dtype(0)),
        step=jnp.asarray(0, jnp.int32),
    )


def av_update(c: StencilConsts, av, a_new, b_new, cos_av, sin_av,
              sum_m=None):
    """Running observable averages (reference: src/boltzmann_c_solver.c:413-437).

    av[0]: sample count; av[1..3]: incremental means of v_dr, v_y, m/m_x;
    av[4], av[5]: absorption quadratures Sum cos/sin(w t) * v_dr * dt with
    Kahan compensation carried in av[6], av[7].  The reference gets a
    double intermediate for free (C promotes through cos()); compensated
    summation recovers that accuracy in pure f32, independent of the
    process-global x64 setting.
    """
    if sum_m is None:
        sum_m = lambda v: jnp.sum(v, axis=-1)
    v_dr = sum_m(b_new[1] * c.w_av)
    v_y = sum_m(a_new[0] * c.w_av_phi)
    m_x = sum_m(a_new[1] * c.w_av)
    count = av[0] + 1
    av1 = av[1] + (v_dr - av[1]) / count
    av2 = av[2] + (v_y - av[2]) / count
    av3 = av[3] + (m_x - av[3]) / count
    y4 = cos_av * v_dr * c.dt - av[6]
    t4 = av[4] + y4
    c4 = (t4 - av[4]) - y4
    y5 = sin_av * v_dr * c.dt - av[7]
    t5 = av[5] + y5
    c5 = (t5 - av[5]) - y5
    return jnp.stack([av[0] + 1, av1, av2, av3, t4, t5, c4, c5])


def full_step(c: StencilConsts, state: State, trig, do_av, *,
              shift=_shift, sum_m=None) -> State:
    """One full time step = main-grid + half-grid stencil application plus
    optional observable accumulation (reference loop body,
    src/boltzmann_c_solver.c:164-194)."""
    cos_t, cos_t_dt, cos_hs, cos_hs_dt, cos_av, sin_av = trig
    a_new, b_new = apply_half_step(
        c, state.a, state.b, state.a_hs, state.b_hs, cos_t, cos_t_dt,
        main=True, shift=shift)
    # Parity ghost fill: this step writes main buffer (step+1) % 2; buffer 0
    # keeps a0's ghost cells from the initial copy, buffer 1 keeps zeros.
    # a_new is zero outside the write region, so the add is exact.
    ghost_on = (state.step + 1) % 2 == 0
    a_new = a_new + jnp.where(ghost_on, c.a0_ghost,
                              jnp.zeros((), a_new.dtype))
    ahs_new, bhs_new = apply_half_step(
        c, state.a_hs, state.b_hs, a_new, b_new, cos_hs, cos_hs_dt,
        main=False, shift=shift)
    # stale column M+1 of the retired half-step buffer (4-buffer rotation).
    # Mask-based (not indexed) so the same code runs shard-local under
    # shard_map: only the shard owning column M+1 touches anything.
    if sum_m is None:
        sum_m = lambda v: jnp.sum(v, axis=-1)
    emask = c.col_edge.astype(a_new.dtype)
    ahs_new = jnp.where(c.col_edge, state.hs_edge_a[:, None], ahs_new)
    bhs_new = jnp.where(c.col_edge, state.hs_edge_b[:, None], bhs_new)
    # exact: a row dot with a one-hot mask picks the single column value
    new_edge_a = sum_m(state.a_hs * emask)
    new_edge_b = sum_m(state.b_hs * emask)
    av_new = jax.lax.cond(
        do_av,
        lambda: av_update(c, state.av, a_new, b_new, cos_av, sin_av, sum_m),
        lambda: state.av)
    return State(
        a=a_new, b=b_new, a_hs=ahs_new, b_hs=bhs_new,
        hs_edge_a=new_edge_a, hs_edge_b=new_edge_b,
        av=av_new, t=state.t + c.dt, step=state.step + 1)


def device_trig(c: StencilConsts, t):
    """In-kernel trig for the fast path (no host schedule).

    Matches the C argument computation (float products) but evaluates
    cos/sin at array precision rather than double.
    """
    dt = c.dt
    t_hs = t + dt / 2
    return (
        jnp.cos(c.omega * t),
        jnp.cos(c.omega * (t + dt)),
        jnp.cos(c.omega * t_hs),
        jnp.cos(c.omega * (t_hs + dt)),
        jnp.cos(c.omega * t),
        jnp.sin(c.omega * t),
    )


def emission_record(c: StencilConsts, pre: State, post: State, sum_m=None):
    """Raw per-step observables for batched display-77 emission: sums over
    the PRE-step arrays (the reference prints a[current], the pre-swap
    state, src/boltzmann_c_solver.c:182) plus the POST-step av_data and the
    step's loop t.  Host-side formatting applies the multipliers.
    sum_m: shard-local partial sum + psum under spatial sharding."""
    if sum_m is None:
        sum_m = lambda v: jnp.sum(v, axis=-1)
    return jnp.concatenate([
        jnp.stack([
            sum_m(pre.a[0] * c.w_av),     # norm bounds == av bounds (m=1..M)
            sum_m(pre.b[1] * c.w_av),
            sum_m(pre.a[0] * c.w_av_phi),
            sum_m(pre.a[1] * c.w_av),
            pre.t.astype(pre.a.dtype)]),
        post.av])


def make_step_fn(c: StencilConsts, *, av_enabled: bool, exact_trig: bool,
                 collect_obs: bool = False, shift=_shift, sum_m=None):
    """Build the lax.scan body.

    exact_trig=True: xs supplies host-precomputed (trig..., do_av) per step
    (bit-replicating the C solver's double-evaluated cos of float args).
    exact_trig=False: trig is evaluated on device from the carried t and
    do_av becomes the traced condition t >= t_start.
    collect_obs=True: the scan emits a (13,) observable record per step
    (5 leading raw sums/t + the 8-wide av carry)
    (batched display-77 emission — no host sync per emission).
    shift/sum_m: halo-exchange shift and psum reduction under spatial
    sharding (parallel/spatial.py); defaults are the single-device ops.
    """
    if exact_trig:
        def step(state: State, xs):
            trig = (xs["cos_t"], xs["cos_t_dt"], xs["cos_hs"],
                    xs["cos_hs_dt"], xs["cos_av"], xs["sin_av"])
            new = full_step(c, state, trig, xs["do_av"],
                            shift=shift, sum_m=sum_m)
            ys = (emission_record(c, state, new, sum_m)
                  if collect_obs else None)
            return new, ys
    else:
        def step(state: State, xs):
            trig = device_trig(c, state.t)
            # fast mode must reproduce the schedule's averaging gate
            # itself: av only when the drive has an ac component
            # (reference src/boltzmann_c_solver.c:188) and inside the
            # [t_start, t_end) window; display policy arrives via
            # av_enabled (static)
            do_av = ((c.E_omega > 0) & (state.t >= c.t_start)
                     & (state.t < c.t_end)
                     ) if av_enabled else jnp.asarray(False)
            new = full_step(c, state, trig, do_av,
                            shift=shift, sum_m=sum_m)
            ys = (emission_record(c, state, new, sum_m)
                  if collect_obs else None)
            return new, ys
    return step
