"""Spatial sharding of the phi_y axis with halo exchange (shard_map).

For grids beyond single-chip comfort, state arrays (NHP, MP) are sharded
along m over the "space" mesh axis.  The stencil's m±1 reads become local
rolls whose one wrapped edge column is patched with the neighbor's boundary
column via `jax.lax.ppermute` — a 1-column (NHP,) message per direction per
half-step.  Observable reductions become shard-local partial
sums + `jax.lax.psum`.  The math itself is ops/stencil.full_step unchanged
(shift and sum_m are injected), so spatial runs are numerically identical
to single-device runs up to reduction ordering.

The reference has no multi-device analogue (SURVEY.md §2.3: its only
"transport" is cudaMemcpy); this is new capability.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import stencil


def _halo_shift_factory(axis: str, n_shards: int):
    """Build a shift(arr, dn, dm) for shard-local (NHP, L) blocks.

    dn rolls are harmonic-axis local (not sharded).  dm rolls wrap one
    column which is replaced by the neighbor shard's edge column.  The
    outermost shards receive the wrap-around of the global padded array,
    which lands only in masked ghost columns — same invariant as the
    single-device roll formulation.
    """
    def m_shifted(arr, dm: int):
        # duplicate (arr, dm) calls across the four (dn, dm) shift
        # combinations are deduplicated by XLA CSE — no manual caching
        if dm == 0:
            return arr
        rolled = jnp.roll(arr, -dm, axis=-1)
        if n_shards > 1:
            if dm > 0:
                # need right neighbor's first column in our last slot
                perm = [((i + 1) % n_shards, i) for i in range(n_shards)]
                recv = jax.lax.ppermute(arr[..., 0], axis, perm)
                rolled = rolled.at[..., -1].set(recv)
            else:
                perm = [((i - 1) % n_shards, i) for i in range(n_shards)]
                recv = jax.lax.ppermute(arr[..., -1], axis, perm)
                rolled = rolled.at[..., 0].set(recv)
        return rolled

    def shift(arr, dn: int, dm: int):
        return jnp.roll(m_shifted(arr, dm), -dn, axis=-2)

    return shift


def _sum_m_factory(axis: str):
    def sum_m(arr):
        return jax.lax.psum(jnp.sum(arr, axis=-1), axis)
    return sum_m


def spatial_specs(mesh, axis: str = "space"):
    """(consts_spec, state_spec) PartitionSpecs for shard_map."""
    ca = stencil.StencilConsts(
        a0=P(None, axis), a0_ghost=P(None, axis), phi=P(axis),
        n_float=P(), row_update=P(), n_ge2=P(), w_n=P(), b_row_mask=P(),
        col_main=P(None, axis), col_half=P(None, axis),
        w_av=P(axis), w_av_phi=P(axis),
        E_dc=P(), E_omega=P(), omega=P(), B=P(), dt=P(), nu=P(), nu2=P(),
        nu_tilde=P(), bdt=P(), t_start=P(), t_end=P(),
        col_edge=P(None, axis))
    st = stencil.State(
        a=P(None, axis), b=P(None, axis), a_hs=P(None, axis),
        b_hs=P(None, axis), hs_edge_a=P(), hs_edge_b=P(), av=P(),
        t=P(), step=P())
    return ca, st


def shard_state(state: stencil.State, mesh, axis: str = "space"):
    """Lay a State out over the mesh per spatial_specs (m-axis sharded).

    Goes through host numpy: every process holds the full value, so
    device_put scatters the addressable shards — required on multi-host
    (DCN) meshes where a single-device jax array could not be re-sharded
    globally (the ParameterSweep convention, parallel/sweep.py)."""
    import numpy as _np

    from jax.sharding import NamedSharding
    _, state_spec = spatial_specs(mesh, axis)
    return jax.tree.map(
        lambda x, p: jax.device_put(_np.asarray(x),
                                    NamedSharding(mesh, p)),
        state, state_spec,
        is_leaf=lambda x: not isinstance(x, stencil.State))


def make_sharded_step_runner(c: stencil.StencilConsts, model, mesh, *,
                             av_enabled: bool, exact_trig: bool,
                             collect_obs: bool = False, unroll: int = 1,
                             axis: str = "space"):
    """jitted (state, xs) -> (state, ys): the driver's chunk runner
    (runtime/loop.Simulation._runner) shard_map'd over the phi_y axis.

    Mirrors the single-device runner exactly — same xs schedule, same
    State pytree (globally-shaped, sharded along m), same emission records
    — so every display mode, the REPL, and checkpointing work unchanged
    on a space-sharded run.  The reference binds one device
    (src/boltzmann_solver.c:77); this binds a mesh.
    """
    n_shards = mesh.shape[axis]
    if model.MP % n_shards:
        raise ValueError(f"MP={model.MP} not divisible by {n_shards} shards")
    consts_spec, state_spec = spatial_specs(mesh, axis)
    shift = _halo_shift_factory(axis, n_shards)
    sum_m = _sum_m_factory(axis)
    consts = jax.tree.map(jnp.asarray, c)

    def body(cl, st, xs):
        step = stencil.make_step_fn(
            cl, av_enabled=av_enabled, exact_trig=exact_trig,
            collect_obs=collect_obs, shift=shift, sum_m=sum_m)
        return jax.lax.scan(step, st, xs, unroll=unroll)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(consts_spec, state_spec, P()),
        out_specs=(state_spec, P()), check_vma=False)

    def run(state, xs):
        return sharded(consts, state, xs)

    return jax.jit(run, donate_argnums=0)


def make_spatial_runner(c: stencil.StencilConsts, model, mesh,
                        axis: str = "space", av_enabled: bool = True):
    """jitted (state, n_steps) -> state advancing a space-sharded run.

    MP must be divisible by the shard count (SuperlatticeModel pads M+3 to
    a lane multiple of 128; choose g-grid so MP % (128*n_shards) == 0 for
    even tiles, or pass arrays pre-padded).
    """
    n_shards = mesh.shape[axis]
    if model.MP % n_shards:
        raise ValueError(f"MP={model.MP} not divisible by {n_shards} shards")
    consts_spec, state_spec = spatial_specs(mesh, axis)
    shift = _halo_shift_factory(axis, n_shards)
    sum_m = _sum_m_factory(axis)

    def one_step(cl, st):
        trig = stencil.device_trig(cl, st.t)
        do_av = ((st.t >= cl.t_start) & (st.t < cl.t_end)
                 ) if av_enabled else jnp.asarray(False)
        return stencil.full_step(cl, st, trig, do_av,
                                 shift=shift, sum_m=sum_m)

    def run(consts, state, n_steps):
        body = jax.shard_map(
            lambda cl, st: jax.lax.scan(
                lambda s, _: (one_step(cl, s), None), st, None,
                length=n_steps)[0],
            mesh=mesh, in_specs=(consts_spec, state_spec),
            out_specs=state_spec, check_vma=False)
        return body(consts, state)

    jitted = jax.jit(run, static_argnums=2, donate_argnums=1)

    def runner(state, n_steps):
        return jitted(c, state, n_steps)

    return runner
