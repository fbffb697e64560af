"""Vmapped + mesh-sharded parameter sweeps (BASELINE config #5).

The reference explores parameter space serially through its stdin parameter
server (src/boltzmann_cli.c:71-91), one point at a time, with relaxation
between points.  Here a whole (E_dc, E_omega, omega, B, mu, alpha) grid
becomes a batch axis — `jax.vmap` over the stencil, sharded across the
"sweep" mesh axis with jax.sharding so XLA parallelizes points across
devices with zero communication (absorption maps are embarrassingly
parallel).

Each sweep point reproduces a standalone display-4 run: its own float32
time accumulation, averaging window [t_start, t_start + T(omega_b)), and
loop-exit instantaneous observables — captured per point at its own t_max
crossing even though all points share one scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..constants import PI
from ..models.superlattice import SuperlatticeModel
from ..ops import stencil
from ..runtime.schedule import count_steps

SWEEPABLE = ("E_dc", "E_omega", "omega", "mu", "alpha", "B")

# lax.scan unroll of the vmapped sweep engine
SWEEP_UNROLL = 1


def _make_point_step(weights, shift=None, sum_m=None,
                     capture_state=False):
    """One sweep point's step + loop-exit capture.  shift/sum_m default to
    the single-device ops; the combined-mesh runner injects halo-exchange
    and psum variants — ONE body serves both paths so their semantics
    cannot diverge (tests pin them at 1e-12).

    capture_state=True additionally freezes each point's (a, b) arrays at
    its OWN loop exit (points with shorter periods keep stepping until the
    longest point finishes, so the scan-end state is not theirs) — the
    input to per-point frame reconstruction (sweep frames-dir=)."""
    sh = stencil._shift if shift is None else shift
    sm = (lambda v: jnp.sum(v, axis=-1)) if sum_m is None else sum_m

    def point_step(c, carry):
        st, cap = carry
        trig = stencil.device_trig(c, st.t)
        # E_omega > 0 gates averaging exactly as the reference
        # (src/boltzmann_c_solver.c:188): a dc-only point leaves all
        # period averages at zero
        do_av = ((c.E_omega > 0) & (st.t >= c.t_start)
                 & (st.t < c.t_end))
        new = stencil.full_step(c, st, trig, do_av, shift=sh, sum_m=sm)
        # capture loop-exit instantaneous observables: the last step
        # whose loop t is still < t_max overwrites the capture
        # (display-4 inline sums, src/boltzmann_c_solver.c:236-244)
        live = st.t < c.t_end
        inst = dict(
            v_dr=sm(new.b[1] * weights["w_d4"]),
            v_y=sm(new.a[0] * weights["w_d4_phi"]),
            m_x=sm(new.a[1] * weights["w_d4"]),
            norm=sm(new.a[0] * weights["w_norm"]),
        )
        if capture_state:
            inst["a"] = new.a
            inst["b"] = new.b
        cap = jax.tree.map(lambda old, cur: jnp.where(live, cur, old),
                           cap, inst)
        return new, cap

    return point_step


@functools.partial(jax.jit,
                   static_argnames=("in_axes", "n_steps", "unroll",
                                    "capture_state"))
def _run_sweep(consts, states, cap0, weights, *, in_axes, n_steps, unroll,
               capture_state=False):
    """Advance a whole batch of sweep points n_steps and capture each
    point's loop-exit instantaneous observables.

    Module-level and jitted on static (in_axes, n_steps, unroll) so the
    compiled executable is shared by every ParameterSweep with the same
    batch/grid shapes — interactive grid refinement (slb2d-sweep
    read-from=stdin) re-runs without recompiling.
    """
    point_step = _make_point_step(weights, capture_state=capture_state)

    def body(carry, _):
        st, cap = carry
        st, cap = jax.vmap(point_step, in_axes=(in_axes, 0))(
            consts, (st, cap))
        return (st, cap), None

    return jax.lax.scan(body, (states, cap0), None, length=n_steps,
                        unroll=unroll)[0]


@functools.partial(jax.jit, static_argnames=("in_axes",))
def _bootstrap_batch(consts, a, cos_wdt, *, in_axes):
    """Vmapped tiptoe first half-step (stencil.tiptoe_half_step — the
    SAME body as the single-run bootstrap) for a whole batch in ONE
    device program, instead of B * ~20 eager dispatches."""
    return jax.vmap(stencil.tiptoe_half_step,
                    in_axes=(in_axes, 0, 0))(consts, a, cos_wdt)


@functools.lru_cache(maxsize=None)
def _spatial_sweep_runner(mesh, sweep_axis, space_axis, in_axes, n_steps,
                          unroll, capture_state=False):
    """jitted (consts, states, cap0, weights) over a combined 2-D
    (sweep x space) mesh: points data-parallel over `sweep_axis`, each
    point's phi_y grid sharded over `space_axis` with ppermute halos and
    psum observables.  lru_cached on the mesh + static shape info so
    refinement re-runs share the compiled executable like _run_sweep."""
    from .spatial import _halo_shift_factory, _sum_m_factory, spatial_specs

    from jax.sharding import PartitionSpec as P

    space_n = mesh.shape[space_axis]
    shift = _halo_shift_factory(space_axis, space_n)
    sum_m = _sum_m_factory(space_axis)
    consts_spec1, state_spec1 = spatial_specs(mesh, space_axis)
    axes = in_axes._asdict()
    cs1 = consts_spec1._asdict()
    consts_spec = stencil.StencilConsts(**{
        k: (P(sweep_axis, *cs1[k]) if axes[k] == 0 else cs1[k])
        for k in cs1})
    state_spec = jax.tree.map(lambda p: P(sweep_axis, *p), state_spec1,
                              is_leaf=lambda x: isinstance(x, P))
    cap_spec = {k: P(sweep_axis)
                for k in ("v_dr", "v_y", "m_x", "norm")}
    if capture_state:
        cap_spec["a"] = state_spec.a
        cap_spec["b"] = state_spec.b
    w_spec = {k: P(space_axis) for k in ("w_d4", "w_d4_phi", "w_norm")}

    def body(cl, st, cap, w):
        point_step = _make_point_step(w, shift=shift, sum_m=sum_m,
                                      capture_state=capture_state)

        def one(carry, _):
            return jax.vmap(point_step, in_axes=(in_axes, 0))(cl, carry), None

        return jax.lax.scan(one, (st, cap), None, length=n_steps,
                            unroll=unroll)[0]

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(consts_spec, state_spec, cap_spec, w_spec),
        out_specs=(state_spec, cap_spec), check_vma=False)
    specs = (consts_spec, state_spec, cap_spec, w_spec)
    return jax.jit(sharded), specs


class ParameterSweep:
    def __init__(self, cfg: SimConfig, params: dict, mesh=None,
                 axis: str = "sweep", space_axis: str | None = None):
        """params: {name: 1-D array}; all arrays broadcast together into a
        flat batch (use numpy meshgrid + ravel upstream for grids).

        mesh/axis: shard the batch over a "sweep" mesh axis.  space_axis:
        additionally shard each point's phi_y grid over that mesh axis
        (combined 2-D sweep x space mesh — grids beyond one chip's memory,
        swept in parallel; the configuration dryrun_multichip validates)."""
        for k in params:
            if k not in SWEEPABLE:
                raise ValueError(f"cannot sweep over {k!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.space_axis = space_axis
        # numpy, NOT jnp: this is host bookkeeping — a jnp call here
        # would round-trip the parameter grid through the device
        arrs = np.broadcast_arrays(*[np.asarray(v, np.float64)
                                     for v in params.values()])
        flat = [np.ravel(np.asarray(a)) for a in arrs]
        self.B = len(flat[0]) if flat else 1
        self.params = dict(zip(params.keys(), flat))

        # Per-point models: scalar derivations are cheap; a0 differs only
        # when mu/alpha vary.
        self.models = []
        for i in range(self.B):
            kw = {k: float(v[i]) for k, v in self.params.items()}
            self.models.append(SuperlatticeModel(cfg.replace(**kw)))
        m0 = self.models[0]
        self.base = m0
        D = m0.np_dtype

        def stack(field):
            return np.stack([getattr(m, field) for m in self.models])

        varies_a0 = any(k in self.params for k in ("mu", "alpha"))
        c0 = stencil.consts_from_model(m0)
        # batched consts: leading axis only on fields that vary per point
        batched = dict(c0._asdict())
        axes = {k: None for k in batched}
        for f in ("E_dc", "E_omega", "omega", "B", "bdt"):
            batched[f] = stack(f)
            axes[f] = 0
        if varies_a0:
            batched["a0"] = stack("a0")
            batched["a0_ghost"] = stack("a0_ghost")
            axes["a0"] = axes["a0_ghost"] = 0
        # per-point averaging window end: t_max = f32(t_start + T_b)
        t_end = np.asarray([D(D(cfg.t_start) + m.T) for m in self.models])
        batched["t_end"] = t_end
        axes["t_end"] = 0
        self.consts = stencil.StencilConsts(**batched)
        self.in_axes = stencil.StencilConsts(**axes)

        # shared step count: the longest point's loop trip count
        self.n_steps = max(
            count_steps(0.0, float(t_end[i]), float(m0.dt), D)
            for i in range(self.B))

    # -- device program -------------------------------------------------------

    def _initial_states(self):
        """Batched bootstrap: a <- a0, b <- 0, one vmapped tiptoe
        half-step (the numerics of stencil.bootstrap_state, reference
        src/boltzmann_c_solver.c:136-145, point by point)."""
        D = self.base.np_dtype
        a = jnp.asarray(np.stack([m.initial_a() for m in self.models]))
        cos_wdt = jnp.asarray(np.array(
            [stencil.bootstrap_cos_wdt(m) for m in self.models], D))
        a_hs, b_hs = _bootstrap_batch(self.consts, a, cos_wdt,
                                      in_axes=self.in_axes)
        B, NHP = self.B, self.base.NHP
        # distinct buffers per field: callers may donate the whole State
        # (bench.py's sweep bench does), and a buffer aliased into two
        # donated arguments is rejected
        return stencil.State(
            a=a, b=jnp.zeros_like(a), a_hs=a_hs, b_hs=b_hs,
            hs_edge_a=jnp.zeros((B, NHP), D),
            hs_edge_b=jnp.zeros((B, NHP), D),
            av=jnp.zeros((B, 8), D),
            t=jnp.zeros((B,), D),
            step=jnp.zeros((B,), jnp.int32))

    def run(self, checkpoint=None, resume=None, checkpoint_every=0,
            capture_state=False):
        """Run all points to their t_max; returns per-point display-4
        observables as a dict of (B,) arrays.

        checkpoint: .npz path saved at the end and (if checkpoint_every >
        0) every checkpoint_every steps — extends the single-run
        checkpoint subsystem (runtime/checkpoint.py) to long sweeps (the
        sweep format carries a batch axis + capture state, so it is a
        separate format from runtime/checkpoint.py's single-run one).
        resume: continue an interrupted sweep from such a file (the grid
        must match).
        capture_state: additionally freeze each point's (a, b) arrays at
        its own loop exit; afterwards `self.final_ab` holds host (B, NHP,
        MP) arrays for per-point frame reconstruction (sweep frames)."""
        checkpoint = checkpoint or None          # '' from the CLI == unset
        resume = resume or None
        D = self.base.np_dtype
        in_axes = self.in_axes
        unroll = SWEEP_UNROLL
        weights = dict(
            w_d4=jnp.asarray(self.base.w_d4),
            w_d4_phi=jnp.asarray(self.base.w_d4_phi),
            w_norm=jnp.asarray(self.base.w_norm),
        )
        self.final_ab = None

        done = 0
        if resume is not None:
            states, cap, done = self._load_checkpoint(resume, capture_state)
        else:
            cap = {k: jnp.zeros((self.B,), D)
                   for k in ("v_dr", "v_y", "m_x", "norm")}
            if capture_state:
                cap["a"] = jnp.zeros((self.B, self.base.NHP, self.base.MP),
                                     D)
                cap["b"] = jnp.zeros((self.B, self.base.NHP, self.base.MP),
                                     D)
            states = self._initial_states()

        if self.mesh is not None and self.space_axis is not None:
            advance, states, cap = self._spatial_advance(
                weights, cap, states, unroll, capture_state)
        else:
            consts = self.consts
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                shard = NamedSharding(self.mesh, P(self.axis))
                repl = NamedSharding(self.mesh, P())
                # go through host numpy: every process holds the full
                # value, so device_put scatters the addressable shards —
                # this is what makes the same code path work on a
                # multi-host (DCN) mesh, where jax arrays committed to one
                # process's device could not be re-sharded globally
                put = lambda x, s: jax.device_put(  # noqa: E731
                    np.asarray(x), s)
                states = jax.tree.map(lambda x: put(x, shard), states)
                axes = in_axes._asdict()
                consts = stencil.StencilConsts(**{
                    k: put(jnp.asarray(v), shard if axes[k] == 0 else repl)
                    for k, v in consts._asdict().items()})
                cap = jax.tree.map(lambda x: put(x, shard), cap)

            def advance(st, cp, k):
                return _run_sweep(consts, st, cp, weights,
                                  in_axes=in_axes, n_steps=k,
                                  unroll=unroll,
                                  capture_state=capture_state)

        chunk = (checkpoint_every if checkpoint and checkpoint_every > 0
                 else self.n_steps - done)
        while done < self.n_steps:
            k = min(chunk, self.n_steps - done)
            states, cap = advance(states, cap, k)
            done += k
            if checkpoint is not None and done < self.n_steps:
                self._save_checkpoint(checkpoint, states, cap, done)
        if checkpoint is not None:
            self._save_checkpoint(checkpoint, states, cap, done)
        if capture_state:
            cap = dict(cap)
            self.final_ab = (self._fetch(cap.pop("a")),
                             self._fetch(cap.pop("b")))
        return self._finalize(states, cap)

    def _spatial_advance(self, weights, cap0, states, unroll,
                         capture_state=False):
        """Combined sweep x space execution (2-D mesh): device inputs +
        an advance(states, cap, k) closure."""
        from jax.sharding import NamedSharding

        mesh, sw, sp = self.mesh, self.axis, self.space_axis
        if self.base.MP % mesh.shape[sp]:
            raise ValueError(
                f"MP={self.base.MP} not divisible by {mesh.shape[sp]} "
                f"space shards")
        if self.B % mesh.shape[sw]:
            raise ValueError(
                f"B={self.B} not divisible by {mesh.shape[sw]} sweep shards")
        _, (consts_spec, state_spec, cap_spec, w_spec) = \
            _spatial_sweep_runner(mesh, sw, sp, self.in_axes, self.n_steps,
                                  unroll, capture_state)
        # host numpy -> global sharded arrays (multi-host safe, as in run())
        put = lambda x, p: jax.device_put(  # noqa: E731
            np.asarray(x), NamedSharding(mesh, p))
        consts = stencil.StencilConsts(**{
            k: put(v, getattr(consts_spec, k))
            for k, v in self.consts._asdict().items()})
        states = stencil.State(**{
            k: put(v, getattr(state_spec, k))
            for k, v in states._asdict().items()})
        cap0 = {k: put(v, cap_spec[k]) for k, v in cap0.items()}
        w = {k: put(v, w_spec[k]) for k, v in weights.items()}

        def advance(st, cp, k):
            run, _ = _spatial_sweep_runner(mesh, sw, sp, self.in_axes, k,
                                           unroll, capture_state)
            return run(consts, st, cp, w)

        return advance, states, cap0

    # -- checkpoint/resume ----------------------------------------------------

    _CAP_KEYS = ("v_dr", "v_y", "m_x", "norm")
    # scalar config a resume must reproduce (swept axes are compared as
    # arrays; these pin the NON-swept remainder and the schedule)
    _CFG_SCALARS = ("E_dc", "E_omega", "omega", "mu", "alpha", "B",
                    "dt", "t_start")

    def _save_checkpoint(self, path, states, cap, done):
        """Atomic .npz snapshot of the whole batch mid-sweep.  _fetch
        allgathers on multi-host meshes, so process 0's file alone is
        complete — only process 0 writes (same convention as the example
        launcher's output)."""
        import os

        # every process joins the _fetch allgathers (collectives); only
        # process 0 touches the filesystem afterwards
        data = {f"state_{k}": self._fetch(v)
                for k, v in states._asdict().items()}
        # all live capture keys, including the (B, NHP, MP) a/b snapshots
        # when the sweep was started with capture_state (sweep frames)
        data.update({f"cap_{k}": self._fetch(cap[k]) for k in cap})
        if jax.process_index() != 0:
            return
        for k, v in self.params.items():
            data[f"param_{k}"] = v
        for k in self._CFG_SCALARS:
            data[f"cfg_{k}"] = np.float64(getattr(self.cfg, k))
        data["done"] = np.asarray(done)
        data["n_steps"] = np.asarray(self.n_steps)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **data)     # savez keeps an .npz name
        os.replace(tmp, path)

    def _load_checkpoint(self, path, capture_state=False):
        z = np.load(path)
        expected_cap = set(self._CAP_KEYS) | (
            {"a", "b"} if capture_state else set())
        saved_cap = {k[len("cap_"):] for k in z.files
                     if k.startswith("cap_")}
        if saved_cap != expected_cap:
            raise ValueError(
                f"sweep checkpoint capture keys {sorted(saved_cap)} do not "
                f"match this run's {sorted(expected_cap)} (frames mode "
                f"mismatch — resume with the same frames-dir setting)")
        if int(z["n_steps"]) != self.n_steps:
            raise ValueError(
                f"sweep checkpoint ran {int(z['n_steps'])} total steps; "
                f"this grid runs {self.n_steps} — t-max/omega/dt must match")
        saved_axes = sorted(k[len("param_"):] for k in z.files
                            if k.startswith("param_"))
        if saved_axes != sorted(self.params):
            raise ValueError(
                f"sweep checkpoint was written by a different grid "
                f"(swept axes {saved_axes} vs {sorted(self.params)})")
        for k, v in self.params.items():
            if not np.array_equal(z[f"param_{k}"], v):
                raise ValueError(
                    f"sweep checkpoint was written by a different grid "
                    f"(axis {k!r} differs)")
        for k in self._CFG_SCALARS:
            if k in self.params:
                continue                      # swept: compared above
            if f"cfg_{k}" in z.files and (
                    float(z[f"cfg_{k}"]) != float(getattr(self.cfg, k))):
                raise ValueError(
                    f"sweep checkpoint was written with {k}="
                    f"{float(z[f'cfg_{k}'])!r}; this run has "
                    f"{float(getattr(self.cfg, k))!r}")
        states = stencil.State(**{
            k: z[f"state_{k}"] for k in stencil.State._fields})
        if states.a.shape != (self.B, self.base.NHP, self.base.MP):
            raise ValueError(
                f"sweep checkpoint shape {states.a.shape} does not match "
                f"(B={self.B}, {self.base.NHP}, {self.base.MP})")
        if states.a.dtype != self.base.np_dtype:
            raise ValueError(
                f"sweep checkpoint dtype {states.a.dtype} does not match "
                f"the dtype= setting ({np.dtype(self.base.np_dtype).name})")
        cap = {k: z[f"cap_{k}"] for k in sorted(saved_cap)}
        return states, cap, int(z["done"])

    @staticmethod
    def _fetch(x) -> np.ndarray:
        """Global array -> host numpy; allgathers across processes when the
        mesh spans hosts (multi-host sweeps: every process gets the full
        result table, like the reference's single output stream)."""
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(x,
                                                                tiled=True))
        return np.asarray(x)

    def _finalize(self, final: stencil.State, cap):
        D = self.base.np_dtype
        av = self._fetch(final.av)         # (B, 8): av_data[0..5] + Kahan
                                           # compensations in slots 6/7
        out = {k: self._fetch(v) for k, v in cap.items()}
        # per-point instability report (the sweep analogue of the
        # single-run NaN guard, runtime/loop.py:_check_finite): a diverged
        # point must not pass silently as NaN rows, but one bad point
        # should not kill the rest of the map either
        bad = ~(np.all(np.isfinite(av), axis=1)
                & np.all([np.isfinite(v) for v in out.values()], axis=0))
        # process-0-only, like the checkpoint/frames writers (_fetch
        # allgathers, so process 0's report covers every point)
        if np.any(bad) and not self.cfg.quiet and jax.process_index() == 0:
            import sys
            idx = np.flatnonzero(bad)
            vals = {k: np.asarray(v)[idx][:4].tolist()
                    for k, v in self.params.items()}
            print(f"# WARNING: {idx.size} sweep point(s) went non-finite "
                  f"(numerical instability — decrease dt, reference "
                  f"guidance src/boltzmann_c_solver.c:56-57): indices "
                  f"{idx[:8].tolist()} {vals}", file=sys.stderr)
        res = dict(av_count=av[:, 0])
        v_dr_m = np.empty(self.B, D)
        v_y_m = np.empty(self.B, D)
        m_x_m = np.empty(self.B, D)
        T = np.empty(self.B, D)
        for i, m in enumerate(self.models):
            v_dr_m[i] = m.v_dr_multiplier
            v_y_m[i] = m.v_y_multiplier
            m_x_m[i] = m.m_over_multiplier
            T[i] = m.T
        norm_mult = np.asarray(
            [D(2 * PI * np.sqrt(np.float64(m.alpha))) for m in self.models])
        res["v_dr_inst"] = (out["v_dr"] * v_dr_m).astype(D)
        res["v_y_inst"] = (out["v_y"] * v_y_m).astype(D)
        res["m_over_m_x_inst"] = (out["m_x"] * m_x_m).astype(D)
        # astype, not np.float64(): the latter collapses a size-1 batch to
        # a scalar (B=1 sweeps)
        res["norm"] = (out["norm"].astype(np.float64)
                       * norm_mult.astype(np.float64)).astype(D)
        res["v_dr_av"] = (av[:, 1] * v_dr_m).astype(D)
        res["v_y_av"] = (av[:, 2] * v_y_m).astype(D)
        res["m_over_m_x_av"] = (av[:, 3] * m_x_m).astype(D)
        res["A"] = ((av[:, 4] * v_dr_m).astype(D) / T).astype(D)
        res["Asin"] = ((av[:, 5] * v_dr_m).astype(D) / T).astype(D)
        return res
