"""The simulation driver: chunked lax.scan time loop + emissions + REPL.

Replaces the reference drivers (src/boltzmann_c_solver.c:83-287 and
src/boltzmann_solver.c:74-401).  The hot loop is a donated-carry
`jax.lax.scan` over host-precomputed step schedules (runtime/schedule.py);
the device is synchronized only at emission boundaries, never per step.
The interactive parameter server (read-from=stdin) continues from the live
device state exactly like the reference (:270-281) — the distribution is
never reset, only the scalar drive parameters and averaging window change.
"""

from __future__ import annotations

import concurrent.futures
import sys
import time

import jax
import numpy as np

from .. import config as cfgmod
from ..config import SimConfig  # noqa: F401  (public API)
from ..models.superlattice import SuperlatticeModel
from ..ops import frames, observables, stencil
from ..io import writers
from ..utils import env
from . import schedule
from .checkpoint import load_state, save_state


class NumericalInstability(RuntimeError):
    pass


class Simulation:
    def __init__(self, cfg: SimConfig, out=None):
        self.cfg = cfg
        # multi-host (DCN) spatial runs: every process executes the same
        # driver code (schedules and collectives must stay in lockstep);
        # process 0 owns every file/stream write, the rest write to
        # devnull and keep quiet.  State fetches allgather (_fetch_np)
        # and IO jobs run inline (the worker thread would reorder
        # collectives against the main thread).
        self._p0 = jax.process_index() == 0
        self._nprocs = jax.process_count()
        if out is not None:
            self.out = out
        elif self._p0:
            self.out = cfgmod.open_out(cfg)
        else:
            import os
            self.out = open(os.devnull, "w")
        self.quiet = cfg.quiet or not self._p0
        self._build_model()
        self.recon = None
        self.frame_number = 1
        self.strobe_values = None
        self._frame_batch = []
        # cross-round float carries (reference keeps these across the
        # parameter-server loop)
        self.frame_time = 0.0
        self.last_rem = 0.0
        self.t_exit = 0.0
        self._steps_since_progress = 0

        if cfg.resume:
            self.state, extra = load_state(cfg.resume, self.model)
            self.t0 = float(extra.get("t0", float(self.state.t)))
            self.frame_time = float(extra.get("frame_time", 0.0))
            self.frame_number = int(extra.get("frame_number", 1))
            # display-9 strobe carries: without these a resumed strobe run
            # would silently drop all accumulated periods and reset the
            # t/T wraparound reminder (reference semantics keep both live
            # across the whole run, src/boltzmann_solver.c:260-275,447-484)
            self.last_rem = float(extra.get("last_rem", 0.0))
            if "strobe_values" in extra:
                self.strobe_values = np.asarray(extra["strobe_values"])
            self.steps_done = int(self.state.step)
        else:
            self.state = stencil.bootstrap_state(self.c, self.model)
            self.t0 = 0.0
            self.steps_done = 0
        if self._mesh is not None:
            from ..parallel.spatial import shard_state
            self.state = shard_state(self.state, self._mesh)
        self.t_start = float(cfg.t_start)
        self.t_max = self._compute_t_max()

    # -- setup ---------------------------------------------------------------

    def _build_model(self):
        self.model = SuperlatticeModel(self.cfg)
        self.c = stencil.consts_from_model(self.model)
        self._runners = {}
        self._mesh = None
        if self.cfg.shards > 1:
            from ..parallel.mesh import make_mesh
            if self.model.MP % self.cfg.shards:
                raise ValueError(
                    f"shards={self.cfg.shards} does not divide the padded "
                    f"grid MP={self.model.MP}; pick a shard count dividing "
                    f"it (g-grid pads M+3 up to a multiple of 128)")
            self._mesh = make_mesh((self.cfg.shards,), ("space",))
        self.plan = env.plan(self.cfg.impl, self.cfg.dtype)
        self.impl = self.plan.engine

    def _compute_t_max(self):
        D = self.model.np_dtype
        T = self.model.T
        if self.cfg.display == 9:
            # src/boltzmann_solver.c:80-82
            return float(D(D(self.t_start) + D(101 * T)))
        return float(D(D(self.t_start) + T))

    def _runner(self, n_steps: int):
        if n_steps not in self._runners:
            collect = self._batched_emission()
            # exact-time=0 evaluates trig on device from the carried t
            # (fast mode); scheduling/emission cadence stays host-exact.
            # Display 77 always uses the exact tables: its averaging fires
            # only at emission steps, which only the schedule knows.
            exact = self.cfg.exact_time or self.cfg.display == 77
            # fast mode needs the display policy (the schedule encodes it
            # in exact mode): displays 7/77/8 do not average per step
            av_on = self.cfg.display not in (7, 77, 8)
            unroll = env.SCAN_UNROLL
            if self._mesh is not None:
                from ..parallel.spatial import make_sharded_step_runner
                self._runners[n_steps] = make_sharded_step_runner(
                    self.c, self.model, self._mesh, av_enabled=av_on,
                    exact_trig=exact, collect_obs=collect, unroll=unroll)
                return self._runners[n_steps]
            step = stencil.make_step_fn(self.c, av_enabled=av_on,
                                        exact_trig=exact,
                                        collect_obs=collect)

            def run(state, xs):
                return jax.lax.scan(step, state, xs, unroll=unroll)

            self._runners[n_steps] = jax.jit(run, donate_argnums=0)
        return self._runners[n_steps]

    def _batched_emission(self):
        """Display-77 lines are computed on-device inside the step loop
        (stacked as scan ys) and fetched once per chunk.  The reference
        paid a D2H pair per 0.01 t here (src/boltzmann_solver.c:234-245)."""
        return self.cfg.display == 77

    def _get_recon(self):
        if self.recon is None or self.recon.model is not self.model:
            self.recon = frames.FrameReconstructor(self.model)
        return self.recon

    # -- main ----------------------------------------------------------------

    def run(self, repl_stream=None):
        """Full run incl. the parameter-server outer loop; returns final
        State."""
        cfg = self.cfg
        if cfg.read_from == "stdin" and repl_stream is None:
            repl_stream = sys.stdin
        if not self.quiet:
            print(f"# t_max = {writers.f20(self.model.np_dtype(self.t_max))}")
        wall_t0 = time.perf_counter()
        steps0 = self.steps_done

        while True:
            self._run_round()

            if cfg.display == 3:
                a, b = self._host_ab()
                writers.write_display3(self.out, self.model,
                                       self._get_recon(), a, b)
                break
            if cfg.display == 8:
                # single-shot frame.data (GPU driver semantics,
                # src/boltzmann_solver.c:334-346)
                recon, F, norm = self._frame_and_norm()
                if not self.quiet:
                    print("\nWriting frame frame.data")
                if self._p0:
                    with open("frame.data", "w") as fh:
                        writers.write_frame(fh, self.model, recon, None,
                                            None, self._loop_t(), F=F,
                                            norm=norm)
                break
            if cfg.display == 4:
                av, a2, b2 = self._round_obs
                writers.write_display4(self.out, self.model, cfg, a2, b2,
                                       av, quiet=self.quiet,
                                       t_start=self.t_start)

            if repl_stream is None:
                break
            mut = self._scan_params(repl_stream)
            if mut is None:
                break
            self._apply_mutation(*mut)

        if not self.quiet:
            wall = time.perf_counter() - wall_t0
            steps = self.steps_done - steps0
            if steps and wall > 0:
                sites = 2 * (self.model.N + 1) * (self.model.M + 1) * steps
                print(f"\n# perf: {steps} steps in {wall:.3f}s = "
                      f"{steps / wall:.1f} steps/s "
                      f"({sites / wall:.3e} site-updates/s) "
                      f"[impl={self.impl}]")
        self._drain_io()
        if cfg.checkpoint:
            # multi-process: materialize the global state on every host
            # (collective), then process 0 writes the file
            host_state = (jax.tree.map(self._fetch_np, self.state)
                          if self._nprocs > 1 else self.state)
            # collective fetch on EVERY process (p0-only would deadlock
            # the allgather), then process 0 alone writes the file
            extra = {}
            if self.strobe_values is not None:
                extra["strobe_values"] = self._fetch_np(self.strobe_values)
            if self._p0:
                save_state(cfg.checkpoint, host_state, model=self.model,
                           t0=self.t_exit, frame_time=self.frame_time,
                           frame_number=self.frame_number,
                           last_rem=self.last_rem, **extra)
        if self.out not in (sys.stdout, sys.stderr):
            self.out.close()
        return self.state

    def _loop_t(self):
        """The C driver's post-loop `t` (first value failing t < t_max)."""
        return self.t_exit

    def _fetch_np(self, x):
        """Device value -> host numpy; on multi-process meshes a sharded
        array is not addressable from one process, so allgather it (the
        ParameterSweep._fetch convention)."""
        if self._nprocs > 1:
            from jax.experimental import multihost_utils
            return np.asarray(
                multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(x)

    def _schedule_kwargs(self):
        cfg = self.cfg
        model = self.model
        return dict(
            omega=model.omega, dt=model.dt, t0=self.t0,
            t_max=self.t_max, t_start=self.t_start,
            E_omega=model.E_omega, display=cfg.display,
            frame_start=cfg.frame_start, T=model.T,
            dtype=model.np_dtype,
            chunk_max=cfg.steps_per_chunk or 4096,
            frame_time0=self.frame_time,
            last_tT_reminder0=self.last_rem,
            break_on_e77=not self._batched_emission())

    def warmup(self):
        """Compile every step runner the upcoming round will need by
        running each distinct chunk length once on a throwaway copy of the
        state.  Keeps first-chunk compile latency out of the simulated run —
        useful before timing or profiling; never required for
        correctness."""
        import jax.numpy as jnp
        seen = set()
        for chunk in schedule.iter_chunks(**self._schedule_kwargs()):
            if chunk.n_steps in seen:
                continue
            seen.add(chunk.n_steps)
            st = jax.tree.map(jnp.array, self.state)   # donation fodder
            out, _ = self._runner(chunk.n_steps)(st, chunk.xs)
            jax.block_until_ready(out)
        if self.cfg.display in (3, 7, 8, 9):
            # frame-emitting displays: compile the reconstruction einsum too
            _, F, _ = self._frame_and_norm(fetch=False)
            jax.block_until_ready(F)
        self._fetch_round_obs()   # compile the round-end packed fetch

    def _run_round(self):
        cfg = self.cfg
        carry: dict = {}
        for chunk in schedule.iter_chunks(
                carry_out=carry, **self._schedule_kwargs()):
            prev_rows = None
            if chunk.event == "e77":
                # per-emission cut path: only reachable when batched
                # emission is disabled (kept as the specification of the
                # batched paths; cross-checked in tests/test_runtime.py)
                prev_rows = (np.asarray(self.state.a[:2]),
                             np.asarray(self.state.b[:2]))
            self.state, ys = self._runner(chunk.n_steps)(self.state,
                                                         chunk.xs)
            if chunk.emit_idx:
                recs = np.asarray(ys)[list(chunk.emit_idx)]
                for rec in recs:
                    writers.write_display77_from_record(
                        self.out, self.model, rec, quiet=self.quiet)
            self.steps_done += chunk.n_steps
            self._handle_event(chunk, prev_rows)
            self._progress(chunk)
        self._flush_frame_batch()
        self.frame_time = carry.get("frame_time", self.frame_time)
        self.last_rem = carry.get("last_rem", self.last_rem)
        self.t_exit = carry.get("t_exit", self.t0)
        self._round_obs = self._fetch_round_obs()
        self._check_finite(*self._round_obs[:2])

    def _fetch_round_obs(self):
        """ONE packed device->host transfer per round end: av plus (for
        display 4) harmonic rows 0/1 of a and b — everything the round-end
        NaN guard and the display-4 observable line read.  Separate small
        fetches each pay a full PCIe round trip; the full state (20 MB at
        BASELINE #4) never crosses the link."""
        import jax.numpy as jnp
        st = self.state
        if self.cfg.display == 4:
            MP = self.model.MP
            packed = self._fetch_np(jnp.concatenate(
                [st.av, st.a[:2].ravel(), st.b[:2].ravel()]))
            return (packed[:8], packed[8:8 + 2 * MP].reshape(2, MP),
                    packed[8 + 2 * MP:].reshape(2, MP))
        packed = self._fetch_np(jnp.concatenate([st.av, st.a[0, :8]]))
        return packed[:8], packed[8:16].reshape(1, 8), None

    def _handle_event(self, chunk, prev_rows=None):
        cfg = self.cfg
        model = self.model
        if chunk.event == "e77":
            # only with batched emission disabled (see _run_round)
            a_prev, b_prev = prev_rows
            writers.write_display77_line(
                self.out, model, a_prev, b_prev,
                np.asarray(self.state.av), chunk.t_last, quiet=self.quiet)
        elif chunk.event == "e7":
            F, norm_sum, finish = self._frame_parts()
            self._enqueue_frame("frame", F, norm_sum, finish, chunk.t_last)
        elif chunk.event == "e9":
            # strobe accumulation stays on device (host path: numpy); each
            # period's snapshot rides the same batched transfer as movie
            # frames (reference: per-period D2H, src/boltzmann_solver.c:
            # 260-275)
            F, norm_sum, finish = self._frame_parts()
            if self.strobe_values is None:
                self.strobe_values = F
            else:
                self.strobe_values = self.strobe_values + F
            self._enqueue_frame("strobe", self.strobe_values, norm_sum,
                                finish, chunk.t_last)

    def _progress(self, chunk):
        # reference: `\rt=... %` every 300 steps
        # (src/boltzmann_c_solver.c:206-213).  Chunks can span many meter
        # periods (the default chunk is 4096 steps), so the exact byte
        # stream is backfilled after each chunk from the schedule's
        # per-step t values: one line per 300-step boundary crossed, each
        # printing the loop t of the step that completed the period —
        # bit-identical t (and bytes) to the C meter, emitted in
        # per-chunk bursts (docs/DEVIATIONS.md D13).
        if self.quiet or self.out is sys.stdout or self.cfg.display == 7:
            return
        prev = self._steps_since_progress
        total = prev + chunk.n_steps
        self._steps_since_progress = total % 300
        if total < 300:
            return
        ts = chunk.xs["t"]
        # C computes t/t_max*100 in ffloat (the printf varargs promotion
        # to double happens AFTER the float arithmetic), so evaluate the
        # percentage at the build dtype or %0.2f can round differently
        D = self.model.np_dtype
        tm = D(self.t_max)
        lines = []
        for k in range(299 - prev, chunk.n_steps, 300):
            t = ts[k]
            pct = float(D(D(t / tm) * D(100))) if tm else 0.0
            lines.append(f"\rt={float(t):0.9f} {pct:0.2f}%")
        sys.stdout.write("".join(lines))
        sys.stdout.flush()

    _io_pool = None
    _io_futures: list = []

    def _io_pool_submit(self, fn):
        if self._nprocs > 1:
            # multi-process: fetches inside IO jobs may be collectives —
            # run inline so every process executes them in program order
            fn()
            return
        if self._io_pool is None:
            self._io_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
            self._io_futures = []
        self._io_futures.append(self._io_pool.submit(fn))

    def _drain_io(self):
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=True)
            self._io_pool = None
            futures, self._io_futures = self._io_futures, []
            for f in futures:
                f.result()   # surface write errors instead of losing them

    _frame_batch: list

    def _enqueue_frame(self, kind, F, norm_sum, finish, t):
        """Queue one frame/strobe emission; they accumulate on device and
        cross the host link as ONE stacked transfer per frame_batch
        entries (the reference paid a D2H pair per emission,
        src/boltzmann_solver.c:260-287).  Durability note: up to
        frame_batch-1 queued emissions are lost if the process dies
        mid-round; frame-batch=1 restores write-per-emission."""
        fname = f"{kind}{self.frame_number:08d}.data"
        self.frame_number += 1
        if not self.quiet:
            print(f"\nWriting {kind} {fname}")
        self._frame_batch.append((fname, F, norm_sum, finish, t, kind))
        if len(self._frame_batch) >= max(1, self.cfg.frame_batch):
            self._flush_frame_batch()

    def _flush_frame_batch(self):
        """Stack the pending movie frames on device and submit one
        fetch+format+write job (file order preserved by the single IO
        worker)."""
        batch, self._frame_batch = self._frame_batch, []
        if not batch:
            return
        import jax.numpy as jnp
        model = self.model
        recon = self._get_recon()
        on_device = batch[0][2] is not None
        Fs = (jnp.stack([rec[1] for rec in batch]) if on_device
              else np.stack([np.asarray(rec[1]) for rec in batch]))
        ns = (jnp.stack([rec[2] for rec in batch]) if on_device
              else None)

        def write(batch=batch, Fs=Fs, ns=ns):
            Fh = self._fetch_np(Fs)           # ONE transfer for k frames
            nh = (self._fetch_np(ns) if ns is not None
                  else [None] * len(batch))
            if not self._p0:                  # fetch joined; files are
                return                        # process 0's job
            for i, (fname, _, _, finish, t, kind) in enumerate(batch):
                with open(fname, "w") as fh:
                    if kind == "strobe":
                        writers.write_strobe(fh, model, recon, Fh[i],
                                             None, t, norm=finish(nh[i]))
                    else:
                        writers.write_frame(fh, model, recon, None, None,
                                            t, F=Fh[i], norm=finish(nh[i]))
        self._io_pool_submit(write)

    def _frame_parts(self):
        """(F, norm_sum, finish): the current frame, reconstructed on
        device when possible (F and norm_sum stay lazy device values;
        finish(norm_sum_host) applies the final scaling)."""
        model = self.model
        recon = self._get_recon()
        if self.plan.device_frames:
            F, norm_sum = recon.reconstruct_on_device(
                self.state.a, self.state.b, 1, model.M + 2, fetch=False)
            D = model.np_dtype
            from ..constants import PI

            def finish(s):
                return D(np.float64(D(s))
                         * (2 * PI * np.sqrt(np.float64(model.alpha))))
            return F, norm_sum, finish
        a, b = self._host_ab()
        F = recon.reconstruct(a, b, 1, model.M + 2)
        norm = observables.eval_norm(model, a)
        return F, None, (lambda s, _n=norm: _n)

    def _host_ab(self):
        return (self._fetch_np(self.state.a), self._fetch_np(self.state.b))

    def _frame_and_norm(self, fetch=True):
        """Reconstruct the current frame (m=1..M+1) and norm (see
        _frame_parts).  With fetch=False the returned F may be a lazy
        device value; norm is a thunk so the fetch + final scaling happen
        at write time in the IO thread."""
        recon = self._get_recon()
        F, ns, finish = self._frame_parts()

        def norm_value():
            return finish(self._fetch_np(ns) if ns is not None else None)
        if fetch:
            return recon, self._fetch_np(F), norm_value()
        return recon, F, norm_value

    def _check_finite(self, av, a_rows):
        a0row = a_rows[0, :8]
        if not (np.all(np.isfinite(av)) and np.all(np.isfinite(a0row))):
            raise NumericalInstability(
                "non-finite values in solver state — decrease dt "
                "(reference guidance, src/boltzmann_c_solver.c:56-57)")

    # -- parameter server ------------------------------------------------------

    def _scan_params(self, stream):
        """One parameter-server read; on multi-process meshes process 0
        reads the stream and broadcasts the mutation so every process
        applies the identical change in lockstep."""
        if self._nprocs == 1:
            return cfgmod.scan_for_new_parameters(stream)
        from jax.experimental import multihost_utils
        if self._p0:
            mut = cfgmod.scan_for_new_parameters(stream)
            if mut is None:
                payload = np.array([-1.0, 0.0, 0.0], np.float64)
            else:
                name, value, timeout = mut
                idx = (cfgmod.REPL_MUTABLE.index(name)
                       if name is not None else -2)
                payload = np.array([idx, value, timeout], np.float64)
        else:
            payload = np.zeros(3, np.float64)
        payload = np.asarray(
            multihost_utils.broadcast_one_to_all(payload))
        idx = int(payload[0])
        if idx == -1:
            return None
        name = cfgmod.REPL_MUTABLE[idx] if idx >= 0 else None
        return name, float(payload[1]), float(payload[2])

    def _apply_mutation(self, name, value, timeout):
        """One live parameter change: t_start moves to t+timeout, t_max =
        t_start + OLD T, then T re-derives; averaging restarts; the
        distribution state is preserved (reference :270-281).

        Mutation semantics follow the GPU driver exactly (docs/DEVIATIONS.md
        D11): drive scalars (E_dc, E_omega, omega, B) and the output
        multipliers go live, but the equilibrium a0 and the magnetic
        stencil constant bdt stay frozen at their startup values
        (src/boltzmann_solver.c never recomputes them, :112-126)."""
        model = self.model
        D = model.np_dtype
        t = D(self.t_exit)             # C's loop-exit t
        old_T = model.T
        if name is not None:
            frozen = (self.model.a0, self.model.a0_ghost, self.model.bdt)
            self.cfg = self.cfg.replace(**{name: value})
            self._build_model()
            self.model.a0, self.model.a0_ghost, self.model.bdt = frozen
            self.c = stencil.consts_from_model(self.model)
            model = self.model
        self.t_start = float(D(t + D(timeout)))
        self.t_max = float(D(D(self.t_start) + old_T))
        self.t0 = float(D(t + model.dt))
        # the averaging window moved: refresh the live t_start in the
        # stencil consts (fast-trig mode gates on it)
        self.c = self.c._replace(t_start=model.np_dtype(self.t_start))
        # cached step fns closed over the OLD consts (incl. t_start) — drop
        # them even when the mutation named no parameter
        self._runners = {}
        self.state = self.state._replace(
            av=np.zeros(8, model.np_dtype),
            t=model.np_dtype(self.t0))
        if not self.quiet:
            print(f"# t_max = {writers.f20(D(self.t_max))}")
