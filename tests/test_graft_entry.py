"""The driver contract: __graft_entry__.dryrun_multichip must run in a
fresh process with NO environment preparation — the function itself must
bootstrap the n-virtual-device CPU backend (round-1 failure mode: the
bootstrap lived under __main__ only, and a stale av-shape assert)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env = dict(os.environ)
    # mirror the driver: no XLA_FLAGS / platform hints pre-set
    for k in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME"):
        env.pop(k, None)
    # dryrun_multichip forces the CPU platform itself, so the subprocess
    # stays off any accelerator the host machine has
    return env


def test_dryrun_multichip_fresh_process():
    code = ("from __graft_entry__ import dryrun_multichip; "
            "dryrun_multichip(8)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "dryrun_multichip OK" in r.stdout


def test_entry_compiles_single_device():
    # entry() must be jittable on whatever backend the test session uses
    import jax

    from __graft_entry__ import _build
    from slb2d_tpu.ops import stencil

    cfg, model, c = _build(N=6, M=29)
    state = stencil.bootstrap_state(c, model)

    def fn(st):
        trig = stencil.device_trig(c, st.t)
        do_av = (st.t >= c.t_start) & (st.t < c.t_end)
        return stencil.full_step(c, st, trig, do_av)

    out = jax.jit(fn)(state)
    assert out.a.shape == state.a.shape
    assert out.av.shape == (8,)
