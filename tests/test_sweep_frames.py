"""Per-point sweep frames (`slb2d-sweep frames-dir=`): capture semantics,
frame-file format, sharded-path equality, and checkpoint interaction."""

import numpy as np

from slb2d_tpu.config import SimConfig
from slb2d_tpu.io.writers import f20
from slb2d_tpu.parallel import ParameterSweep, make_mesh
from slb2d_tpu import sweep_cli

BASE = dict(display=4, E_dc=1.0, E_omega=2.0, omega=10.0, mu=1.0,
            alpha=0.9495, n_harmonics=8, phi_y_min=-10.0, phi_y_max=10.0,
            B=0.1, t_start=0.3, g_grid=24, dt=1e-3, quiet=True,
            dtype="f64")


def test_capture_freezes_each_point_at_its_own_exit():
    """Points with shorter periods keep stepping until the longest point
    finishes; the captured (a, b) must be each point's state at ITS loop
    exit — pinned against B=1 sweeps whose scan ends exactly there."""
    cfg = SimConfig(**BASE)
    omegas = np.array([8.0, 12.0])        # different T -> different n_steps
    sw = ParameterSweep(cfg, {"omega": omegas})
    sw.run(capture_state=True)
    a2, b2 = sw.final_ab
    for i, om in enumerate(omegas):
        solo = ParameterSweep(cfg, {"omega": np.array([om])})
        solo.run(capture_state=True)
        a1, b1 = solo.final_ab
        np.testing.assert_allclose(a2[i], a1[0], rtol=1e-12, atol=1e-300,
                                   err_msg=f"a capture at omega={om}")
        np.testing.assert_allclose(b2[i], b1[0], rtol=1e-12, atol=1e-300,
                                   err_msg=f"b capture at omega={om}")
    # the omega=12 point's scan-end state is NOT its capture (it kept
    # evolving past its own t_max) — guard that the test is non-trivial
    assert sw.n_steps > ParameterSweep(
        cfg, {"omega": np.array([12.0])}).n_steps


def test_capture_matches_sharded_and_spatial_paths():
    cfg = SimConfig(**BASE)
    e = np.linspace(0.5, 2.0, 4)
    plain = ParameterSweep(cfg, {"E_dc": e})
    plain.run(capture_state=True)
    mesh = make_mesh((4,), ("sweep",))
    sharded = ParameterSweep(cfg, {"E_dc": e}, mesh=mesh)
    sharded.run(capture_state=True)
    comb = ParameterSweep(cfg, {"E_dc": e},
                          mesh=make_mesh((2, 4), ("sweep", "space")),
                          space_axis="space")
    comb.run(capture_state=True)
    for other, name in ((sharded, "sweep-sharded"), (comb, "sweep x space")):
        np.testing.assert_allclose(other.final_ab[0], plain.final_ab[0],
                                   rtol=1e-12, atol=1e-300, err_msg=name)
        np.testing.assert_allclose(other.final_ab[1], plain.final_ab[1],
                                   rtol=1e-12, atol=1e-300, err_msg=name)


def test_frames_cli_writes_reconstructed_points(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = sweep_cli.main([
        "sweep:E_dc=0.5;1.5", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
        "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
        "B=0.1", "t-max=0.3", "dt=1e-3", "g-grid=24", "quiet=1",
        "o=table.txt", f"frames-dir={tmp_path}/fr", "dtype=f64"])
    assert rc == 0
    d = tmp_path / "fr" / "grid00"
    idx = (d / "index.txt").read_text().splitlines()
    assert idx[0].startswith("#point")
    assert len(idx) == 3                          # header + 2 points
    assert float(idx[1].split()[1]) == 0.5        # E_dc of point 0

    # frame contents must equal reconstruction of the captured state
    cfg = SimConfig(**{**BASE, "E_dc": 0.5})
    sw = ParameterSweep(cfg, {"E_dc": np.array([0.5, 1.5])})
    res = sw.run(capture_state=True)
    from slb2d_tpu.ops.frames import FrameReconstructor
    recon = FrameReconstructor(sw.base)
    for i in (0, 1):
        lines = (d / f"point{i:04d}.data").read_text().splitlines()
        assert lines[0].startswith("# E_dc=")
        assert lines[-1] == "# norm=" + f20(res["norm"][i])
        F = recon.reconstruct(sw.final_ab[0][i], sw.final_ab[1][i],
                              1, sw.base.M + 2)
        body = lines[1:-1]
        assert len(body) == F.shape[0] * F.shape[1]
        # spot-check a full phi_x row of triplets
        X = F.shape[1]
        row7 = body[7 * X: 8 * X]
        got = np.array([float(l.split()[2]) for l in row7])
        np.testing.assert_allclose(got, F[7], rtol=1e-15, atol=5e-21)


def test_frames_with_interactive_refinement(tmp_path, monkeypatch):
    """Each refinement grid writes its own grid%02d frames directory; a
    rejected line must not consume a slot."""
    import io

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "sweep:E_dc=9,9,2 shards=3\n"         # rejected: bad override key
        "sweep:E_dc=2.0;2.5\n"
        "exit\n"))
    rc = sweep_cli.main([
        "sweep:E_dc=0.5;1.5", "E_dc=1", "E_omega=2", "omega=10", "mu=1",
        "alpha=0.9495", "n-harmonics=8", "PhiYmin=-10", "PhiYmax=10",
        "B=0.1", "t-max=0.3", "dt=1e-3", "g-grid=24", "quiet=1",
        "o=t.txt", f"frames-dir={tmp_path}/fr", "read-from=stdin"])
    assert rc == 0
    dirs = sorted(p.name for p in (tmp_path / "fr").iterdir())
    assert dirs == ["grid00", "grid01"]
    idx = (tmp_path / "fr/grid01/index.txt").read_text().splitlines()
    assert float(idx[1].split()[1]) == 2.0


def test_initial_states_buffers_are_donation_safe():
    """Every array in the batched initial State must own a distinct
    buffer: callers may donate the whole State (bench.py's sweep bench
    does), and one buffer aliased into two donated arguments is rejected
    by the device runtime (regression: hs_edge_a/hs_edge_b shared one
    zeros array)."""
    sw = ParameterSweep(SimConfig(**BASE), {"E_dc": np.array([0.5, 1.5])})
    st = sw._initial_states()
    ptrs = [leaf.unsafe_buffer_pointer()
            for leaf in st if hasattr(leaf, "unsafe_buffer_pointer")]
    assert len(ptrs) == len(set(ptrs)), "aliased buffers in initial State"


def test_frames_checkpoint_resume_roundtrip(tmp_path):
    """capture_state rides the sweep checkpoint: a resumed frames run
    equals an uninterrupted one, and a frames/no-frames mismatch is
    rejected."""
    import pytest

    cfg = SimConfig(**BASE)
    e = np.array([0.5, 1.5])
    plain = ParameterSweep(cfg, {"E_dc": e})
    plain.run(capture_state=True)

    ck = str(tmp_path / "sw.npz")
    # build a genuinely interrupted snapshot: advance half the steps with
    # the capture carry and save (the idiom of
    # tests/test_parallel.py::test_sweep_checkpoint_resume_equals_uninterrupted)
    import jax.numpy as jnp

    from slb2d_tpu.parallel.sweep import _run_sweep

    sw = ParameterSweep(cfg, {"E_dc": e})
    half = sw.n_steps // 2
    st = sw._initial_states()
    D = sw.base.np_dtype
    cap = {k: jnp.zeros((sw.B,), D) for k in sw._CAP_KEYS}
    cap["a"] = jnp.zeros((sw.B, sw.base.NHP, sw.base.MP), D)
    cap["b"] = jnp.zeros((sw.B, sw.base.NHP, sw.base.MP), D)
    st, cap = _run_sweep(sw.consts, st, cap, dict(
        w_d4=jnp.asarray(sw.base.w_d4),
        w_d4_phi=jnp.asarray(sw.base.w_d4_phi),
        w_norm=jnp.asarray(sw.base.w_norm)),
        in_axes=sw.in_axes, n_steps=half, unroll=1, capture_state=True)
    sw._save_checkpoint(ck, st, cap, half)

    sw2 = ParameterSweep(cfg, {"E_dc": e})
    res = sw2.run(resume=ck, capture_state=True)
    np.testing.assert_allclose(sw2.final_ab[0], plain.final_ab[0],
                               rtol=1e-12, atol=1e-300)
    assert np.all(np.isfinite(res["v_dr_inst"]))

    with pytest.raises(ValueError, match="capture keys"):
        ParameterSweep(cfg, {"E_dc": e}).run(resume=ck)  # no frames mode
