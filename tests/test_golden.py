"""End-to-end pinning against recorded outputs of the reference C solver.

Fixtures in tests/golden/ were produced by tests/golden/generate.sh from
the reference binaries (float32 build and an ffloat=double build — see
tests/oracle/build_reference.sh).  Tolerances: f64 vs f64 oracle must agree
to ~1e-8 (the ≤1e-6 BASELINE bar with margin); f32 vs f32 oracle is pinned
at 5e-5 (inherent float32 trajectory noise, docs/DEVIATIONS.md D7).
"""

import gzip
import io
import os
import sys

import numpy as np
import pytest

from slb2d_tpu.config import SimConfig
from slb2d_tpu.runtime.loop import Simulation

GOLD = os.path.join(os.path.dirname(__file__), "golden")

COMMON = dict(E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
              phi_y_min=-10.0, phi_y_max=10.0, B=0.1, dt=0.001, quiet=True)


def read_gold(name):
    path = os.path.join(GOLD, name)
    if name.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            return fh.read()
    with open(path) as fh:
        return fh.read()


def run_sim(tmp_path, monkeypatch, repl_input=None, **cfg_kw):
    cfg = SimConfig(out_file="out.txt", **{**COMMON, **cfg_kw})
    monkeypatch.chdir(tmp_path)
    sim = Simulation(cfg)
    stream = io.StringIO(repl_input) if repl_input is not None else None
    if repl_input is not None:
        sim.run(repl_stream=stream)
    else:
        sim.run()
    with open(tmp_path / "out.txt") as fh:
        return fh.read()


def d4_values(text):
    lines = [l for l in text.splitlines() if l and not l.startswith("#")]
    return [np.array(l.split(), float) for l in lines]


@pytest.mark.parametrize("gold,dtype,tol,extra", [
    ("d4_small_f64.txt", "f64", 1e-8, dict(n_harmonics=20, g_grid=200, t_start=1.0)),
    ("d4_small_f32.txt", "f32", 2e-5, dict(n_harmonics=20, g_grid=200, t_start=1.0)),
    ("d4_base1_f64.txt", "f64", 1e-8, dict(n_harmonics=20, g_grid=200, t_start=10.0)),
    ("d4_base1_f32.txt", "f32", 2e-5, dict(n_harmonics=20, g_grid=200, t_start=10.0)),
    ("d4_n40_f64.txt", "f64", 1e-8, dict(n_harmonics=40, g_grid=500, t_start=2.0)),
])
def test_display4_vs_reference(tmp_path, monkeypatch, gold, dtype, tol, extra):
    # f32 tolerance = the reference's own measured FMA-rebuild envelope
    # (tests/oracle/noise_floor.sh: 1.0e-5 rel at this horizon; the
    # cancellation-prone v_y column needs the atol term — see
    # docs/DEVIATIONS.md D7)
    gold_text = read_gold(gold)
    mine = run_sim(tmp_path, monkeypatch, display=4, dtype=dtype, **extra)
    gl, ml = d4_values(gold_text), d4_values(mine)
    assert len(gl) == len(ml) == 1
    np.testing.assert_allclose(ml[0], gl[0], rtol=tol,
                               atol=8e-6 if dtype == "f32" else tol * 0.1)
    # header lines must be byte-identical
    gh = [l for l in gold_text.splitlines() if l.startswith("#")]
    mh = [l for l in mine.splitlines() if l.startswith("#")]
    assert gh == mh


@pytest.mark.parametrize("gold,dtype,tol", [
    ("d4_base1_f32.txt", "f32", 2e-5),
    ("d4_base1_f64.txt", "f64", 1e-8),
])
def test_cli_base1_vs_reference(tmp_path, monkeypatch, gold, dtype, tol):
    """BASELINE #1 through the slb2d command line, as a user calls it,
    against the reference binary's line (tolerances as above)."""
    from slb2d_tpu import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["display=4", "E_dc=1.0", "E_omega=2.0", "omega=1.0",
                     "mu=1.0", "alpha=0.9495", "n-harmonics=20",
                     "PhiYmin=-10", "PhiYmax=10", "B=0.1", "t-max=10",
                     "g-grid=200", "dt=1e-3", f"dtype={dtype}",
                     "o=out.txt"]) == 0
    gold_text = read_gold(gold)
    mine = (tmp_path / "out.txt").read_text()
    (g,), (m,) = d4_values(gold_text), d4_values(mine)
    np.testing.assert_allclose(m, g, rtol=tol,
                               atol=8e-6 if dtype == "f32" else tol * 0.1)
    assert ([l for l in gold_text.splitlines() if l.startswith("#")]
            == [l for l in mine.splitlines() if l.startswith("#")])


def test_display3_vs_reference(tmp_path, monkeypatch):
    gold = read_gold("d3_tiny_f64.txt.gz").splitlines()
    mine = run_sim(tmp_path, monkeypatch, display=3, dtype="f64",
                   omega=10.0, n_harmonics=8, g_grid=24, t_start=0.5).splitlines()
    assert len(gold) == len(mine)
    for g, m in zip(gold, mine):
        if g.startswith("# norm="):
            assert m.startswith("# norm=")
            np.testing.assert_allclose(float(m[7:]), float(g[7:]), rtol=1e-9)
            continue
        gp, mp = g.split(), m.split()
        assert gp[:2] == mp[:2]          # phi_x, phi_y strings identical
        np.testing.assert_allclose([float(mp[2]), float(mp[3])],
                                   [float(gp[2]), float(gp[3])],
                                   rtol=1e-8, atol=1e-14)


def test_display77_schedule_and_norms(tmp_path, monkeypatch):
    """Emission times and norms must match the reference exactly; the other
    columns are not pinnable (reference OOB sums + in-place normalization,
    docs/DEVIATIONS.md D1/D2)."""
    gold = [l for l in read_gold("d77_tiny_f64.txt.gz").splitlines()
            if l and not l.startswith("#")]
    mine = [l for l in run_sim(tmp_path, monkeypatch, display=77,
                               dtype="f64", omega=10.0, n_harmonics=8,
                               g_grid=24, t_start=0.2).splitlines()
            if l and not l.startswith("#")]
    assert len(gold) == len(mine)
    for g, m in zip(gold, mine):
        gp, mp = np.array(g.split(), float), np.array(m.split(), float)
        assert gp.shape == mp.shape == (15,)
        np.testing.assert_allclose(mp[13], gp[13], rtol=0, atol=0)  # t
        np.testing.assert_allclose(mp[6], gp[6], rtol=1e-9)         # norm


def test_display3_f32_vs_reference(tmp_path, monkeypatch):
    """Display-3 at the PRODUCTION precision (f32) against the pristine
    reference binary (its display-3 loops are in-bounds — no patch
    needed); tolerance = the measured FMA envelope (DEVIATIONS D7)."""
    gold = read_gold("d3_tiny_f32.txt.gz").splitlines()
    mine = run_sim(tmp_path, monkeypatch, display=3, dtype="f32",
                   omega=10.0, n_harmonics=8, g_grid=24,
                   t_start=0.5).splitlines()
    assert len(gold) == len(mine)
    for g, m in zip(gold, mine):
        if g.startswith("# norm="):
            assert m.startswith("# norm=")
            np.testing.assert_allclose(float(m[7:]), float(g[7:]),
                                       rtol=2e-5)
            continue
        gp, mp = g.split(), m.split()
        assert gp[:2] == mp[:2]          # phi_x, phi_y strings identical
        np.testing.assert_allclose([float(mp[2]), float(mp[3])],
                                   [float(gp[2]), float(gp[3])],
                                   rtol=2e-4, atol=5e-6)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_display77_all_columns_f32_vs_patched_reference(tmp_path,
                                                        monkeypatch, impl):
    """ALL 15 display-77 columns at the PRODUCTION precision (f32)
    against the pristine-f32 + D1/D2-patch oracle build, through both
    spellings of the engine (the f32 run once pinned only t and norm).
    Tolerance = the measured FMA envelope (DEVIATIONS D7), with the atol
    term for the cancellation-prone v_y columns."""
    gold = [l for l in read_gold("d77_tiny_f32_fixed.txt.gz").splitlines()
            if l and not l.startswith("#")]
    mine = [l for l in run_sim(tmp_path, monkeypatch, display=77,
                               dtype="f32", impl=impl, omega=10.0,
                               n_harmonics=8, g_grid=24,
                               t_start=0.2).splitlines()
            if l and not l.startswith("#")]
    assert len(gold) == len(mine) > 50
    for g, m in zip(gold, mine):
        gp, mp = np.array(g.split(), float), np.array(m.split(), float)
        assert gp.shape == mp.shape == (15,)
        assert mp[13] == gp[13]                       # t bit-exact
        np.testing.assert_allclose(mp, gp, rtol=2e-4, atol=8e-6)


def test_display7_frames_f32_vs_reference(tmp_path, monkeypatch):
    """Movie frames at the PRODUCTION precision (f32) against the pristine
    reference binary: same cadence (frame indices are pinned exactly by
    the f32 schedule), in-bounds rows within the measured FMA-noise
    envelope (DEVIATIONS D7)."""
    M = 24
    run_sim(tmp_path, monkeypatch, display=7, dtype="f32",
            omega=10.0, n_harmonics=8, g_grid=M, t_start=0.2)
    for idx in (1, 12):
        gold = [l for l in read_gold(f"d7_frame{idx}_f32.txt.gz").splitlines()
                if not l.startswith("#")]
        with open(tmp_path / f"frame{idx:08d}.data") as fh:
            mine = [l for l in fh.read().splitlines()
                    if not l.startswith("#")]
        n_gold_rows = 2 * M + 1     # reference emits OOB rows (D3)
        n_my_rows = M + 1
        n_blocks = len(gold) // n_gold_rows
        assert len(mine) // n_my_rows == n_blocks
        for blk in range(0, n_blocks, 53):
            gblk = gold[blk * n_gold_rows: blk * n_gold_rows + n_my_rows]
            mblk = mine[blk * n_my_rows: (blk + 1) * n_my_rows]
            for g, m in zip(gblk, mblk):
                gp, mp = g.split(), m.split()
                assert gp[:2] == mp[:2]       # coordinates byte-identical
                np.testing.assert_allclose(float(mp[2]), float(gp[2]),
                                           rtol=2e-4, atol=3e-6)


def test_display77_all_columns_vs_patched_reference(tmp_path, monkeypatch):
    """ALL 15 display-77 columns pinned against the D1/D2-patched oracle
    build (in-bounds sums, non-mutating normalization — the semantics this
    framework implements; tests/oracle/build_reference.sh stages the
    patch).  The unpatched binary remains pinned for t/norm above."""
    gold = [l for l in read_gold("d77_tiny_f64_fixed.txt.gz").splitlines()
            if l and not l.startswith("#")]
    mine = [l for l in run_sim(tmp_path, monkeypatch, display=77,
                               dtype="f64", omega=10.0, n_harmonics=8,
                               g_grid=24, t_start=0.2).splitlines()
            if l and not l.startswith("#")]
    assert len(gold) == len(mine) > 50
    for g, m in zip(gold, mine):
        gp, mp = np.array(g.split(), float), np.array(m.split(), float)
        assert gp.shape == mp.shape == (15,)
        np.testing.assert_allclose(mp, gp, rtol=5e-9, atol=1e-12)


def test_display7_frames_vs_reference(tmp_path, monkeypatch):
    """Frame emission cadence and the in-bounds rows (m=1..M+1) of each
    frame must match; the reference emits extra OOB rows (D3)."""
    M = 24
    run_sim(tmp_path, monkeypatch, display=7, dtype="f64",
            omega=10.0, n_harmonics=8, g_grid=M, t_start=0.2)
    for idx in (1, 2):
        gold = [l for l in read_gold(f"d7_frame{idx}_f64.txt.gz").splitlines()
                if not l.startswith("#")]
        with open(tmp_path / f"frame{idx:08d}.data") as fh:
            mine = [l for l in fh.read().splitlines()
                    if not l.startswith("#")]
        n_gold_rows = 2 * M + 1
        n_my_rows = M + 1
        assert len(gold) % n_gold_rows == 0
        assert len(mine) % n_my_rows == 0
        n_blocks = len(gold) // n_gold_rows
        assert len(mine) // n_my_rows == n_blocks
        for blk in range(0, n_blocks, 37):   # sample blocks
            gblk = gold[blk * n_gold_rows: blk * n_gold_rows + n_my_rows]
            mblk = mine[blk * n_my_rows: (blk + 1) * n_my_rows]
            for g, m in zip(gblk, mblk):
                gp, mp = g.split(), m.split()
                assert gp[:2] == mp[:2]
                np.testing.assert_allclose(float(mp[2]), float(gp[2]),
                                           rtol=1e-8, atol=1e-14)


def test_repl_fuzz_session_vs_reference(tmp_path, monkeypatch):
    """Parameter-server FUZZ session against the recorded reference run
    (golden 7b): partial numeric prefixes, failed-%f one-token resume,
    unknown names, and `exit value timeout` NOT exiting.  The reference
    binary produced 5 display-4 rounds from this script — the parser must
    reproduce the identical round structure and headers."""
    gold_text = read_gold("repl_fuzz_f64.txt")
    mine_text = run_sim(
        tmp_path, monkeypatch, display=4, dtype="f64",
        n_harmonics=8, g_grid=24, t_start=0.5, omega=10.0,
        read_from="stdin",
        repl_input="E_dc 1.5x 0.40\nbogus 7 0.30\nB .25e0 0.35\n"
                   "exit 0.9 0.30\nmu abc 1.1 0.25\nexit\n")
    gold, mine = d4_values(gold_text), d4_values(mine_text)
    assert len(gold) == len(mine) == 5
    for g, m in zip(gold, mine):
        np.testing.assert_allclose(m, g, rtol=1e-8, atol=1e-12)
    gh = [l for l in gold_text.splitlines() if l.startswith("# display=")]
    mh = [l for l in mine_text.splitlines() if l.startswith("# display=")]
    assert gh == mh


def test_repl_display77_vs_patched_reference(tmp_path, monkeypatch):
    """Display-77 time series interleaved with a parameter-server
    mutation round (golden 7c, D1/D2-patched oracle): all 15 columns of
    every line across both rounds."""
    gold = [l for l in read_gold("repl_d77_f64.txt.gz").splitlines()
            if l and not l.startswith("#")]
    mine = [l for l in run_sim(tmp_path, monkeypatch, display=77,
                               dtype="f64", omega=10.0, n_harmonics=8,
                               g_grid=24, t_start=0.3,
                               read_from="stdin",
                               repl_input="E_dc 1.6 0.2\nexit\n")
                               .splitlines()
            if l and not l.startswith("#")]
    assert len(gold) == len(mine) > 100
    for g, m in zip(gold, mine):
        gp, mp = np.array(g.split(), float), np.array(m.split(), float)
        assert gp.shape == mp.shape == (15,)
        np.testing.assert_allclose(mp, gp, rtol=5e-9, atol=1e-12)


def test_parameter_server_session_vs_reference(tmp_path, monkeypatch):
    """Live parameter mutations (E_dc, B, mu, then omega — the last locks
    the GPU driver's T-recompute-from-new-omega semantics) must continue
    from the same state and reproduce all five display-4 lines."""
    gold = d4_values(read_gold("repl_f64.txt"))
    mine_text = run_sim(
        tmp_path, monkeypatch, display=4, dtype="f64",
        n_harmonics=8, g_grid=24, t_start=0.5, omega=10.0,
        read_from="stdin",
        repl_input="E_dc 1.5 0.5\nB 0.2 0.5\nmu 1.3 0.3\n"
                   "omega 12.0 0.3\nexit\n")
    mine = d4_values(mine_text)
    assert len(gold) == len(mine) == 5
    for g, m in zip(gold, mine):
        np.testing.assert_allclose(m, g, rtol=1e-8, atol=1e-12)
    # headers must track live mutations (t-max moves with t+timeout, mu
    # changes the printed value) byte-for-byte
    gh = [l for l in read_gold("repl_f64.txt").splitlines()
          if l.startswith("# display=")]
    mh = [l for l in mine_text.splitlines() if l.startswith("# display=")]
    assert gh == mh
