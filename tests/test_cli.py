"""CLI entry points end-to-end (in-process, CPU backend from conftest)."""

import os

import numpy as np

from slb2d_tpu import cli, sweep_cli

ARGS = ["E_dc=1.0", "E_omega=2.0", "omega=10.0", "mu=1.0", "alpha=0.9495",
        "n-harmonics=8", "PhiYmin=-5", "PhiYmax=5", "B=0.1", "t-max=0.2",
        "g-grid=32", "dt=0.001", "quiet=1"]


def test_cli_display4(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["display=4", *ARGS, "o=out.txt"])
    assert rc == 0
    lines = open("out.txt").read().splitlines()
    assert lines[0].startswith("# display=4")
    vals = np.array(lines[2].split(), float)
    assert vals.shape == (13,)
    assert abs(vals[6] - 1.0) < 1e-3          # norm conservation


def test_cli_unroll_and_warmup_knobs(tmp_path, monkeypatch):
    """warmup=1 pre-compiles without changing the observables.  unroll=
    belonged to a removed engine and is now an unknown key, which the
    reference parser ignores (src/boltzmann_cli.c:98-103)."""
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["display=4", *ARGS, "unroll=3", "warmup=1", "o=u3.txt"])
    assert rc == 0
    rc = cli.main(["display=4", *ARGS, "o=auto.txt"])
    assert rc == 0
    v3 = np.array(open("u3.txt").read().splitlines()[2].split(), float)
    va = np.array(open("auto.txt").read().splitlines()[2].split(), float)
    np.testing.assert_array_equal(v3, va)
    assert cli.main(["display=4", *ARGS, "unroll=-1", "o=n.txt"]) == 0
    assert cli.main(["display=4", *ARGS, "impl=stream"]) == 1
    assert cli.main(["display=4", *ARGS, "impl=pallas"]) == 1


def test_cli_checkpoint_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["display=8", *ARGS, "checkpoint=state.npz"]) == 0
    assert os.path.exists("frame.data") and os.path.exists("state.npz")
    assert cli.main(["display=4", *ARGS, "o=r.txt", "resume=state.npz"]) == 0


def test_cli_rejects_bad_args():
    assert cli.main(["display=4"]) == 1
    assert cli.main(["display=12", *ARGS]) == 1


def test_cli_rejects_out_of_range_device(capsys):
    # the reference aborts on cudaSetDevice failure
    # (src/boltzmann_solver.c:77 + HANDLE_ERROR :14)
    assert cli.main(["display=4", *ARGS, "device=99"]) == 1
    assert "invalid device ordinal" in capsys.readouterr().err


def test_sweep_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = sweep_cli.main(["display=4", *ARGS, "sweep:E_dc=0.5,1.5,2",
                         "sweep:B=0.0;0.2", "o=map.txt"])
    assert rc == 0
    rows = [l for l in open("map.txt") if not l.startswith("#")]
    assert len(rows) == 4                      # 2 x 2 cartesian grid
    vals = np.array([r.split() for r in rows], float)
    assert np.all(np.isfinite(vals))
    np.testing.assert_allclose(vals[:, -1], 1.0, atol=1e-3)  # norms


def test_sweep_cli_rejects_no_axes():
    assert sweep_cli.main(["display=4", *ARGS]) == 1


def test_out_file_append_mode(tmp_path, monkeypatch):
    """o=+file appends (reference: src/boltzmann_cli.c:171-173)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["display=4", *ARGS, "o=acc.txt"]) == 0
    n1 = len(open("acc.txt").readlines())
    assert cli.main(["display=4", *ARGS, "o=+acc.txt"]) == 0
    n2 = len(open("acc.txt").readlines())
    assert n2 == 2 * n1


def test_cli_compile_cache_dir(tmp_path, monkeypatch):
    """compile-cache-dir= plumbs into jax's persistent executable cache
    (whether a given backend writes entries depends on its compile-time
    thresholds; the product contract is the config plumbing)."""
    import jax

    monkeypatch.chdir(tmp_path)
    cache = tmp_path / "xla-cache"
    old = jax.config.jax_compilation_cache_dir
    try:
        rc = cli.main(["display=4", *ARGS, "o=out.txt",
                       f"compile-cache-dir={cache}"])
        assert rc == 0
        assert jax.config.jax_compilation_cache_dir == str(cache)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cli_parse_stops_at_first_bare_token():
    """Reference parser quirk (src/boltzmann_cli.c:98-103): parsing stops
    at the first token without '=', silently dropping everything after it
    — so `... quiet impl=xla` never sees impl=xla.  Unknown keys are
    ignored and later keys override earlier ones."""
    from slb2d_tpu import config as cfgmod

    cfg = cfgmod.parse_cmd(["display=4", *ARGS, "quiet", "impl=xla"])
    assert cfg.impl == "auto"          # impl=xla was after the bare token
    assert cfg.quiet is True           # from ARGS' quiet=1, not the token
    cfg = cfgmod.parse_cmd(["display=4", *ARGS, "impl=xla", "quiet"])
    assert cfg.impl == "xla"           # before the bare token: parsed
    cfg = cfgmod.parse_cmd(["display=4", *ARGS, "no-such-key=5",
                            "E_dc=7.5"])
    assert cfg.E_dc == 7.5             # unknown key skipped, later wins


def test_repl_scanner_fscanf_semantics():
    """scan_for_new_parameters is an fscanf("%s %f %f") emulation
    (src/boltzmann_cli.c:71-91) — the quirk matrix, unit level (the
    end-to-end sessions are pinned against the reference binary in
    tests/test_golden.py)."""
    import io

    from slb2d_tpu.config import scan_for_new_parameters as scan

    # exit with a full triple does NOT exit (pcount==3 skips the check)
    s = io.StringIO("exit 0.9 0.30\nexit\n")
    assert scan(s) == (None, 0.9, 0.30)
    assert scan(s) is None

    # partial numeric prefix + one-token failure resume: E_dc consumed,
    # 1.5 parsed, "x" pushed back; %f("x") fails (pcount 2); retry:
    # name="x", value=0.40, %f("bogus") fails (pcount 2); retry:
    # name="bogus", 7, 0.25 -> unknown-name mutation (verified against
    # the reference binary in the golden 7b fixture)
    s = io.StringIO("E_dc 1.5x 0.40 bogus 7 0.25\nexit\n")
    assert scan(s) == (None, 7.0, 0.25)
    assert scan(s) is None                   # bare exit

    # known-name mutation with .25e0-style floats and multi-line triples
    s = io.StringIO("B\n.25e0\n0.35\nmu 1.3 0.2 exit\n")
    assert scan(s) == ("B", 0.25, 0.35)
    assert scan(s) == ("mu", 1.3, 0.2)
    assert scan(s) is None                   # leftover "exit" then EOF

    # EOF mid-triplet: deviation D14 (the reference fscanf loop would
    # spin forever; we treat EOF as exit)
    s = io.StringIO("E_dc 1.5")
    assert scan(s) is None

    # inf/nan parse like C floats
    s = io.StringIO("E_dc inf 0.1\nexit\n")
    name, v, t = scan(s)
    assert name == "E_dc" and np.isinf(v) and t == 0.1
