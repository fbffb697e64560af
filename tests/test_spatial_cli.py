"""Driver-integrated spatial sharding (`shards=` CLI flag): a space-sharded
simulation must reproduce the single-device run through the REAL driver —
displays, batched emissions, REPL — on the 8-virtual-device CPU mesh.

f64 so any disagreement beyond reduction-order noise (~1e-15) is a logic
bug in the halo exchange / psum wiring, not float noise."""

import glob
import io
import os

import numpy as np
import pytest

from slb2d_tpu import cli, config as cfgmod
from slb2d_tpu.runtime.loop import Simulation

ARGS = ["E_dc=1.0", "E_omega=2.0", "omega=10.0", "mu=1.0", "alpha=0.9495",
        "n-harmonics=8", "PhiYmin=-5", "PhiYmax=5", "B=0.1", "t-max=0.3",
        "g-grid=32", "dt=0.001", "quiet=1", "dtype=f64"]


def _data_lines(path):
    return [ln for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#")]


def test_shards_display4_matches_single(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["display=4", *ARGS, "o=single.txt"]) == 0
    assert cli.main(["display=4", *ARGS, "o=sharded.txt", "shards=4"]) == 0
    v1 = np.array(_data_lines("single.txt")[0].split(), float)
    v4 = np.array(_data_lines("sharded.txt")[0].split(), float)
    np.testing.assert_allclose(v4, v1, rtol=1e-12, atol=1e-14)


def test_shards_display77_batched_emissions(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["display=77", *ARGS, "o=single.txt"]) == 0
    assert cli.main(["display=77", *ARGS, "o=sharded.txt", "shards=8"]) == 0
    l1, l8 = _data_lines("single.txt"), _data_lines("sharded.txt")
    assert len(l1) == len(l8) and len(l1) > 5
    for a, b in zip(l1, l8):
        np.testing.assert_allclose(np.array(b.split(), float),
                                   np.array(a.split(), float),
                                   rtol=1e-12, atol=1e-14)


def test_shards_display7_frames(tmp_path, monkeypatch):
    d1 = tmp_path / "single"
    d4 = tmp_path / "sharded"
    d1.mkdir()
    d4.mkdir()
    monkeypatch.chdir(d1)
    assert cli.main(["display=7", *ARGS]) == 0
    monkeypatch.chdir(d4)
    assert cli.main(["display=7", *ARGS, "shards=4"]) == 0
    f1 = sorted(glob.glob(str(d1 / "frame*.data")))
    f4 = sorted(glob.glob(str(d4 / "frame*.data")))
    assert len(f1) == len(f4) and len(f1) >= 3
    for p1, p4 in zip(f1[-2:], f4[-2:]):
        r1 = np.array([ln.split() for ln in _data_lines(p1)], float)
        r4 = np.array([ln.split() for ln in _data_lines(p4)], float)
        np.testing.assert_allclose(r4, r1, rtol=1e-10, atol=1e-14)


def test_shards_repl_round(tmp_path, monkeypatch):
    """Parameter-server mutation on a sharded run: live state continues,
    results match the unsharded REPL session."""
    monkeypatch.chdir(tmp_path)
    script = "E_dc 1.5 0.05\nexit\n"
    outs = {}
    for name, extra in (("single", []), ("sharded", ["shards=4"])):
        cfg = cfgmod.parse_cmd(
            ["display=4", *ARGS, "read-from=stdin", f"o={name}.txt", *extra])
        sim = Simulation(cfg)
        sim.run(repl_stream=io.StringIO(script))
        outs[name] = [np.array(ln.split(), float)
                      for ln in _data_lines(f"{name}.txt")]
    assert len(outs["single"]) == 2     # initial round + one mutation round
    for a, b in zip(outs["single"], outs["sharded"]):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-14)


def test_shards_pallas_needs_f32():
    # the Pallas engines are gone: impl=pallas is refused when parsed (in
    # either dtype, sharded or not), never silently run on the XLA scan
    for extra in ([], ["dtype=f32"], ["dtype=f64"]):
        with pytest.raises(cfgmod.ConfigError):
            cfgmod.parse_cmd(["display=4", *ARGS, "shards=4", "impl=pallas",
                              *extra])
    with pytest.raises(ValueError, match="impl="):
        Simulation(cfgmod.SimConfig(**{
            **vars(cfgmod.parse_cmd(["display=4", *ARGS, "shards=4"])),
            "impl": "pallas"}))


def test_shards_indivisible_raises():
    # 5 does not divide the lane-padded MP=128
    cfg = cfgmod.parse_cmd(["display=4", *ARGS, "shards=5", "o=/dev/null"])
    with pytest.raises(ValueError, match="does not divide"):
        Simulation(cfg)
