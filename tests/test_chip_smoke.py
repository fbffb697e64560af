"""chip_smoke.py's checks and its refusal to run without a GPU, on CPU
inputs (the script itself runs on the card: `python chip_smoke.py`)."""

import json
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke


def test_compare_passes_inside_tolerance(capsys):
    ratio = chip_smoke.compare("x", [1.0, 2.0 + 1e-6], [1.0, 2.0],
                               rtol=1e-6, atol=0.0)
    assert 0 < ratio <= 1
    assert "x: max err/tol" in capsys.readouterr().out


@pytest.mark.parametrize("got,want,msg", [
    ([1.0, 2.1], [1.0, 2.0], "Not equal"),
    ([1.0], [1.0, 2.0], "shape"),
    ([np.nan, 2.0], [1.0, 2.0], "non-finite"),
    ([np.inf], [np.inf], "non-finite"),
])
def test_compare_fails(got, want, msg):
    with pytest.raises(AssertionError, match=msg):
        chip_smoke.compare("x", got, want, rtol=1e-6, atol=1e-9)


def test_d4_values_skips_headers():
    text = ("# display=4 E_dc=1\n#E_{dc} ...\n"
            "1.0 2.0 1.0 1.0 0.5 0.3 1.00002 0 0 0 0 0 0\n\n")
    (line,) = chip_smoke.d4_values(text)
    assert line.shape == (13,) and line[chip_smoke.NORM_COL] == 1.00002


@pytest.mark.parametrize("norm,ok", [(1.0, True), (1.0009, True),
                                     (0.9991, True), (1.002, False),
                                     (float("nan"), False)])
def test_check_norm(norm, ok):
    line = np.zeros(13)
    line[chip_smoke.NORM_COL] = norm
    if ok:
        chip_smoke.check_norm("n", line)
    else:
        with pytest.raises(AssertionError, match="NORM"):
            chip_smoke.check_norm("n", line)


def test_frame_values(tmp_path):
    p = tmp_path / "frame00000001.data"
    p.write_text("# t=0.5\n-3.14 -10.0 0.25\n-3.13 -10.0 0.5\n"
                 "# norm=1.0\n")
    np.testing.assert_array_equal(chip_smoke.frame_values(str(p)),
                                  [[-3.14, -10.0, 0.25], [-3.13, -10.0, 0.5]])


def test_refuses_a_machine_without_nvidia_smi(monkeypatch, capsys):
    monkeypatch.setattr(bench, "power_limit", lambda: None)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err and out.out == ""


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_refuses_cpu_and_prints_no_result(monkeypatch, capsys, argv):
    monkeypatch.setattr(bench, "power_limit", lambda: "Some Card, 100.00 W")
    assert chip_smoke.main(argv) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err
    for line in out.out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_alone_without_the_repo_fails(tmp_path):
    # the script on its own, without the repository beside it, fails
    # before it prints anything of a result
    (tmp_path / "chip_smoke.py").write_text(open(chip_smoke.__file__).read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                            "HOME": str(tmp_path)})
    assert r.returncode != 0
    assert "ModuleNotFoundError" in r.stderr
    assert '"ok"' not in r.stdout
