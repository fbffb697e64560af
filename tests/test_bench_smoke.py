"""Smoke coverage for bench.py, the benchmark harness.

The real benchmark runs on a GPU (`python bench.py`); these tests pin the
harness itself (builders, runners, metric arithmetic, the device record
and the refusal to report a CPU number) on tiny CPU shapes so an API
drift in the package cannot silently break the benchmark run.
"""

import json

import jax
import numpy as np
import pytest

import bench


def test_bench_build_and_run_xla():
    model, state, run, engine = bench.build("xla", N=6, M=24)
    assert engine == "xla"
    state = run(state, 10)
    a = np.asarray(state.a)
    assert a.shape == (model.NHP, model.MP)
    assert np.all(np.isfinite(a))
    assert int(state.step) == 10


def test_bench_driver_metric():
    ups, wall, steps, engine = bench.bench_driver("xla", N=6, M=24,
                                                  t_start=0.05)
    assert steps > 0 and wall > 0 and engine == "xla"
    expected = 2 * 7 * 25 * steps / wall
    assert abs(ups - expected) / expected < 1e-12


def test_bench_refuses_cpu(capsys):
    assert bench.main(["xla", "24", "6"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_bench_cpu_smoke_line_names_device(capsys):
    assert bench.main(["--cpu-smoke", "xla", "24", "6"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["engine"] == "xla" and rec["value"] > 0
    dev = rec["device"]
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    assert set(dev) == {"platform", "kind", "count", "power_limit"}


def test_bench_sweep_metric():
    ups, wall, steps = bench.bench_sweep(B=4, K=8, reps=2, N=6, M=24)
    assert steps == 16 and wall > 0
    assert ups == pytest.approx(2 * 7 * 25 * 16 * 4 / wall, rel=1e-12)


def test_power_limit_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(bench.subprocess, "run", missing)
    assert bench.power_limit() is None


@pytest.mark.parametrize("spans,busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),
    ([(20, 30), (0, 10), (2, 4)], 20),
    ([(0, 10), (10, 20)], 20),
])
def test_union_of_op_intervals(spans, busy):
    assert bench._union_ns(spans) == busy


def test_peak_table_refuses_unknown_devices():
    assert bench.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        bench.peak_bytes_per_s("cpu")


def test_step_bytes_at_baseline4():
    from slb2d_tpu.config import SimConfig
    from slb2d_tpu.models.superlattice import SuperlatticeModel

    model = SuperlatticeModel(SimConfig(
        display=4, E_dc=1.0, E_omega=2.0, omega=1.0, mu=1.0, alpha=0.9495,
        n_harmonics=100, phi_y_min=-10.0, phi_y_max=10.0, B=0.1,
        t_start=1.0, g_grid=4000))
    assert (model.NHP, model.MP) == (104, 4096)
    assert bench.step_bytes(model) == 10 * 104 * 4096 * 4


def test_trace_summary_reads_a_recorded_trace(tmp_path):
    # a CPU trace has no GPU planes: nothing counts as a device op; the
    # same trace read through its host plane finds the XLA CPU ops' lines
    _, state, run, _ = bench.build("xla", N=6, M=24)
    state = jax.block_until_ready(run(state, 4))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(run(state, 4))
    s = bench.device_trace_summary(str(tmp_path), 4)
    assert s["kernels_per_step"] == 0 and s["idle_share"] is None
    with pytest.raises(FileNotFoundError):
        bench.device_trace_summary(str(tmp_path / "none"), 4)
