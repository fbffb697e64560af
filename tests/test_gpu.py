"""Tests that need an NVIDIA GPU.  They skip elsewhere; on a machine with
a card run them with

    SLB2D_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
"""

import numpy as np
import pytest

from slb2d_tpu.config import SimConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel
from slb2d_tpu.ops import frames, stencil
from slb2d_tpu.utils import env

from test_golden import COMMON, d4_values, read_gold, run_sim

pytestmark = pytest.mark.gpu


def test_plan_on_the_card(gpu):
    assert env.plan("auto", "f32") == env.Plan(
        platform="gpu", engine="xla", device_frames=True)


@pytest.mark.parametrize("gold,dtype,tol", [
    ("d4_base1_f32.txt", "f32", 2e-5),
    ("d4_base1_f64.txt", "f64", 1e-8),
])
def test_base1_vs_reference_on_the_card(gpu, tmp_path, monkeypatch, gold,
                                        dtype, tol):
    # the envelopes of tests/test_golden.py: the reference's FMA-rebuild
    # noise in f32, the <=1e-6 bar with margin in f64
    mine = run_sim(tmp_path, monkeypatch, display=4, dtype=dtype,
                   n_harmonics=20, g_grid=200, t_start=10.0)
    (g,), (m,) = d4_values(read_gold(gold)), d4_values(mine)
    np.testing.assert_allclose(m, g, rtol=tol,
                               atol=8e-6 if dtype == "f32" else tol * 0.1)


def test_device_frames_on_the_card(gpu):
    # float32 products at Precision.HIGHEST (no TF32) against the host's
    # float64 sums: a few f32 ulps of the largest |f|
    import jax

    model = SuperlatticeModel(SimConfig(display=7, n_harmonics=20,
                                        g_grid=1000, t_start=0.3,
                                        **{**COMMON, "omega": 10.0}))
    c = stencil.consts_from_model(model)
    step = stencil.make_step_fn(c, av_enabled=False, exact_trig=False)
    st = jax.jit(lambda s: jax.lax.scan(step, s, None, length=300)[0])(
        stencil.bootstrap_state(c, model))
    recon = frames.FrameReconstructor(model)
    M = model.M
    host = recon.reconstruct(np.asarray(st.a), np.asarray(st.b), 1, M + 2)
    dev, _ = recon.reconstruct_on_device(st.a, st.b, 1, M + 2)
    np.testing.assert_allclose(dev, host, rtol=1e-5,
                               atol=1e-6 * float(np.max(np.abs(host))))
