"""Distribution-function reconstruction for frame outputs.

f(phi_x, phi_y) = sum_n a_n cos(n phi_x) + b_n sin(n phi_x), evaluated on
the reference's phi_x grid (float accumulation from -PI by 0.01,
src/boltzmann_c_solver.c:341) — a dense (X, NH) x (NH, M) matmul, against
the reference's per-point (N+1)-length scalar loops.
"""

from __future__ import annotations

import numpy as np

from ..constants import PI

f64 = np.float64


def phi_x_grid(dtype=np.float32) -> np.ndarray:
    """The reference's float-accumulated phi_x samples:
    `for(ffloat phi_x = -PI; phi_x < PI; phi_x += 0.01)` (:341)."""
    vals = []
    x = dtype(-PI)
    while float(x) < PI:
        vals.append(x)
        x = dtype(f64(x) + 0.01)
    return np.asarray(vals, dtype)


class FrameReconstructor:
    """Precomputed cos/sin tables + the reconstruction matmul.

    Tables replicate the C argument computation cos((double)(n_f32 *
    phi_x_f32)) and are kept in float64; the contraction runs in float64 on
    host (frames are rare; a,b transfer is tiny) and the result is rounded
    to the model dtype before the clamp, matching the C `ffloat value`
    accumulation to within a few ulps.
    """

    def __init__(self, model):
        self.model = model
        D = model.np_dtype
        self.phi_x = phi_x_grid(D)
        n = np.arange(model.NHP, dtype=D)
        prod = (n[:, None] * self.phi_x[None, :]).astype(D)  # float product
        self.cos_t = np.cos(prod.astype(f64)).T.copy()       # (X, NHP)
        self.sin_t = np.sin(prod.astype(f64)).T.copy()
        self._dev_fn = None

    def reconstruct(self, a: np.ndarray, b: np.ndarray,
                    m_lo: int, m_hi: int, clamp=True) -> np.ndarray:
        """f over (phi_x, m) for m in [m_lo, m_hi); clamped at 0 (:348)."""
        D = self.model.np_dtype
        asl = a[:, m_lo:m_hi].astype(f64)
        bsl = b[:, m_lo:m_hi].astype(f64)
        F = (self.cos_t @ asl + self.sin_t @ bsl).astype(D)
        if clamp:
            F = np.maximum(F, 0)
        return F

    def reconstruct_on_device(self, a, b, m_lo: int, m_hi: int,
                              fetch=True):
        """Reconstruction for device-resident f32 states: one matmul on
        the device plus the norm row-sum — one small transfer instead of
        moving a and b to the host.  With fetch=False the device arrays
        (F, norm_sum) are returned un-materialized so the caller can fetch
        them from an IO thread, overlapping with the next compute chunk
        (they are fresh arrays, safe against donation of the state)."""
        import jax
        import jax.numpy as jnp
        if self._dev_fn is None:
            cos_t = jnp.asarray(self.cos_t.astype(np.float32))
            sin_t = jnp.asarray(self.sin_t.astype(np.float32))
            w_norm = jnp.asarray(self.model.w_norm.astype(np.float32))

            # Precision.HIGHEST: a default-precision f32 matmul may run
            # in TF32 on the GPU's tensor cores (10-bit mantissa), which
            # would cost frame values and the printed norm ~3 significant
            # digits; HIGHEST keeps full float32 products
            hp = jax.lax.Precision.HIGHEST

            def f(a, b):
                asl = jax.lax.slice_in_dim(a, m_lo, m_hi, axis=1)
                bsl = jax.lax.slice_in_dim(b, m_lo, m_hi, axis=1)
                F = (jnp.dot(cos_t, asl, precision=hp,
                             preferred_element_type=jnp.float32)
                     + jnp.dot(sin_t, bsl, precision=hp,
                               preferred_element_type=jnp.float32))
                return jnp.maximum(F, 0), jnp.dot(a[0], w_norm, precision=hp)

            self._dev_fn = (jax.jit(f), (m_lo, m_hi))
        fn, rng = self._dev_fn
        assert rng == (m_lo, m_hi), "one reconstructor per slice range"
        F, norm_sum = fn(a, b)
        if fetch:
            return np.asarray(F), np.asarray(norm_sum)
        return F, norm_sum

    def reconstruct_equilibrium(self, m_lo: int, m_hi: int) -> np.ndarray:
        a0 = self.model.a0[:, m_lo:m_hi].astype(f64)
        F0 = (self.cos_t @ a0).astype(self.model.np_dtype)
        return np.maximum(F0, 0)
