"""FFT correlators vs brute-force oracles (the reference embeds the same
cross-check: viscosity.py:103-115)."""

import jax.numpy as jnp
import numpy as np
from scipy.integrate import cumulative_trapezoid

from mdproptools_tpu.ops import acf


def test_correlate_matches_brute():
    rng = np.random.default_rng(0)
    a = rng.normal(size=257)
    b = rng.normal(size=257)
    got = np.asarray(acf.correlate(jnp.asarray(a), jnp.asarray(b)))
    want = acf.correlate_brute(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_autocorrelate_matches_brute():
    rng = np.random.default_rng(1)
    x = rng.normal(size=300)
    got = np.asarray(acf.autocorrelate(jnp.asarray(x)))
    want = acf.autocorrelate_brute(x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_autocorrelate_unbiased_nondemeaned_semantics():
    """acovf(demean=False, unbiased=True): lag-k value =
    sum_t x_t x_{t+k} / (n-k)."""
    x = np.array([1.0, 2.0, 3.0, 4.0])
    got = np.asarray(acf.autocorrelate(jnp.asarray(x)))
    want = np.array([
        (1 + 4 + 9 + 16) / 4,
        (1 * 2 + 2 * 3 + 3 * 4) / 3,
        (1 * 3 + 2 * 4) / 2,
        (1 * 4) / 1,
    ])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_batched_correlate():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 4, 64))
    b = rng.normal(size=(3, 4, 64))
    got = np.asarray(acf.correlate(jnp.asarray(a), jnp.asarray(b)))
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(
                got[i, j], acf.correlate_brute(a[i, j], b[i, j]),
                rtol=1e-9, atol=1e-12,
            )


def test_cumtrapz_matches_scipy():
    rng = np.random.default_rng(3)
    y = rng.normal(size=100)
    got = np.asarray(acf.cumtrapz(jnp.asarray(y), 0.37))
    want = cumulative_trapezoid(y, dx=0.37)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_correlate_prime_factor_length():
    """Lengths whose 2T pad has large prime factors (a 101-file
    trajectory gives 2T = 202 = 2 * 101) must still match the brute
    oracle: the correlators zero-pad to the next power of two
    (acf._fft_len), which leaves lags 0..T-1 mathematically unchanged."""
    rng = np.random.default_rng(7)
    for n in (101, 10100 // 100, 509):  # primes / awkward sizes
        a = rng.normal(size=n)
        b = rng.normal(size=n)
        assert acf._fft_len(n) >= 2 * n - 1
        assert acf._fft_len(n) & (acf._fft_len(n) - 1) == 0  # pow2
        got = np.asarray(acf.correlate(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, acf.correlate_brute(a, b),
                                   rtol=1e-9, atol=1e-12)
        got = np.asarray(acf.autocorrelate(jnp.asarray(a)))
        np.testing.assert_allclose(got, acf.autocorrelate_brute(a),
                                   rtol=1e-9, atol=1e-12)


def test_host_and_device_routes_agree():
    """The size-aware dispatch (ops.acf._route_host) must be a pure
    performance decision: host pocketfft and the jnp path agree to f32
    roundoff on the same f32 inputs, and exactly-to-1e-13 in f64."""
    import mdproptools_tpu.ops.acf as acf

    rng = np.random.default_rng(7)
    a32 = rng.normal(size=(3, 2, 257)).astype(np.float32)
    b32 = rng.normal(size=(3, 2, 257)).astype(np.float32)
    try:
        acf._FORCE_DISPATCH = "host"
        ch = acf.correlate(a32, b32)
        ah = acf.autocorrelate(a32)
        ih = acf.cumtrapz(np.asarray(ah, np.float64), 0.5)
        assert isinstance(ch, np.ndarray) and ch.dtype == np.float32
        acf._FORCE_DISPATCH = "device"
        cd = np.asarray(acf.correlate(a32, b32))
        ad = np.asarray(acf.autocorrelate(a32))
        idv = np.asarray(acf.cumtrapz(np.asarray(ah, np.float64), 0.5))
    finally:
        acf._FORCE_DISPATCH = None
    np.testing.assert_allclose(ch, cd, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ah, ad, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ih, idv, rtol=1e-12, atol=1e-15)
    # f64: both routes compute in double (atol for the near-zero lags)
    a64 = a32.astype(np.float64)
    try:
        acf._FORCE_DISPATCH = "host"
        h = acf.autocorrelate(a64)
        acf._FORCE_DISPATCH = "device"
        d = np.asarray(acf.autocorrelate(a64))
    finally:
        acf._FORCE_DISPATCH = None
    np.testing.assert_allclose(h, d, rtol=1e-12, atol=1e-13)


def test_route_host_policy():
    """Small batches (either precision) go to host, big ones stay on
    device, on every backend; tracers always stay traced."""
    import jax

    import mdproptools_tpu.ops.acf as acf

    a32 = np.zeros((4, 64), np.float32)
    a64 = np.zeros((4, 64), np.float64)
    assert acf._route_host(a32, acf.HOST_FFT_MAX_ELEMS)
    assert acf._route_host(a64, acf.HOST_FFT_MAX_ELEMS)
    assert not acf._route_host(a32, acf.HOST_FFT_MAX_ELEMS + 1)
    assert not acf._route_host(a64, acf.HOST_FFT_MAX_ELEMS + 1)
    # tracers never leave the traced program
    traced = {"hit": None}

    def probe(x):
        traced["hit"] = acf._route_host(x, 10)
        return x

    jax.jit(probe)(jnp.asarray(a32))
    assert traced["hit"] is False
