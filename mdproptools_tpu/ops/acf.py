"""
Batched Wiener-Khinchin FFT correlators.

Device-side replacement for the reference's three correlator variants,
with identical math:

- ``correlate(a, b)``: zero-pad to 2N cross-correlation with unbiased
  triangle renormalization (``conductivity.py:98-114``):
  ``out[k] = sum_t a[t+k] b[t] / (N - k)``.
- ``autocorrelate(x)``: the same with a == b (``viscosity.py:110-115``,
  'wkt'); equals ``statsmodels acovf(demean=False, unbiased=True,
  fft=True)`` used at ``residence_time.py:134-137``.
- brute-force variants kept as test oracles, mirroring the reference's
  own oracle (``viscosity.py:103-108``).

All functions broadcast over leading axes, so a whole (pairs x xyz x T)
block of correlations runs as one batched FFT on device.

Size-aware dispatch (host vs device)
------------------------------------
Batches of at most ``HOST_FFT_MAX_ELEMS`` = 2^22 padded points run on
HOST NumPy (pocketfft), larger ones as one batched device FFT. Measured
on an H100 (700 W) for one (B, T) float32/float64 batch, warm: the
device wins from 2^18 points up (2^16: host 1.3-3.0 ms, device 4.3-6.7
ms; 2^22: host 105-266 ms, device 7-12 ms; 2^24: host 0.43-1.25 s,
device 19-40 ms), but the first device call at a new series length
compiles for ~0.9-2.4 s. At and below 2^22 a one-shot correlation (a GK
leg at 10^4 frames is ~2^20 points) therefore stays on the host, where
it costs at most ~0.27 s; above it the device pays back its compilation
within a few calls of one length (the residence-time chunks repeat one
shape).

The host route computes in double (pocketfft promotes f32) and casts
back, so fast-mode host results are slightly CLOSER to strict-f64 than
the device c64 path; both are within the documented fast-mode envelope.
Tracers (calls under jit) always take the device path.
"""

import jax
import jax.numpy as jnp
import numpy as np

# Padded-point threshold for the host route (see the module docstring)
HOST_FFT_MAX_ELEMS = 1 << 22

# test hook: "host" | "device" | None (size-aware auto)
_FORCE_DISPATCH = None


def _route_host(x, batch_elems) -> bool:
    """True when this correlation should run on host NumPy. ``x`` is
    one input operand; ``batch_elems`` the total PADDED output points
    (broadcast batch x fft length)."""
    if isinstance(x, jax.core.Tracer):
        return False  # under jit: stay in the traced program
    if _FORCE_DISPATCH is not None:
        return _FORCE_DISPATCH == "host"
    return batch_elems <= HOST_FFT_MAX_ELEMS


def _fft_len(n: int) -> int:
    """Zero-pad length for linear correlation: the next power of two at
    or above 2N. Any pad >= 2N - 1 yields the SAME linear-correlation
    values (the extra samples are zeros; only lags 0..N-1 are kept) up
    to FFT roundoff — while a plain 2N pad inherits whatever prime
    factors T has (a 10,100-frame trajectory gives 2T = 2^3*5^2*101,
    whose radix-101 passes run several times slower per point on both
    the device FFT and pocketfft), and compiles a fresh XLA program per
    trajectory length. Power-of-two lengths are fastest and bucket many
    lengths onto one compiled program."""
    return 1 << (2 * n - 1).bit_length()


def _batch_elems(a, b, m):
    shape = np.broadcast_shapes(np.shape(a)[:-1], np.shape(b)[:-1])
    return int(np.prod(shape, dtype=np.int64)) * m


def correlate(a, b):
    """Unbiased FFT cross-correlation over the last axis.

    out[..., k] = sum_t a[..., t+k] * b[..., t] / (N - k),  k = 0..N-1
    """
    n = a.shape[-1]
    m = _fft_len(n)
    if _route_host(a, _batch_elems(a, b, m)):
        dt = np.dtype(a.dtype)
        a = np.asarray(a)
        b = np.asarray(b)
        fa = np.fft.fft(a, n=m, axis=-1)
        fb = np.fft.fft(b, n=m, axis=-1)
        c = np.fft.ifft(fa * np.conj(fb), axis=-1).real[..., :n]
        return (c / (n - np.arange(n))).astype(dt, copy=False)
    fa = jnp.fft.fft(a, n=m, axis=-1)
    fb = jnp.fft.fft(b, n=m, axis=-1)
    c = jnp.fft.ifft(fa * jnp.conj(fb), axis=-1).real[..., :n]
    norm = (n - jnp.arange(n)).astype(c.dtype)
    return c / norm


def autocorrelate(x):
    """Unbiased FFT autocorrelation over the last axis (WKT)."""
    n = x.shape[-1]
    m = _fft_len(n)
    if _route_host(x, _batch_elems(x, x, m)):
        dt = np.dtype(x.dtype)
        x = np.asarray(x)
        f = np.fft.fft(x, n=m, axis=-1)
        c = np.fft.ifft(f * np.conj(f), axis=-1).real[..., :n]
        return (c / (n - np.arange(n))).astype(dt, copy=False)
    f = jnp.fft.fft(x, n=m, axis=-1)
    c = jnp.fft.ifft(f * jnp.conj(f), axis=-1).real[..., :n]
    norm = (n - jnp.arange(n)).astype(c.dtype)
    return c / norm


def correlate_brute(a, b):
    """O(N^2) oracle for ``correlate`` (numpy, float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = a.shape[-1]
    out = np.zeros_like(a)
    for k in range(n):
        out[..., k] = np.sum(a[..., k:] * b[..., : n - k], axis=-1) / (n - k)
    return out


def autocorrelate_brute(x):
    """O(N^2) oracle for ``autocorrelate`` (numpy, float64), matching the
    reference's 'brute_force' method (np.correlate / descending counts)."""
    x = np.asarray(x, np.float64)
    full = np.correlate(x, x, "full")
    half = full[full.size // 2 :]
    return half / np.arange(len(x), 0, -1, dtype=np.float64)


def cumtrapz(y, dx):
    """Cumulative trapezoid over the last axis, N-1 points (the reference
    integrates correlation functions with scipy ``cumulative_trapezoid``,
    ``conductivity.py:231``, ``viscosity.py:151``). Same size-aware
    host/device dispatch as the correlators — integrating a
    just-host-computed ACF must not pay a device round trip."""
    if _route_host(y, int(np.prod(np.shape(y), dtype=np.int64))):
        y = np.asarray(y)
        avg = (y[..., 1:] + y[..., :-1]) * (dx / 2)
        return np.cumsum(avg, axis=-1)
    avg = (y[..., 1:] + y[..., :-1]) * (dx / 2)
    return jnp.cumsum(avg, axis=-1)
