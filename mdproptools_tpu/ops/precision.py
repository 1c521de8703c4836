"""
Precision policy: ``fast`` (float32 device math, float32 accumulation
— the speed path) vs ``strict`` (float64
end-to-end — bit-parity with the reference's NumPy math; how the test
suite runs, on the CPU backend with x64 enabled).
"""

import jax
import jax.numpy as jnp


def resolve_dtype(precision: str):
    if precision == "fast":
        return jnp.float32
    if precision == "strict":
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        return jnp.float64
    raise ValueError(f"precision must be 'fast' or 'strict', got {precision!r}")
