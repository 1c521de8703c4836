"""
The one backend decision of the program.

``platform()`` is the JAX platform the program runs on, "gpu" or "cpu";
any other is an error: nothing falls back silently. ``pair_backend()``
names the path every pair histogram and count takes:

- ``"gpu"``: the Triton pair kernel (``ops.pair_kernel``) over spatially
  sorted tiles;
- ``"cpu"``: the plain XLA path (``ops.pairs.pair_hist_rows`` /
  ``pair_count_within``), which is also the reference the kernel is
  tested against.

``_FORCE`` is the hook tests and measurements use: ``"gpu"`` on the CPU
backend runs the kernel in Pallas interpret mode (the only place
interpret mode ever engages); ``"cpu"`` on a GPU runs the plain XLA path
there, so the two can be timed against each other on the card.
"""

import jax

_FORCE = None  # None | "gpu" | "cpu"


def platform() -> str:
    """The JAX platform: "gpu" or "cpu"."""
    name = jax.default_backend()
    if name not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: the pair paths run on "
            "'gpu' (Triton kernel) or 'cpu' (plain XLA)")
    return name


def pair_backend() -> str:
    return _FORCE or platform()


def kernel_interpret() -> bool:
    """True when the GPU pair kernel must run in interpret mode: only on
    the CPU backend, never on a card."""
    return platform() == "cpu"
