"""
Per-molecule center-of-mass / charge reductions via segment sums.

Device replacement for the reference's pandas groupby COM engine
(``common/com_mols.py:58-60``, ``rdf_cn.py:218-241``,
``diffusion.py:83-89``): one ``segment_sum`` per quantity instead of a
per-molecule Python/pandas apply. Works on a single frame (N, ...) or a
whole trajectory (T, N, ...) and jit/vmap-compiles to a handful of fused
XLA reductions.
"""

import jax
import jax.numpy as jnp


def segment_com(values, masses, mol_index, n_molecules):
    """Mass-weighted per-molecule average of ``values``.

    Args:
      values: (..., N, C) per-atom quantities (positions, velocities, ...).
      masses: (N,) per-atom masses.
      mol_index: (N,) int32/int64 0-based molecule segment ids (sorted or
        not; segment_sum handles either, pass sorted for speed).
      n_molecules: static segment count.
    Returns:
      (..., n_molecules, C) per-molecule mass-weighted means.
    """
    masses = masses.astype(values.dtype)
    weighted = values * masses[..., :, None]

    def one_frame(w):
        s = jax.ops.segment_sum(w, mol_index, num_segments=n_molecules)
        return s

    # flatten leading axes, segment-sum each frame
    lead = values.shape[:-2]
    w2 = weighted.reshape((-1,) + weighted.shape[-2:])
    sums = jax.vmap(one_frame)(w2)
    mass_tot = jax.ops.segment_sum(masses, mol_index, num_segments=n_molecules)
    out = sums / mass_tot[:, None]
    return out.reshape(lead + (n_molecules, values.shape[-1]))


def segment_sum_per_molecule(values, mol_index, n_molecules):
    """Plain per-molecule sum (e.g. molecular charge = sum of atomic q)."""
    lead = values.shape[:-1]
    v2 = values.reshape((-1, values.shape[-1]))
    out = jax.vmap(
        lambda v: jax.ops.segment_sum(v, mol_index, num_segments=n_molecules)
    )(v2)
    return out.reshape(lead + (n_molecules,))


def type_mean(values, type_index, n_types):
    """Mean of ``values`` over segments (e.g. per-species MSD average).

    Args:
      values: (..., M) per-entity values.
      type_index: (M,) 0-based type ids.
      n_types: static type count.
    Returns:
      (..., n_types) per-type means.
    """
    ones = jnp.ones(values.shape[-1], values.dtype)
    counts = jax.ops.segment_sum(ones, type_index, num_segments=n_types)
    lead = values.shape[:-1]
    v2 = values.reshape((-1, values.shape[-1]))
    sums = jax.vmap(
        lambda v: jax.ops.segment_sum(v, type_index, num_segments=n_types)
    )(v2)
    return (sums / counts).reshape(lead + (n_types,))
