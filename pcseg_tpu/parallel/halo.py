"""Halo exchange primitives for spatially-sharded grids.

The cloud grid [H, W] is sharded over columns across a 1-D mesh axis; every
windowed op (normal scans, seed windows, region dilation, cluster linking)
needs a ring of neighbor columns. ``exchange_halo`` pads each local block
with its neighbors' edge columns via two ``ppermute`` shifts over the
device interconnect (NVLink between the cards of one GPU host) — the
data-parallel replacement for the reference's pointer-chasing adjacency
(SURVEY.md §5 long-context/SP analogue).

All functions must be called inside ``shard_map`` with the given axis name.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_halo(block, k: int, axis_name: str, fill=jnp.nan, axis: int = 1):
    """Pad a local [H, W_local, ...] block with k neighbor columns per side.

    Boundary shards receive ``fill`` (grid edge semantics — identical to the
    single-device ops' out-of-bounds fill). Supports halos WIDER than the
    local block (k > W_local): hop j fetches the full block of the j-th
    neighbor via one ppermute per hop, and the concatenation is sliced to
    exactly k columns.

    Returns [H, W_local + 2k, ...].
    """
    if k == 0:
        return block
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    w_local = block.shape[axis]

    if k <= w_local:
        # single hop of k edge columns each way
        left_edge = lax.slice_in_dim(block, 0, k, axis=axis)
        right_edge = lax.slice_in_dim(block, w_local - k, w_local, axis=axis)
        right_halo_src = lax.ppermute(
            right_edge, axis_name, [(i, (i + 1) % n) for i in range(n)])
        left_halo_src = lax.ppermute(
            left_edge, axis_name, [(i, (i - 1) % n) for i in range(n)])
        fill_arr = jnp.full_like(left_edge, fill)
        left_halo = jnp.where(idx == 0, fill_arr, right_halo_src)
        right_halo = jnp.where(idx == n - 1, fill_arr, left_halo_src)
        return jnp.concatenate([left_halo, block, right_halo], axis=axis)

    # multi-hop: fetch whole blocks from neighbors at distance 1..hops
    hops = -(-k // w_local)
    fill_block = jnp.full_like(block, fill)
    lefts = []   # blocks left of ours, nearest last
    rights = []  # blocks right of ours, nearest first
    for j in range(1, hops + 1):
        from_left = lax.ppermute(
            block, axis_name, [(i, (i + j) % n) for i in range(n)])
        from_right = lax.ppermute(
            block, axis_name, [(i, (i - j) % n) for i in range(n)])
        lefts.insert(0, jnp.where(idx >= j, from_left, fill_block))
        rights.append(jnp.where(idx < n - j, from_right, fill_block))
    left_halo = jnp.concatenate(lefts, axis=axis)
    right_halo = jnp.concatenate(rights, axis=axis)
    left_halo = lax.slice_in_dim(
        left_halo, left_halo.shape[axis] - k, left_halo.shape[axis],
        axis=axis)
    right_halo = lax.slice_in_dim(right_halo, 0, k, axis=axis)
    return jnp.concatenate([left_halo, block, right_halo], axis=axis)


def crop_halo(block, k: int, axis: int = 1):
    """Remove k columns per side added by exchange_halo."""
    if k == 0:
        return block
    return lax.slice_in_dim(block, k, block.shape[axis] - k, axis=axis)
