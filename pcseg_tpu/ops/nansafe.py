"""Fast-math-proof NaN/Inf detection for device code.

The reference encodes invalid points as NaN (multichannel_cloud.proto:30-31)
and relies on IEEE comparison semantics — ``plane.absDistance(NaN) < tau``
is false — to keep invalid points out of every region
(planar_region.h:163-170). A compiler is free to FOLD those semantics
away inside large fused programs, and one backend this project ran on did:
both NaN comparisons and ``jnp.isfinite`` silently evaluated as if the
values were ordinary numbers, letting region growth and euclidean
clustering claim NaN-hole cells at VGA scale (their zero-substituted
moment sums then tilted the plane refits and fragmented the dominant
regions). Small standalone programs showed correct NaN behavior — the
rewrite is fusion-context-dependent, so no float-arithmetic formulation
is trustworthy.

This module tests finiteness on the INTEGER view of the float: a float is
non-finite iff its exponent bits are all ones. Integer bitops are outside
the scope of any floating-point fast-math rewrite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EXP_MASK = {
    jnp.dtype(jnp.float32): (jnp.uint32, 0x7F800000),
    jnp.dtype(jnp.bfloat16): (jnp.uint16, 0x7F80),
    jnp.dtype(jnp.float16): (jnp.uint16, 0x7C00),
    jnp.dtype(jnp.float64): (jnp.uint64, 0x7FF0000000000000),
}


def isfinite(x: jnp.ndarray) -> jnp.ndarray:
    """Elementwise finite test via exponent bits (True = finite).

    Drop-in for ``jnp.isfinite`` on float inputs; non-float inputs fall
    back to ``jnp.isfinite`` (always True for ints).
    """
    entry = _EXP_MASK.get(jnp.dtype(x.dtype))
    if entry is None:
        return jnp.isfinite(x)
    itype, mask = entry
    bits = jax.lax.bitcast_convert_type(x, itype)
    return (bits & itype(mask)) != itype(mask)


def all_finite(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """``jnp.all(isfinite(x), axis)`` — the common channel-reduced form."""
    return jnp.all(isfinite(x), axis=axis)


def sanitize(x: jnp.ndarray, fill=0.0) -> jnp.ndarray:
    """Replace non-finite entries by ``fill`` using the robust mask."""
    return jnp.where(isfinite(x), x, jnp.asarray(fill, x.dtype))
