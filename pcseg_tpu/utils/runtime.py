"""Process set-up shared by the on-card scripts (chip_smoke.py, bench.py,
benchmarks/*): the persistent compile cache, a description of the card
that every reported time is tagged with, and the serving-shape stream
inputs with the loop that times them.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """Where JAX's persistent compile cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, otherwise the fixed
    ``<checkout>/.jax_cache`` (a stable path is part of the cache key, so
    it is never temporary or per-process)."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir`; returns the directory. When
    the environment variable is set JAX already reads it, so nothing else
    is configured in code."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports it.
    Raises RuntimeError when nvidia-smi cannot be run or does not give
    both fields: no time on the card is reported without them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    fields = [f.strip() for f in lines[0].split(",")] if lines else []
    if len(fields) != 2 or not all(fields):
        raise RuntimeError(
            f"nvidia-smi gave no GPU name and power limit: {out!r}")
    return lines[0]


def device_record() -> dict:
    """The device as JAX reports it, plus the card line on a GPU."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "card": card_line() if d.platform == "gpu" else None}


def room_stream_batch(batch: int, h: int = 480, w: int = 640):
    """The serving shape's inputs: ``batch`` u16 range images of the
    synthetic room (seeds 1..batch) with the ray table, origin and depth
    scale, on the device, in the order ``Segmenter.device_forward_stream``
    takes them. Returns ``(frames, args)``; ``frames`` are the
    ``(points, origin)`` pairs the images were encoded from."""
    import jax.numpy as jnp
    from pcseg_tpu.ops import unproject
    from pcseg_tpu.utils.synthetic import synthetic_room_cloud
    frames = [synthetic_room_cloud(h, w, f=float(h), seed=s)
              for s in range(1, batch + 1)]
    depth = jnp.asarray(np.stack([unproject.encode_range(p)
                                  for p, _ in frames]))
    rays = jnp.asarray(unproject.camera_ray_table(h, w, f=float(h)))
    origin = jnp.asarray(frames[0][1])
    return frames, (depth, rays, origin, unproject.DEFAULT_DEPTH_SCALE)


def timed(fn: Callable, n: int) -> Tuple[object, List[float]]:
    """(last output, [seconds of each call]) of ``n`` calls of ``fn``,
    which must block until its results are on the host."""
    out, times = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times
