#!/usr/bin/env python
"""Oracle-vs-device parity on a CLUSTER-EXERCISING scene.

The VGA parity artifact's room scene yields zero clusters, so it pins
nothing about the euclidean-clustering half of the pipeline. This harness
runs the full sequential oracle (normals -> seeds -> planar growth incl.
finalize gates -> euclidean clustering) against the device pipeline on
the cluttered room scene (noisy blobs -> real clusters) at a square
parity-defined size, and records the per-point agreement + per-half region
counts in CLUTTER_PARITY.json. The gate: agreement >= 0.99 with equal
planar and cluster counts.

Run on the GPU: python benchmarks/clutter_parity.py
(chip_smoke.py runs the same measurement in its parity phase; on the CPU,
prefix JAX_PLATFORMS=cpu.)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmarks", "clutter_oracle_cache.npz")
OUT = os.path.join(ROOT, "CLUTTER_PARITY.json")

# square: the reference's transposed seed accesses are UB off square grids
SCENE = {"h": 280, "w": 280, "f": 280.0, "seed": 1, "kind": "cluttered"}


def get_oracle(pts, origin, refresh=False):
    from benchmarks import vga_parity
    z = None if refresh else vga_parity.load_cache(CACHE, SCENE)
    if z is not None:
        return (z["labels"], json.loads(str(z["table"])),
                int(z["n_clusters"]))
    labels, _nrm, table, n_clusters = vga_parity.oracle_labels(pts, origin)
    np.savez_compressed(CACHE, labels=labels, table=json.dumps(table),
                        n_clusters=n_clusters, scene=json.dumps(SCENE))
    return labels, table, n_clusters


def measure(require_cache=False, seg=None):
    """The CLUTTER_PARITY.json record (see the module docstring)."""
    from benchmarks import vga_parity
    from pcseg_tpu.models import pipeline
    from pcseg_tpu.utils import runtime
    from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

    pts, origin = synthetic_cluttered_room_cloud(
        SCENE["h"], SCENE["w"], f=SCENE["f"], seed=SCENE["seed"])
    if require_cache and vga_parity.load_cache(CACHE, SCENE) is None:
        raise RuntimeError(f"{CACHE} is missing or stale")
    o_labels, o_table, o_clusters = get_oracle(pts, origin)

    t0 = time.perf_counter()
    seg = seg or pipeline.Segmenter(pipeline.SegmenterConfig())
    res = seg.segment_frame(pts, origin)
    dt = time.perf_counter() - t0
    d_labels = res.labels

    agreement = float((o_labels == d_labels).mean())
    both_labeled = (o_labels >= 0) & (d_labels >= 0)
    lab_agree = float((o_labels == d_labels)[both_labeled].mean()) \
        if both_labeled.any() else 1.0

    return {
        "scene": SCENE,
        "device": runtime.device_record(),
        "agreement": round(agreement, 6),
        "agreement_labeled": round(lab_agree, 6),
        "n_oracle_planar": len(o_table),
        "n_device_planar": res.metrics.num_planar_regions,
        "n_oracle_clusters": o_clusters,
        "n_device_clusters": res.metrics.num_clusters,
        # first call: includes compilation
        "device_seconds_with_compile": round(dt, 2),
    }


def main():
    result = measure()
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
