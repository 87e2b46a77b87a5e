#!/usr/bin/env python
"""VGA-scale (560x560) oracle-vs-device parity measurement.

The north star is >=99% per-point label agreement vs the reference
semantics on VGA-class organized clouds (BASELINE.md). This harness
measures it at full scale on the synthetic room scene.

The oracle (sequential NumPy port of the reference, pcseg_tpu/oracle.py)
takes tens of minutes at VGA, so its output is cached in
``benchmarks/vga_oracle_cache.npz`` keyed by the scene parameters; the
device path re-runs each invocation. Results land in ``PARITY_VGA.json``
at the repo root:

  {"agreement": ..., "n_oracle_regions": ..., "n_device_regions": ...,
   "region_table": [...], "scene": {...}, "device": {...}}

The gate: agreement >= 0.99, equal region counts, every device region
within normal_dot > 0.999 of its oracle region; f32 throughout with
Precision.HIGHEST at every contraction.

Run on the GPU:  python benchmarks/vga_parity.py
(chip_smoke.py runs the same measurement in its parity phase.) On the CPU,
prefix JAX_PLATFORMS=cpu. tests/test_vga_parity.py asserts on the
committed PARITY_VGA.json and, under -m slow, re-derives it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmarks", "vga_oracle_cache.npz")
OUT = os.path.join(ROOT, "PARITY_VGA.json")

# VGA-class means the POINT COUNT (307k): the grid must be square because
# the reference's seed finders index transposed (segmentation.h:66,104,
# 208-209) — on a non-square grid the C++ itself reads out of bounds (UB),
# so 480x640 parity is undefined by construction. 560x560 = 313k points.
SCENE = {"h": int(os.environ.get("PCSEG_PARITY_H", 560)),
         "w": int(os.environ.get("PCSEG_PARITY_W", 560)),
         "f": float(os.environ.get("PCSEG_PARITY_F",
                                   os.environ.get("PCSEG_PARITY_H", 560))),
         "seed": 1}


def oracle_labels(pts, origin, progress=True):
    """Full oracle pipeline: normals -> plane-support seeds -> planar
    growth (incl. host finalize semantics) -> euclidean clustering."""
    from pcseg_tpu import oracle
    from pcseg_tpu.models.config import (
        PlanarRegionConfig, ClusterRegionConfig, SeedsFromPlaneSupportParams)

    t0 = time.perf_counter()
    nrm = oracle.compute_normals_organized(pts, origin)
    if progress:
        print(f"oracle normals: {time.perf_counter() - t0:.0f}s", flush=True)

    sp = SeedsFromPlaneSupportParams()
    t0 = time.perf_counter()
    seeds = oracle.find_seed_points_from_plane_support(
        pts, nrm, sp.neighborhood_size, sp.max_plane_distance,
        sp.min_num_support_points)
    if progress:
        print(f"oracle seeds: {time.perf_counter() - t0:.0f}s "
              f"({len(seeds)} seeds)", flush=True)

    labels = oracle.prepare_unlabeled_labels(pts)
    region = oracle.PlanarRegionOracle(PlanarRegionConfig())
    t0 = time.perf_counter()
    regions = oracle.segment_regions(
        region, {"points": pts, "normals": nrm}, seeds, labels, 0)
    if progress:
        print(f"oracle planar: {time.perf_counter() - t0:.0f}s "
              f"({len(regions)} regions)", flush=True)

    h, w = pts.shape[:2]
    # the pipeline's cluster seed vector is [hw-1 .. 0]: the driver pops
    # back-to-front, so col-major index 0 is tried first (pipeline.py:118)
    cl_seeds = list(range(h * w - 1, -1, -1))
    cluster = oracle.ClusterRegionOracle(ClusterRegionConfig())
    t0 = time.perf_counter()
    cregions = oracle.segment_regions(
        cluster, {"points": pts}, cl_seeds, labels, len(regions))
    if progress:
        print(f"oracle cluster: {time.perf_counter() - t0:.0f}s "
              f"({len(cregions)} clusters)", flush=True)

    table = [{"plane": list(map(float, r.plane)),
              "count": int(len(r.inlier_indices)),
              "area": float(r.area)} for r in regions]
    return labels, nrm, table, len(cregions)


def load_cache(path, scene):
    """The cached oracle arrays for ``scene``, or None when the cache is
    missing or was made for another scene."""
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=True)
    if json.loads(str(z["scene"])) != scene:
        return None
    return z


def get_oracle(pts, origin, refresh=False):
    z = None if refresh else load_cache(CACHE, SCENE)
    if z is not None:
        return (z["labels"], z["normals"],
                json.loads(str(z["table"])), int(z["n_clusters"]))
    labels, nrm, table, n_clusters = oracle_labels(pts, origin)
    np.savez_compressed(
        CACHE, labels=labels, normals=nrm, table=json.dumps(table),
        n_clusters=n_clusters, scene=json.dumps(SCENE))
    return labels, nrm, table, n_clusters


def device_labels(pts, origin, seg=None):
    from pcseg_tpu.models import pipeline
    seg = seg or pipeline.Segmenter(pipeline.SegmenterConfig())
    res = seg.segment_frame(pts, origin)
    table = [{"plane": list(map(float, np.asarray(r.plane))),
              "count": int(r.count), "area": float(r.area)}
             for r in res.planar_regions]
    return res.labels, table, res.metrics.num_clusters


def measure(refresh=False, require_cache=False, seg=None):
    """Parity of the device pipeline against the (cached) oracle on the
    560x560 room scene, as the PARITY_VGA.json record. ``require_cache``
    refuses to run the tens-of-minutes oracle when the cache is stale."""
    from pcseg_tpu.utils import runtime
    from pcseg_tpu.utils.synthetic import synthetic_room_cloud
    pts, origin = synthetic_room_cloud(
        SCENE["h"], SCENE["w"], f=SCENE["f"], seed=SCENE["seed"])

    if require_cache and load_cache(CACHE, SCENE) is None:
        raise RuntimeError(f"{CACHE} is missing or stale; regenerate it "
                           "with --refresh-oracle")
    o_labels, o_nrm, o_table, o_nclusters = get_oracle(pts, origin, refresh)
    t0 = time.perf_counter()
    d_labels, d_table, d_nclusters = device_labels(pts, origin, seg)
    dev_s = time.perf_counter() - t0

    agreement = float((o_labels == d_labels).mean())
    # agreement over points either side labeled (excludes the easy empty sky)
    labeled = (o_labels >= 0) | (d_labels >= 0)
    agreement_labeled = float(
        (o_labels[labeled] == d_labels[labeled]).mean()) if labeled.any() \
        else 1.0

    region_table = []
    for i in range(max(len(o_table), len(d_table))):
        o = o_table[i] if i < len(o_table) else None
        d = d_table[i] if i < len(d_table) else None
        normal_dot = None
        if o and d:
            normal_dot = float(abs(np.dot(o["plane"][:3], d["plane"][:3])))
        region_table.append({
            "oracle": o, "device": d, "normal_dot": normal_dot})

    return {
        "scene": SCENE,
        "device": runtime.device_record(),
        "agreement": round(agreement, 6),
        "agreement_labeled": round(agreement_labeled, 6),
        "n_oracle_regions": len(o_table),
        "n_device_regions": len(d_table),
        "n_oracle_clusters": o_nclusters,
        "n_device_clusters": int(d_nclusters),
        # first call: includes compilation
        "device_seconds_with_compile": round(dev_s, 2),
        "region_table": region_table,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refresh-oracle", action="store_true")
    args = ap.parse_args()
    result = measure(refresh=args.refresh_oracle)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "region_table"}, indent=2))


if __name__ == "__main__":
    main()
