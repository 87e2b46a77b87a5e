#!/usr/bin/env python3
"""On-card smoke test of the segmentation engine: one process, one GPU.

Drives the library's main paths once, through the entry points a user
calls, at full width (the default SegmenterConfig: 32 planar slots, 128
cluster slots), and checks what comes out:

  1. environment  devices, card and power limit, JAX version, compile
                  cache, native host ops; no GPU -> exit 1; on the GPU,
                  no card line from nvidia-smi or no host ops -> fail
  2. stream       Segmenter.device_forward_stream, VGA u16, batch 8, run
                  twice: the label grids must be bit-identical
  3. pipeline     segment_frame_stream (u16) and segment_frame (f32) on one
                  VGA frame, pinned to the room's three analytic planes
  4. parity       560x560 room and 280x280 cluttered room against the
                  cached sequential oracle, and the 10x10 golden
                  clustering grid
  5. unorganized  models.unorganized.cluster_unorganized on the ~1M-point
                  blob cloud, equal to the native host path

``--four-cards`` runs only the sharded step over a 4-card column mesh on
the 560x560 room and compares it with single-card device_forward.
``--parity-out DIR`` also writes PARITY_VGA.json and CLUTTER_PARITY.json
there.

Every time printed names the card and its power limit. A failed check
raises, so the exit code is nonzero and no result line is printed; the
last line, printed only when every phase passed, is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Run from the repo root:  python chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

# Full width: the benchmark shape of the stream path.
H, W, BATCH = 480, 640, 8
PARITY_MIN_AGREEMENT = 0.99
ROOM_PLANES = np.array([[-1.0, 0.0, 0.0, 4.0],     # wall x = 4
                        [0.0, 0.0, 1.0, 1.0],      # floor z = -1
                        [0.0, 0.0, -1.0, -0.6]],   # table top z = -0.6
                       np.float32)

CARD = "card unknown"


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(msg):
    print(msg, flush=True)


def say_time(what, seconds):
    say(f"{what}: {seconds * 1e3:.1f} ms  [{CARD}]")


def phase_environment():
    global CARD
    import jax
    from pcseg_tpu import native
    from pcseg_tpu.utils import runtime
    say(f"jax {jax.__version__}; backend {jax.default_backend()}; "
        f"devices {jax.devices()}")
    if jax.default_backend() != "gpu":
        sys.exit("chip_smoke: JAX found no GPU; this script measures the "
                 "card only and has no CPU fallback")
    CARD = runtime.card_line()
    say(f"card: {CARD}")
    say(f"compile cache: {runtime.enable_compile_cache()}")
    loaded = native.load_hostops() is not None
    say(f"native host ops loaded: {loaded}")
    check(loaded, "native host ops did not load")


def check_room_planes(res, what):
    m = res.metrics
    check(m.num_planar_regions == len(ROOM_PLANES) and m.num_clusters == 0,
          f"{what}: {m}")
    for want, rec in zip(ROOM_PLANES, res.planar_regions):
        got = np.asarray(rec.plane)
        check(abs(float(want[:3] @ got[:3])) > 0.9999
              and abs(float(got[3] - want[3])) < 0.01,
              f"{what}: plane {got} vs {want}")
    check((res.labels >= 0).mean() > 0.8, f"{what}: too few labeled points")


def phase_stream(seg, frames, stream_args):
    import jax
    from pcseg_tpu.utils import runtime
    h, w = frames[0][0].shape[:2]

    def run():
        return jax.device_get(seg.device_forward_stream(*stream_args))

    t0 = time.perf_counter()
    first = run()
    say_time(f"stream compile + first batch of {len(frames)}",
             time.perf_counter() - t0)
    second, times = runtime.timed(run, 5)
    labels, n_planar, n_clusters, planes = first
    check(labels.shape == (len(frames), h, w) and labels.dtype == np.uint8,
          f"stream labels {labels.shape} {labels.dtype}")
    for a, b in zip(first, second):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              "stream: two runs differ")
    say("stream: two runs bit-identical")
    for i in range(len(frames)):
        n = int(n_planar[i])
        check(n >= len(ROOM_PLANES), f"stream frame {i}: {n} regions")
        check(np.isfinite(planes[i, :n]).all(), f"stream frame {i}: planes")
        check((labels[i] != 255).mean() > 0.8, f"stream frame {i}: labels")
    say(f"stream: planar regions per frame {n_planar.tolist()}, "
        f"clusters {n_clusters.tolist()}")
    med = statistics.median(times)
    say_time(f"stream steady state per batch of {len(frames)} "
             f"(median of {len(times)})", med)
    say(f"stream: {len(frames) * h * w / med:.0f} points/s  [{CARD}]")


def phase_pipeline(seg, frame):
    from pcseg_tpu.ops import unproject
    from pcseg_tpu.utils import runtime
    pts, origin = frame
    h, w = pts.shape[:2]
    rays = unproject.camera_ray_table(h, w, f=float(h))
    depth = unproject.encode_range(pts)
    for name, fn in (
            ("segment_frame_stream (u16)",
             lambda: seg.segment_frame_stream(depth, rays, origin)),
            ("segment_frame (f32)", lambda: seg.segment_frame(pts, origin))):
        t0 = time.perf_counter()
        res = fn()
        say_time(f"{name} compile + first frame", time.perf_counter() - t0)
        res, times = runtime.timed(fn, 3)
        check_room_planes(res, name)
        say(f"{name}: {res.metrics.num_planar_regions} planar regions, "
            f"{res.metrics.num_clusters} clusters, "
            f"{len(res.objects)} detected objects")
        say_time(f"{name} per frame (median of {len(times)})",
                 statistics.median(times))


def phase_parity(seg, out_dir):
    import jax
    import jax.numpy as jnp
    from benchmarks import clutter_parity, vga_parity
    from pcseg_tpu.models import cluster
    from pcseg_tpu.models.config import UNLABELED, ClusterRegionConfig
    from tests import fixtures

    vga = vga_parity.measure(require_cache=True, seg=seg)
    say(f"parity VGA 560x560: agreement {vga['agreement']}, regions "
        f"{vga['n_device_regions']}/{vga['n_oracle_regions']}, clusters "
        f"{vga['n_device_clusters']}/{vga['n_oracle_clusters']}")
    for i, row in enumerate(vga["region_table"]):
        o, d = row["oracle"], row["device"]
        say(f"  region {i}: oracle {o and o['count']} points, device "
            f"{d and d['count']} points, normal_dot {row['normal_dot']}")
    say_time("parity VGA device seconds incl. compile",
             vga["device_seconds_with_compile"])
    check(vga["agreement"] >= PARITY_MIN_AGREEMENT, "VGA parity agreement")
    check(vga["n_device_regions"] == vga["n_oracle_regions"],
          "VGA parity region count")
    check(all(r["normal_dot"] is not None and r["normal_dot"] > 0.999
              for r in vga["region_table"]), "VGA parity normals")

    clutter = clutter_parity.measure(require_cache=True, seg=seg)
    say(f"parity clutter 280x280: agreement {clutter['agreement']}, planar "
        f"{clutter['n_device_planar']}/{clutter['n_oracle_planar']}, "
        f"clusters {clutter['n_device_clusters']}/"
        f"{clutter['n_oracle_clusters']}")
    say_time("parity clutter device seconds incl. compile",
             clutter["device_seconds_with_compile"])
    check(clutter["agreement"] >= PARITY_MIN_AGREEMENT,
          "clutter parity agreement")
    check(clutter["n_device_planar"] == clutter["n_oracle_planar"]
          and clutter["n_device_clusters"] == clutter["n_oracle_clusters"]
          and clutter["n_oracle_clusters"] > 0, "clutter parity counts")

    # tests/test_cluster.py TestGoldenFixture: default config, ids from 1
    points = fixtures.clustering_fixture_cloud()
    seeds = np.asarray(fixtures.clustering_fixture_seeds(), np.int32)
    labels0 = np.full(points.shape[:2], UNLABELED, np.int32)
    res = jax.device_get(jax.jit(
        lambda p, l, s: cluster.segment_clusters(
            p, l, s, ClusterRegionConfig(), 1))(
            jnp.asarray(points), jnp.asarray(labels0), jnp.asarray(seeds)))
    check(np.array_equal(res.labels, fixtures.CLUSTERING_EXPECTED_LABELS)
          and int(res.num_regions) == 6
          and np.array_equal(res.region_sizes[:6],
                             fixtures.CLUSTERING_EXPECTED_SIZES),
          "golden 10x10 clustering grid")
    say("parity golden 10x10 clustering grid: exact")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, rec in (("PARITY_VGA.json", vga),
                          ("CLUTTER_PARITY.json", clutter)):
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(rec, f, indent=2)
                f.write("\n")
        say(f"parity records written to {out_dir}")


def phase_unorganized(points_per_blob=250_000):
    import jax
    from pcseg_tpu.models import unorganized
    from pcseg_tpu.utils import runtime
    from pcseg_tpu.utils.synthetic import synthetic_blob_cloud
    pts = synthetic_blob_cloud(points_per_blob)
    pts_dev = jax.device_put(pts)
    fn = jax.jit(unorganized.cluster_unorganized)

    def run():
        return jax.device_get(fn(pts_dev))

    t0 = time.perf_counter()
    res = run()
    say_time(f"unorganized {len(pts)} points compile + first call",
             time.perf_counter() - t0)
    res, times = runtime.timed(run, 3)
    say_time("unorganized device path per call (median of 3)",
             statistics.median(times))
    n_dev = int(res.num_regions)
    check(res.point_labels.shape == (len(pts),) and n_dev > 0,
          f"unorganized: {n_dev} regions")
    host = unorganized.cluster_unorganized_host(pts)
    agree = float((host.point_labels == res.point_labels).mean())
    say(f"unorganized: device {n_dev} regions, host {int(host.num_regions)} "
        f"regions, point-label agreement {agree}")
    check(n_dev == int(host.num_regions) and agree == 1.0,
          "unorganized device vs host")


def phase_four_cards(size=560):
    import jax
    import jax.numpy as jnp
    from pcseg_tpu.models import pipeline
    from pcseg_tpu.parallel import sharded
    from pcseg_tpu.utils import runtime
    from pcseg_tpu.utils.synthetic import synthetic_room_cloud
    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, have "
          f"{len(jax.devices())}")
    mesh = sharded.make_mesh(4)
    ids = sorted(d.id for d in mesh.devices.flat)
    check(len(set(ids)) == 4, f"mesh devices {ids}")
    say(f"four cards: mesh over devices {ids}")
    # 560 columns = 140 per card (square: the single-card seed ranking
    # matches the reference's transposed access only on square grids)
    pts, origin = synthetic_room_cloud(size, size, f=float(size), seed=1)
    p, o = jnp.asarray(pts), jnp.asarray(origin)
    step = sharded.build_sharded_segment_step(mesh)

    def run_sharded():
        return jax.device_get(step(p, o))

    t0 = time.perf_counter()
    out = run_sharded()
    say_time("sharded step compile + first frame", time.perf_counter() - t0)
    out, times = runtime.timed(run_sharded, 3)
    say_time(f"sharded step per {size}x{size} frame on 4 cards "
             "(median of 3)",
             statistics.median(times))

    seg = pipeline.Segmenter(pipeline.SegmenterConfig())

    def run_single():
        return jax.device_get(seg.device_forward(p, o))

    t0 = time.perf_counter()
    _, _, dev, _ = run_single()
    say_time("single-card device_forward compile + first frame",
             time.perf_counter() - t0)
    (_, _, dev, _), times = runtime.timed(run_single, 3)
    say_time("single-card device_forward per frame (median of 3)",
             statistics.median(times))

    n_sh, n_single = int(out.planar.num_regions), int(dev.num_regions)
    agree = float((np.asarray(out.planar.labels)
                   == np.asarray(dev.labels)).mean())
    dots = [abs(float(np.asarray(out.planar.planes)[i, :3]
                      @ np.asarray(dev.planes)[i, :3]))
            for i in range(n_single)]
    say(f"four cards vs single: regions {n_sh}/{n_single}, label agreement "
        f"{agree}, min normal dot {min(dots) if dots else None}")
    check(n_sh == n_single, "sharded region count")
    check(agree >= 0.99, "sharded label agreement")
    check(all(d > 0.999 for d in dots), "sharded plane normals")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 4-card phase")
    ap.add_argument("--parity-out", default=None,
                    help="directory to write the parity records to")
    args = ap.parse_args()

    try:
        import pcseg_tpu  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: pcseg_tpu is not importable ({e}); run "
                 "from the repo root")

    t_start = time.perf_counter()
    phase_environment()
    if args.four_cards:
        phase_four_cards()
    else:
        from pcseg_tpu.models import pipeline
        from pcseg_tpu.utils import runtime
        seg = pipeline.Segmenter(pipeline.SegmenterConfig())
        frames, stream_args = runtime.room_stream_batch(BATCH, H, W)
        phase_stream(seg, frames, stream_args)
        phase_pipeline(seg, frames[0])
        phase_parity(seg, args.parity_out)
        phase_unorganized()

    import jax
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        say(f"peak device memory: {stats['peak_bytes_in_use'] / 2**30:.2f} "
            f"GiB  [{CARD}]")
    say(f"total wall time: {time.perf_counter() - t_start:.1f} s  [{CARD}]")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
