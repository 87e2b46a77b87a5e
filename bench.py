#!/usr/bin/env python
"""Headline benchmark: points/s of the VGA u16 stream on one GPU.

Measures the serving path in this one process: a batch of B u16 range
images (2 bytes/px, see ops/unproject.py) is unprojected on the device and
pushed through the full segmentation forward (normals -> seed ranking ->
planar region growing -> euclidean clustering); the uint8 label grids
(1 byte/px) come back to the host. Each timed call ends when the labels
are on the host. The value is the median over the timed calls.

Baseline: the same algorithms in optimized single-core C++
(pcseg_tpu/native/cpp_baseline.cc; the reference repo publishes no numbers
and cannot be built offline, see BASELINE.md), built and run here on the
same cloud. The C++ reads its cloud from RAM.

Prints ONE JSON line from this run:
  {"metric", "value", "unit", "vs_baseline", "device"}
Exits nonzero, printing no line, when JAX finds no GPU.

Run: python bench.py [--batch 8]
"""

import argparse
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile

import numpy as np

H, W = 480, 640
ITERS = 10   # timed calls after the compiling one
ROOT = os.path.dirname(os.path.abspath(__file__))


def cpp_points_per_sec(points) -> float:
    """Single-core C++ points/s on ``points`` (best of 3); NaN without a
    C++ toolchain."""
    src = os.path.join(ROOT, "pcseg_tpu", "native", "cpp_baseline.cc")
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "cpp_baseline")
        data = os.path.join(tmp, "cloud.bin")
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                            "-o", exe, src], check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"bench: no C++ baseline ({e})", file=sys.stderr)
            return float("nan")
        cm = np.swapaxes(points, 0, 1).reshape(-1, 3).astype(np.float32)
        with open(data, "wb") as f:
            f.write(struct.pack("<ii", H, W))
            f.write(cm.tobytes())
        best = min(
            json.loads(subprocess.run([exe, data], check=True,
                                      capture_output=True,
                                      text=True).stdout)["total_ms"]
            for _ in range(3))
    return H * W / (best / 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("bench: JAX found no GPU; the benchmark measures the card "
                 "only")
    from pcseg_tpu.models import pipeline
    from pcseg_tpu.utils import runtime
    device = runtime.device_record()
    runtime.enable_compile_cache()

    frames, stream_args = runtime.room_stream_batch(args.batch, H, W)
    seg = pipeline.Segmenter(pipeline.SegmenterConfig())

    def step():
        labels, *_ = seg.device_forward_stream(*stream_args)
        return np.asarray(labels)   # D2H of all B label grids

    step()
    _, times = runtime.timed(step, ITERS)
    pps = args.batch * H * W / statistics.median(times)
    baseline = cpp_points_per_sec(frames[0][0])
    print(json.dumps({
        "metric": f"points_per_sec_vga_u16_stream_batch{args.batch}",
        "value": round(pps, 1),
        "unit": "points/s",
        "vs_baseline": round(pps / baseline, 3) if baseline == baseline
        else None,
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
