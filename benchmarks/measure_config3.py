#!/usr/bin/env python
"""Config-3 baseline measurement: single-core C++ mean shift.

Builds pcseg_tpu/native/cpp_baseline_meanshift.cc (the same voxelize +
SlidingMeanShift algorithm as the device path, optimized single-threaded
C++ — the measurement stand-in; the reference itself degenerates on
unorganized clouds, see the .cc header), runs it on the ~1M-point blob
cloud (utils/synthetic.synthetic_blob_cloud) and prints the result as JSON.

CPU-only. Run: python benchmarks/measure_config3.py
"""

import json
import os
import struct
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    from pcseg_tpu.utils.synthetic import synthetic_blob_cloud
    src = os.path.join(ROOT, "pcseg_tpu", "native",
                       "cpp_baseline_meanshift.cc")
    big = synthetic_blob_cloud()
    best = None
    regions = None
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "cpp_meanshift")
        data = os.path.join(tmp, "cloud.bin")
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-o",
                        exe, src], check=True, capture_output=True)
        with open(data, "wb") as f:
            f.write(struct.pack("<i", len(big)))
            f.write(big.astype(np.float32).tobytes())
        for _ in range(3):
            out = subprocess.run([exe, data], check=True,
                                 capture_output=True, text=True).stdout
            rec = json.loads(out)
            best = rec["total_ms"] if best is None \
                else min(best, rec["total_ms"])
            regions = rec["regions"]

    print(json.dumps({
        "n_points": len(big),
        "cpp_single_core_ms": round(best, 1),
        "cpp_points_per_sec": round(len(big) / (best / 1e3), 1),
        "cpp_regions": regions,
    }, indent=2))


if __name__ == "__main__":
    main()
