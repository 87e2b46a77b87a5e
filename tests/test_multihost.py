"""Multi-host (2-process) dryrun: the sharded step over a process-spanning
mesh must reproduce the single-process run exactly (BASELINE config 5).

The reference has no distributed story (SURVEY.md §5); this pins the
rebuild's novel mandate: jax.distributed bring-up, a global mesh over two
localhost CPU processes (4 virtual devices each), cross-process halo
exchange / psum / all_gather through the identical shard_map program, and
bit-identical outputs vs the same 8-device mesh in one process.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 virtual CPU devices")
def test_two_process_matches_single_process(tmp_path):
    out_npz = str(tmp_path / "mh0.npz")
    port = "12923"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), port, out_npz],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
    got = np.load(out_npz)

    # identical program on the same scene over a single-process 8-dev mesh
    from pcseg_tpu.parallel import sharded
    from pcseg_tpu.utils.synthetic import synthetic_room_cloud
    H, W = 48, 64
    pts, origin = synthetic_room_cloud(H, W, f=float(H), seed=2)
    mesh = sharded.make_mesh(8)
    step = sharded.build_sharded_segment_step(mesh)
    want = step(jnp.asarray(pts), jnp.asarray(origin))

    assert int(got["num_regions"]) == int(want.planar.num_regions)
    assert int(got["num_clusters"]) == int(want.num_clusters)
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    n = int(want.planar.num_regions)
    np.testing.assert_allclose(got["planes"][:n],
                               np.asarray(want.planar.planes)[:n],
                               rtol=0, atol=1e-6)
