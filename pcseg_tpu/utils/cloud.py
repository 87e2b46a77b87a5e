"""Point-cloud data model: dense [H, W] grids as a JAX pytree.

Array-native replacement for the reference's Cloud/CloudBuffer/CloudView grid
(pointcloud_segmentation/cloud.h:75-256) and the 8-channel
MultichannelCloud (multichannel_cloud.h:61-84, multichannel_cloud.cc:98-107).

Canonical layout: every channel is a row-major ``[H, W, C]`` (or ``[H, W]``)
array — the natural layout for XLA. The reference's cloud is **col-major by
default** (cloud.h:31,38-41) and all of its L4 code addresses cells through
col-major *linear indices* (``idx = col * rows + row``). To keep fixtures and
label outputs bit-comparable we keep that linear-index convention at API
boundaries: :func:`linearize_index` / :func:`index_to_row_col` implement the
exact mapping (cloud.h:37-63), and label grids returned by the segmentation
ops can be flattened either way.

Invalid points are NaN, matching the reference convention
(multichannel_cloud.proto:30-31).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pcseg_tpu.ops import nansafe

from pcseg_tpu.ops import geom

COL_MAJOR = 0  # cloud.h:31 — the reference default
ROW_MAJOR = 1


def linearize_index(row, col, rows, cols, order=COL_MAJOR):
    """cloud.h:37-47."""
    if order == COL_MAJOR:
        return col * rows + row
    return row * cols + col


def index_to_row_col(index, rows, cols, order=COL_MAJOR):
    """cloud.h:51-63."""
    if order == COL_MAJOR:
        return index % rows, index // rows
    return index // cols, index % cols


def flatten_grid(grid, order=COL_MAJOR):
    """[H, W, ...] -> [H*W, ...] in the requested linear-index order."""
    if order == COL_MAJOR:
        grid = jnp.swapaxes(grid, 0, 1)
    return grid.reshape((-1,) + grid.shape[2:])


def unflatten_grid(flat, rows, cols, order=COL_MAJOR):
    """[H*W, ...] -> [H, W, ...] from the requested linear-index order."""
    if order == COL_MAJOR:
        grid = flat.reshape((cols, rows) + flat.shape[1:])
        return jnp.swapaxes(grid, 0, 1)
    return flat.reshape((rows, cols) + flat.shape[1:])


# Channel registry: (python attr, proto field, components) — mirrors
# multichannel_cloud.cc:98-107.
CHANNELS = (
    ("points", "points_xyz", 3),
    ("normals", "normals_xyz", 3),
    ("intensities", "intensities", 1),
    ("colors", "colors_rgb_f", 3),
    ("sensor_origins", "sensor_origins", 3),
    ("return_pulse_widths", "return_pulse_widths", 3),
    ("return_intensities", "return_intensities", 3),
    ("return_ranges", "return_ranges", 3),
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PointCloud:
    """Organized (H > 1) or unorganized (H == 1) sensor cloud.

    All channels optional except ``points``; each is [H, W, C] (or [H, W] for
    intensities). ``pose`` is point_cloud_pose_sensor — the sensor pose in
    the point-cloud frame (multichannel_cloud.proto:34-36).
    """
    points: jnp.ndarray
    normals: Optional[jnp.ndarray] = None
    intensities: Optional[jnp.ndarray] = None
    colors: Optional[jnp.ndarray] = None
    sensor_origins: Optional[jnp.ndarray] = None
    return_pulse_widths: Optional[jnp.ndarray] = None
    return_intensities: Optional[jnp.ndarray] = None
    return_ranges: Optional[jnp.ndarray] = None
    pose: geom.Pose = dataclasses.field(default_factory=geom.Pose)

    @property
    def rows(self) -> int:
        return self.points.shape[0]

    @property
    def cols(self) -> int:
        return self.points.shape[1]

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def organized(self) -> bool:
        return self.rows > 1

    def valid_mask(self) -> jnp.ndarray:
        """[H, W] bool — point is finite (all 3 components)."""
        return nansafe.all_finite(self.points)

    def transform(self, pose: geom.Pose) -> "PointCloud":
        """Rotate+translate points, rotate normals — TransformInPlace
        (multichannel_cloud.cc:53-68). Other channels are frame-invariant."""
        new_points = pose.apply(self.points)
        new_normals = (pose.rotate(self.normals)
                       if self.normals is not None else None)
        return dataclasses.replace(self, points=new_points,
                                   normals=new_normals)

    def resize(self, rows: int, cols: int) -> "PointCloud":
        """Resize preserving the overlapping region (zero-fill elsewhere),
        like MultichannelCloud::Resize via ResizeField
        (multichannel_cloud.cc:112-124, cloud_proto_utils.h:110-137)."""
        def _resize(arr):
            if arr is None:
                return None
            out_shape = (rows, cols) + arr.shape[2:]
            out = jnp.zeros(out_shape, arr.dtype)
            r = min(rows, arr.shape[0])
            c = min(cols, arr.shape[1])
            return out.at[:r, :c].set(arr[:r, :c])

        kwargs = {name: _resize(getattr(self, name)) for name, _, _ in CHANNELS}
        return dataclasses.replace(self, **kwargs)

    # -- numpy/npz I/O ------------------------------------------------------

    def to_npz(self, path: str) -> None:
        arrays = {}
        for name, _, _ in CHANNELS:
            v = getattr(self, name)
            if v is not None:
                arrays[name] = np.asarray(v)
        arrays["pose_quat"] = np.asarray(self.pose.quat)
        arrays["pose_trans"] = np.asarray(self.pose.trans)
        np.savez(path, **arrays)

    @staticmethod
    def from_npz(path: str) -> "PointCloud":
        data = np.load(path)
        kwargs = {name: jnp.asarray(data[name])
                  for name, _, _ in CHANNELS if name in data}
        pose = geom.Pose(jnp.asarray(data["pose_quat"]),
                         jnp.asarray(data["pose_trans"]))
        return PointCloud(pose=pose, **kwargs)


def make_invalid_points(rows: int, cols: int, dtype=jnp.float32):
    """All-NaN [H, W, 3] points buffer (the reference invalid-value
    convention, algorithms.h:335)."""
    return jnp.full((rows, cols, 3), jnp.nan, dtype)
