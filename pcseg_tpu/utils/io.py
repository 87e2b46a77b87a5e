"""MultichannelCloudProto <-> PointCloud conversion.

The reference memory-maps typed CloudViews directly onto the proto's
repeated-float fields (multichannel_cloud.cc:70-107, cloud_proto_utils.h);
its storage order is therefore the cloud's col-major linearization
(``value[(col*rows + row)*C + c]``). This module serializes/deserializes the
device PointCloud to that layout so payloads interoperate with the reference's
channel fields (field numbers match, see protos/pcseg.proto).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pcseg_tpu.ops import geom
from pcseg_tpu.protos import pcseg_pb2
from pcseg_tpu.utils import cloud as cloud_lib


def _flatten_cm(arr: np.ndarray) -> np.ndarray:
    """[H, W(, C)] -> flat col-major channel data."""
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.swapaxes(np.asarray(arr), 0, 1).reshape(-1)


def _unflatten_cm(data, rows, cols, comps):
    arr = np.asarray(data, np.float32).reshape(cols, rows, comps)
    arr = np.swapaxes(arr, 0, 1)
    return arr[..., 0] if comps == 1 else arr


def cloud_to_proto(cloud: cloud_lib.PointCloud,
                   proto=None) -> pcseg_pb2.MultichannelCloudProto:
    if proto is None:
        proto = pcseg_pb2.MultichannelCloudProto()
    proto.height = cloud.rows
    proto.width = cloud.cols
    for name, field, _ in cloud_lib.CHANNELS:
        value = getattr(cloud, name)
        getattr(proto, field)[:] = []
        if value is not None:
            getattr(proto, field).extend(
                _flatten_cm(np.asarray(value)).tolist())
    pose = cloud.pose
    q = np.asarray(pose.quat, np.float64)
    t = np.asarray(pose.trans, np.float64)
    proto.point_cloud_pose_sensor.translation.x = t[0]
    proto.point_cloud_pose_sensor.translation.y = t[1]
    proto.point_cloud_pose_sensor.translation.z = t[2]
    proto.point_cloud_pose_sensor.qw = q[0]
    proto.point_cloud_pose_sensor.qx = q[1]
    proto.point_cloud_pose_sensor.qy = q[2]
    proto.point_cloud_pose_sensor.qz = q[3]
    return proto


def plane_estimator_to_proto(m, proto=None) -> pcseg_pb2.PlaneEstimatorProto:
    """PlaneMoments -> PlaneEstimatorProto (plane_estimator.cc:231-245);
    the serializable accumulator is the reference's checkpoint/resume
    mechanism (SURVEY.md §5)."""
    if proto is None:
        proto = pcseg_pb2.PlaneEstimatorProto()
    proto.covariance_accumulator[:] = np.asarray(m.s2, np.float32).tolist()
    proto.cumulative_centroid[:] = np.asarray(m.s1, np.float32).tolist()
    proto.cumulative_weights = float(m.w)
    proto.normal[:] = np.asarray(m.normal_hint, np.float32).tolist()
    return proto


def plane_estimator_from_proto(proto):
    """PlaneEstimatorProto -> PlaneMoments (plane_estimator.cc:28-44)."""
    from pcseg_tpu.ops import plane_fit
    return plane_fit.PlaneMoments(
        s2=jnp.asarray(list(proto.covariance_accumulator), jnp.float32),
        s1=jnp.asarray(list(proto.cumulative_centroid), jnp.float32),
        w=jnp.asarray(proto.cumulative_weights, jnp.float32),
        normal_hint=jnp.asarray(list(proto.normal), jnp.float32))


def proto_to_cloud(proto: pcseg_pb2.MultichannelCloudProto
                   ) -> cloud_lib.PointCloud:
    rows, cols = proto.height, proto.width
    kwargs = {}
    for name, field, comps in cloud_lib.CHANNELS:
        data = getattr(proto, field)
        if len(data):
            expected = rows * cols * comps
            assert len(data) == expected, \
                f"channel {field}: {len(data)} != {expected}"
            kwargs[name] = jnp.asarray(
                _unflatten_cm(data, rows, cols, comps))
    p = proto.point_cloud_pose_sensor
    pose = geom.Pose(
        jnp.asarray([p.qw or 1.0, p.qx, p.qy, p.qz], jnp.float32),
        jnp.asarray([p.translation.x, p.translation.y, p.translation.z],
                    jnp.float32))
    return cloud_lib.PointCloud(pose=pose, **kwargs)


# ---------------------------------------------------------------------------
# Config schemas (region_segmentation_config.proto:22-72,
# plane_classification_config.proto:23-58). Wire-compatible field numbers;
# unset fields take the reference's in-code defaults exactly like
# ApplyDefaultConfigValues (planar_region.h:93-121, cluster_region.h:53-63).
# ---------------------------------------------------------------------------

import dataclasses as _dc

from pcseg_tpu.models import config as _config

_PLANAR_FIELDS = (
    "max_distance_for_seed_point",
    "max_normal_difference_angle_for_seed_point",
    "max_plane_distance", "min_region_area", "min_region_inliers",
    "plane_model_reestimation_period", "discontinuity_min_range",
    "discontinuity_max_range", "discontinuity_normal_angle_diff",
    "discontinuity_z_diff", "discontinuity_z_ratio")

_CLUSTER_FIELDS = ("min_region_inliers", "squared_distance_threshold",
                   "half_search_window")


def planar_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.PlanarRegionConfigProto()
    for f in _PLANAR_FIELDS:
        setattr(proto, f, getattr(cfg, f))
    return proto


def planar_config_from_proto(proto) -> "_config.PlanarRegionConfig":
    """Unset fields keep the defaults (ApplyDefaultConfigValues,
    planar_region.h:93-121 — the dataclass defaults mirror them)."""
    kwargs = {f: getattr(proto, f) for f in _PLANAR_FIELDS
              if proto.HasField(f)}
    return _config.PlanarRegionConfig(**kwargs)


def cluster_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.ClusterRegionConfigProto()
    for f in _CLUSTER_FIELDS:
        setattr(proto, f, getattr(cfg, f))
    proto.cluster_method = cfg.cluster_method.value
    return proto


def cluster_config_from_proto(proto) -> "_config.ClusterRegionConfig":
    """Defaults of cluster_region.h:53-63 on unset fields."""
    kwargs = {f: getattr(proto, f) for f in _CLUSTER_FIELDS
              if proto.HasField(f)}
    if proto.HasField("cluster_method"):
        kwargs["cluster_method"] = _config.ClusterMethod(proto.cluster_method)
    return _config.ClusterRegionConfig(**kwargs)


_HORIZ_FIELDS = ("max_up_direction_delta_angle_degrees", "floor_offset",
                 "max_floor_offset_deviation", "min_area", "max_area")
_WALL_FIELDS = ("max_horizontal_delta_angle_degrees", "min_height")


def classification_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.PlaneClassificationConfigProto()
    for f in _HORIZ_FIELDS:
        setattr(proto.floor_params, f, getattr(cfg.floor_params, f))
        setattr(proto.coffee_table_params, f,
                getattr(cfg.coffee_table_params, f))
    for f in _WALL_FIELDS:
        setattr(proto.wall_params, f, getattr(cfg.wall_params, f))
    return proto


def classification_config_from_proto(proto):
    """plane_classification_config.proto has no in-code defaults (proto2
    optionals; zeros reject everything) — unset fields stay zero like the
    reference's direct field reads (plane_classification.cc:34-93)."""
    def sub(msg, fields, cls):
        return cls(**{f: getattr(msg, f) for f in fields
                      if msg.HasField(f)})
    return _config.PlaneClassificationConfig(
        floor_params=sub(proto.floor_params, _HORIZ_FIELDS,
                         _config.ClassifyHorizontalPlaneParams),
        coffee_table_params=sub(proto.coffee_table_params, _HORIZ_FIELDS,
                                _config.ClassifyHorizontalPlaneParams),
        wall_params=sub(proto.wall_params, _WALL_FIELDS,
                        _config.ClassifyWallParams))
