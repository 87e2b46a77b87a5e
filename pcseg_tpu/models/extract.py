"""Detected-object extraction: regions -> dataclasses -> protos.

Reimplements pointcloud_segmentation/detected_objects.{h,cc}:
Plane3dProto round trip (detected_objects.h:37-59), cluster extraction
(detected_objects.h:62-74), planar extraction with re-indexed discontinuous
boundary indices (detected_objects.cc:21-48).

Ordering note: the reference gathers inlier points in BFS discovery order;
the device path normalizes inlier order to ascending col-major linear index
(the point *set*, centroid, and plane are identical).

Protobuf is imported only by the proto conversions, so the segmentation
path runs where the protobuf package is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from pcseg_tpu.models.cluster import gather_region_indices
from pcseg_tpu.models.classify import plane_class_name
from pcseg_tpu.models.config import SEMANTIC_UNKNOWN

if TYPE_CHECKING:
    from pcseg_tpu.protos import pcseg_pb2


@dataclasses.dataclass
class DetectedObject:
    """In-memory detected object (planar or cluster geometry)."""
    object_class: str
    points: np.ndarray                    # [N, 3] inlier points
    centroid: Optional[np.ndarray] = None  # planar only
    plane: Optional[np.ndarray] = None     # planar only, coeffs (n, d)
    discontinuous_boundary_positions: Optional[np.ndarray] = None


def plane_to_proto(plane: np.ndarray, proto: pcseg_pb2.Plane3dProto) -> None:
    """detected_objects.h:37-49: store the closest point to the origin
    (-n * offset) plus the unit normal."""
    point = -plane[:3] * plane[3]
    proto.x, proto.y, proto.z = float(point[0]), float(point[1]), \
        float(point[2])
    proto.nx, proto.ny, proto.nz = float(plane[0]), float(plane[1]), \
        float(plane[2])


def plane_from_proto(proto: pcseg_pb2.Plane3dProto) -> np.ndarray:
    """detected_objects.h:51-59."""
    normal = np.array([proto.nx, proto.ny, proto.nz], np.float32)
    nrm = np.linalg.norm(normal)
    assert nrm > 1e-12, "invalid plane proto (zero normal)"
    normal = normal / nrm
    point = np.array([proto.x, proto.y, proto.z], np.float32)
    return np.concatenate([normal, [-normal @ point]]).astype(np.float32)


def _gather_points(points: np.ndarray, indices: np.ndarray) -> np.ndarray:
    rows = points.shape[0]
    return points[indices % rows, indices // rows]


class RegionIndexer:
    """Shared index for extracting MANY regions from one label grid.

    One stable argsort of the col-major flattened labels replaces a full
    [H, W] ``nonzero`` scan per object (the extraction pass's dominant
    cost, ~2.5 ms x objects at VGA). ``indices(id)`` returns the region's
    members as ascending col-major linear indices — identical to
    models.cluster.gather_region_indices (tested)."""

    def __init__(self, labels: np.ndarray):
        flat_cm = np.ascontiguousarray(labels.T).ravel()
        self._order = np.argsort(flat_cm, kind="stable").astype(np.int64)
        self._sorted = flat_cm[self._order]

    def indices(self, region_id: int) -> np.ndarray:
        lo = np.searchsorted(self._sorted, region_id, side="left")
        hi = np.searchsorted(self._sorted, region_id, side="right")
        return np.sort(self._order[lo:hi])


def cluster_detected_object(points: np.ndarray, labels: np.ndarray,
                            region_id: int,
                            object_class: str = SEMANTIC_UNKNOWN,
                            indexer: Optional[RegionIndexer] = None
                            ) -> DetectedObject:
    """CreateClusterDetectedObjectProto (detected_objects.h:62-74)."""
    idx = indexer.indices(region_id) if indexer is not None \
        else gather_region_indices(labels, region_id)
    return DetectedObject(object_class=object_class,
                          points=_gather_points(points, idx))


def planar_detected_object_from_labels(points: np.ndarray,
                                       labels: np.ndarray,
                                       record,
                                       indexer: Optional[RegionIndexer]
                                       = None) -> DetectedObject:
    """CreatePlanarDetectedObjectProto (detected_objects.cc:21-48): gather
    inliers, centroid + plane from the estimator, and re-map discontinuous
    boundary indices to positions within the gathered point list."""
    idx = indexer.indices(record.label_id) if indexer is not None \
        else gather_region_indices(labels, record.label_id)
    pts = _gather_points(points, idx)
    disc = record.discontinuous_boundary_indices
    positions = np.nonzero(np.isin(idx, list(disc)))[0].astype(np.int32) \
        if disc else np.zeros((0,), np.int32)
    return DetectedObject(
        object_class=plane_class_name(record.plane_class),
        points=pts,
        centroid=record.centroid.copy(),
        plane=record.plane.copy(),
        discontinuous_boundary_positions=positions,
    )


def to_proto(obj: DetectedObject,
             proto: Optional[pcseg_pb2.DetectedObjectProto] = None
             ) -> pcseg_pb2.DetectedObjectProto:
    if proto is None:
        from pcseg_tpu.protos import pcseg_pb2
        proto = pcseg_pb2.DetectedObjectProto()
    proto.object_class = obj.object_class
    flat = np.asarray(obj.points, np.float32).reshape(-1)
    if obj.plane is not None:
        geom = proto.planar_geometry
        geom.points_xyz.extend(flat.tolist())
        geom.centroid.x = float(obj.centroid[0])
        geom.centroid.y = float(obj.centroid[1])
        geom.centroid.z = float(obj.centroid[2])
        plane_to_proto(obj.plane, geom.plane)
        if obj.discontinuous_boundary_positions is not None:
            geom.discontinuous_boundary_indices.extend(
                int(i) for i in obj.discontinuous_boundary_positions)
    else:
        proto.cluster_geometry.points_xyz.extend(flat.tolist())
    return proto


def detected_objects_proto(objects: List[DetectedObject]
                           ) -> pcseg_pb2.DetectedObjectsProto:
    from pcseg_tpu.protos import pcseg_pb2
    out = pcseg_pb2.DetectedObjectsProto()
    for obj in objects:
        to_proto(obj, out.detected_objects.add())
    return out
