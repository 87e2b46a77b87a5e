"""Geometric plane classification: floor / table / wall / unknown.

Reimplements pointcloud_segmentation/plane_classification.cc:
  * floor / coffee-table: near-horizontal normal (cosine gate), signed
    offset from a known floor point within deviation, area within
    [min, max] (:34-65);
  * wall: near-vertical normal plus hull height extent >= min_height
    (:68-93);
  * priority floor > table > wall > unknown (:111-136);
  * per-reason rejection counters (plane_classification.h:31-45).

Two implementations: a batched jnp version for the jitted pipeline (regions
as padded arrays) and a host version over finalized region records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import jax.numpy as jnp
import numpy as np

from pcseg_tpu.models.config import (
    PlaneClass, PlaneClassificationConfig, ClassifyHorizontalPlaneParams,
    ClassifyWallParams, PLANE_CLASS_NAMES)


@dataclasses.dataclass
class HorizontalPlaneRejections:
    """plane_classification.h:33-39."""
    rejected_for_angle: int = 0
    rejected_for_distance: int = 0
    rejected_for_size: int = 0

    def report(self) -> str:
        """plane_classification.cc:97-102."""
        return (f"regions rejection:{self.rejected_for_angle} for angle, "
                f"{self.rejected_for_distance} for distance, "
                f"{self.rejected_for_size} for size.")


@dataclasses.dataclass
class ClassificationDebugSummary:
    """plane_classification.h:31-45."""
    total_considered: int = 0
    floor_rejections: HorizontalPlaneRejections = dataclasses.field(
        default_factory=HorizontalPlaneRejections)
    coffee_table_rejections: HorizontalPlaneRejections = dataclasses.field(
        default_factory=HorizontalPlaneRejections)

    def full_report(self) -> str:
        """plane_classification.cc:104-109."""
        return (f"Considered {self.total_considered} planes:\n Floor "
                f"{self.floor_rejections.report()}\n Coffee Table "
                f"{self.coffee_table_rejections.report()}")


def _is_horizontal(params: ClassifyHorizontalPlaneParams, plane, area,
                   up, floor_point, rej: HorizontalPlaneRejections) -> bool:
    cos_max = math.cos(math.radians(
        params.max_up_direction_delta_angle_degrees))
    if float(np.dot(plane[:3], up)) < cos_max:
        rej.rejected_for_angle += 1
        return False
    floor_offset = float(np.dot(plane[:3], floor_point) + plane[3])
    if abs(params.floor_offset + floor_offset) \
            > params.max_floor_offset_deviation:
        rej.rejected_for_distance += 1
        return False
    if area < params.min_area or area > params.max_area:
        rej.rejected_for_size += 1
        return False
    return True


def _is_wall(params: ClassifyWallParams, plane, hull_points, up) -> bool:
    cos_max = math.cos(math.radians(
        90.0 - params.max_horizontal_delta_angle_degrees))
    if abs(float(np.dot(plane[:3], up))) > cos_max:
        return False
    if len(hull_points) == 0:
        return False
    heights = np.asarray(hull_points, np.float32) @ np.asarray(up, np.float32)
    return float(heights.max() - heights.min()) >= params.min_height


def classify_regions(records, config: PlaneClassificationConfig,
                     up_direction, known_floor_point,
                     summary: ClassificationDebugSummary = None) -> List:
    """Classify finalized PlanarRegionRecords in place (host pass)."""
    if summary is None:
        summary = ClassificationDebugSummary()
    up = np.asarray(up_direction, np.float32)
    floor_pt = np.asarray(known_floor_point, np.float32)
    for rec in records:
        summary.total_considered += 1
        if _is_horizontal(config.floor_params, rec.plane, rec.area, up,
                          floor_pt, summary.floor_rejections):
            rec.plane_class = PlaneClass.FLOOR
        elif _is_horizontal(config.coffee_table_params, rec.plane, rec.area,
                            up, floor_pt, summary.coffee_table_rejections):
            rec.plane_class = PlaneClass.TABLE
        elif _is_wall(config.wall_params, rec.plane,
                      rec.projected_boundary_points, up):
            rec.plane_class = PlaneClass.WALL
        else:
            rec.plane_class = PlaneClass.UNKNOWN
    return records


def plane_class_name(plane_class: PlaneClass) -> str:
    """planar_region.h:270-282."""
    return PLANE_CLASS_NAMES[PlaneClass(plane_class)]


def classify_planes_batched(planes, areas, hull_heights, up, floor_point,
                            config: PlaneClassificationConfig):
    """Vectorized classification for the jitted pipeline.

    Args:
      planes: [R, 4]; areas: [R]; hull_heights: [R] (max-min height of the
        region hull along up — precomputed); up/floor_point: [3].

    Returns [R] int32 PlaneClass values.
    """
    up = jnp.asarray(up)
    floor_point = jnp.asarray(floor_point)
    n_dot_up = jnp.sum(planes[:, :3] * up, axis=-1)
    floor_offset = jnp.sum(planes[:, :3] * floor_point, axis=-1) \
        + planes[:, 3]

    def horizontal(p: ClassifyHorizontalPlaneParams):
        cos_max = math.cos(math.radians(
            p.max_up_direction_delta_angle_degrees))
        return ((n_dot_up >= cos_max)
                & (jnp.abs(p.floor_offset + floor_offset)
                   <= p.max_floor_offset_deviation)
                & (areas >= p.min_area) & (areas <= p.max_area))

    is_floor = horizontal(config.floor_params)
    is_table = horizontal(config.coffee_table_params)
    cos_wall = math.cos(math.radians(
        90.0 - config.wall_params.max_horizontal_delta_angle_degrees))
    is_wall = ((jnp.abs(n_dot_up) <= cos_wall)
               & (hull_heights >= config.wall_params.min_height))

    out = jnp.where(
        is_floor, int(PlaneClass.FLOOR),
        jnp.where(is_table, int(PlaneClass.TABLE),
                  jnp.where(is_wall, int(PlaneClass.WALL),
                            int(PlaneClass.UNKNOWN))))
    return out.astype(jnp.int32)
