"""pcseg_tpu — accelerator-native point-cloud geometric segmentation engine.

A from-scratch JAX/XLA reimplementation of the capabilities of
``theteamatx/x-edr-pointcloud-segmentation`` (organized-cloud normal
estimation, incremental-PCA plane fitting, region-growing planar
segmentation, euclidean/mean-shift clustering, geometric plane
classification, detected-object extraction), redesigned as dense array
programs over ``[H, W]`` grids with multi-chip spatial sharding.

Public API highlights:
  * pcseg_tpu.models.pipeline.Segmenter — end-to-end frame segmentation
  * pcseg_tpu.ops.normals.compute_normals_organized
  * pcseg_tpu.ops.plane_fit — mergeable plane-moment accumulators
  * pcseg_tpu.models.{planar,cluster,mean_shift,classify,extract}
  * pcseg_tpu.parallel.sharded — multi-device spatial sharding
  * pcseg_tpu.oracle — sequential NumPy oracle of the reference semantics
"""

from pcseg_tpu.models.config import (  # noqa: F401
    UNLABELED, MASKED_OUT, MASKED_EGO,
    ClusterRegionConfig, ComputeNormalsParams, MeanShiftParams,
    PlanarRegionConfig, PlaneClass, PlaneClassificationConfig,
)
from pcseg_tpu.models.pipeline import Segmenter, SegmenterConfig  # noqa: F401
from pcseg_tpu.utils.cloud import PointCloud  # noqa: F401

__version__ = "0.1.0"
