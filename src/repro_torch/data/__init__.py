"""Data pipelines: synthetic ModelNet40-like point clouds and the timed
request streams of the serving tier (NumPy; nothing is fetched)."""
from .pointcloud import (N_CLASSES, PointCloudDataset, request_stream,
                         synthetic_cloud)

__all__ = ["N_CLASSES", "PointCloudDataset", "request_stream",
           "synthetic_cloud"]
