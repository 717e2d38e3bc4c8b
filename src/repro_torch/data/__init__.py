"""Data pipelines: synthetic ModelNet40-like point clouds, the timed
request streams of the serving tier and the LM token stream (NumPy;
nothing is fetched)."""
from .pointcloud import (N_CLASSES, PointCloudDataset, request_stream,
                         synthetic_cloud)
from .tokens import TokenStream

__all__ = ["N_CLASSES", "PointCloudDataset", "TokenStream",
           "request_stream", "synthetic_cloud"]
