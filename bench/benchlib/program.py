"""The system under test: the port, compiled from a configuration file and
the benchmark's weights. The only module here that imports the program."""
from __future__ import annotations

import pathlib
import sys

SRC = pathlib.Path(__file__).resolve().parent.parent.parent / "src"


def _port():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch
    return repro_torch


def build_model(config: dict, weights: dict, device):
    """``compile_model`` of the configuration's backend and schedule over
    ``weights`` (the layout of :func:`benchlib.inputs.he_weights`)."""
    rt = _port()
    from repro_torch.core.workload import PointNetConfig, SALayerSpec
    cfg = PointNetConfig(
        name=config["name"], n_points=config["n_points"],
        layers=tuple(SALayerSpec(n_centers=s["n_centers"],
                                 n_neighbors=s["n_neighbors"],
                                 in_features=s["mlp"][0],
                                 mlp=tuple(s["mlp"]))
                     for s in config["layers"]))
    params = {"sa": [[{"w": w, "b": b} for w, b in mlp]
                     for mlp in weights["sa"]],
              "head": [{"w": w, "b": b} for w, b in weights["head"]]}
    return rt.compile_model(params, cfg, backend=config["backend"],
                            schedule=config["schedule"], device=device)


def servable(model, traffic: dict):
    """The serving tier over ``model``, as the traffic file sets it up."""
    _port()
    from repro_torch.launch.serve import (PointCloudServable, ServingEngine,
                                          ShapeBuckets)
    b = traffic["buckets"]
    serv = PointCloudServable(
        model, buckets=ShapeBuckets(points=tuple(b["points"]),
                                    batch=tuple(b["batch"])),
        plan_cache=traffic["plan_cache"])
    return serv, ServingEngine(serv, scheduler=traffic["scheduler"])
