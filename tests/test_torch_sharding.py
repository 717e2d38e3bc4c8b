"""The port's sharding rules (``repro_torch.launch.sharding``) and meshes
(``launch/mesh.py``) against the JAX package's, on the CPU, with no ranks.

Every ``*_pspecs`` function of the port on a shape-only ``MeshShape``
against the reference's on a ``jax.sharding.AbstractMesh`` of the same
axes, spec for spec and exactly (``P(*port) == reference`` and the same
number of entries), at the production meshes (16, 16) and (2, 16, 16) and
the test mesh (4, 2): every config's parameters and train state (the
port's ``init_train_state`` on the ``meta`` device against the
reference's under ``jax.eval_shape``), full-size and ``reduced()``, with
``tp`` set to the mesh's 'model' size as the launch layer sets it; every
input shape of ``SHAPES`` (decode caches included, so ``cache_pspecs``);
and ``replica_pspecs`` on batch operands. Then ``NamedSharding``'s DTensor
placements and the local shard it cuts, on a stand-in mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (SHAPES, get_config, input_specs,   # noqa: E402
                                 list_archs)
from repro_torch.core.schedule import DevicePlan                     # noqa: E402
from repro_torch.launch import mesh as port_mesh                     # noqa: E402
from repro_torch.launch import sharding as shd                       # noqa: E402
from repro_torch.launch.train import init_train_state                # noqa: E402
from repro_torch.optim import AdamWConfig                            # noqa: E402

ARCHS = list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "test": ((4, 2), ("data", "model"))}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.configs import get_config as ref_get_config
    from repro.configs import input_specs as ref_input_specs
    from repro.core.schedule import DevicePlan as RefDevicePlan
    from repro.launch import sharding as ref_shd
    from repro.launch import train as ref_train
    from repro.optim import AdamWConfig as RefAdamW
    return {"jax": jax, "AbstractMesh": AbstractMesh, "P": PartitionSpec,
            "get_config": ref_get_config, "input_specs": ref_input_specs,
            "DevicePlan": RefDevicePlan, "shd": ref_shd, "train": ref_train,
            "AdamWConfig": RefAdamW}


def _cfg(getter, arch: str, size: str, mesh: str):
    cfg = getter(arch)
    if size == "reduced":
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, tp=dict(zip(MESHES[mesh][1],
                                                MESHES[mesh][0]))["model"])


def _ref_leaves(jx, tree):
    """(path, spec) of a reference spec tree, in leaf order."""
    jax = jx["jax"]
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jx["P"]))
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), s) for path, s in leaves]


def _port_leaves(tree, prefix=()):
    """(path, spec) of a port spec tree, in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, DevicePlan):
        return [x for name in ("orders", "inverses")
                for x in _port_leaves(getattr(tree, name), prefix)]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, shd.PartitionSpec):
        return [x for i, v in enumerate(tree)
                for x in _port_leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _assert_specs_equal(jx, port, ref, paths=True):
    got, want = _port_leaves(port), _ref_leaves(jx, ref)
    assert len(got) == len(want) > 0
    for (gk, g), (wk, w) in zip(got, want):
        assert isinstance(g, shd.PartitionSpec), (gk, g)
        if paths:
            assert gk == wk
        assert jx["P"](*g) == w and len(g) == len(tuple(w)), (gk, g, w)


def _meshes(jx, name):
    shape, axes = MESHES[name]
    return port_mesh.MeshShape(shape, axes), jx["AbstractMesh"](shape, axes)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_are_the_references(jx, arch, size):
    jax = jx["jax"]
    for name in MESHES:
        pmesh, rmesh = _meshes(jx, name)
        rcfg = _cfg(jx["get_config"], arch, size, name)
        cfg = _cfg(get_config, arch, size, name)
        ref_state = jax.eval_shape(lambda: jx["train"].init_train_state(
            jax.random.PRNGKey(0), rcfg, jx["AdamWConfig"]()))
        state = init_train_state(0, cfg, AdamWConfig(), device="meta")
        _assert_specs_equal(jx, shd.param_pspecs(state["params"], pmesh),
                            jx["shd"].param_pspecs(ref_state["params"],
                                                   rmesh))
        _assert_specs_equal(jx, shd.state_pspecs(state, pmesh),
                            jx["shd"].state_pspecs(ref_state, rmesh))


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_are_the_references(jx, arch, size):
    for name in MESHES:
        pmesh, rmesh = _meshes(jx, name)
        rcfg = _cfg(jx["get_config"], arch, size, name)
        cfg = _cfg(get_config, arch, size, name)
        for shape in SHAPES:
            ins = input_specs(cfg, shape)
            ref_ins = jx["input_specs"](rcfg, shape)
            got = shd.input_pspecs(ins, pmesh)
            want = jx["shd"].input_pspecs(ref_ins, rmesh)
            assert sorted(got) == sorted(want)
            _assert_specs_equal(jx, got, want)
            if "cache" in ins:
                _assert_specs_equal(
                    jx, shd.cache_pspecs(ins["cache"], pmesh),
                    jx["shd"].cache_pspecs(ref_ins["cache"], rmesh))


@pytest.mark.parametrize("batch", [8, 3])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_replica_specs_are_the_references(jx, n, batch):
    """clouds, n_valid and a stacked two-layer plan: the leading dim over
    'replica' where it divides, replicated otherwise."""
    jnp = jx["jax"].numpy
    sizes = (512, 128)
    orders = [np.zeros((batch, s), np.int32) for s in sizes]
    port = (np.zeros((batch, 1024, 3), np.float32),
            np.zeros((batch,), np.int32),
            DevicePlan(orders, orders, sizes))
    ref = (jnp.asarray(port[0]), jnp.asarray(port[1]),
           jx["DevicePlan"]([jnp.asarray(o) for o in orders],
                            [jnp.asarray(o) for o in orders], sizes))
    got = shd.replica_pspecs(port, port_mesh.MeshShape((n,), ("replica",)))
    want = jx["shd"].replica_pspecs(
        ref, jx["AbstractMesh"]((n,), ("replica",)))
    _assert_specs_equal(jx, got, want, paths=False)
    assert (got[0] == ("replica", None, None)) == (batch % n == 0)


def test_batch_axes_and_mesh_axes():
    assert port_mesh.MESH_AXES == {"single": ("data", "model"),
                                   "multi": ("pod", "data", "model")}
    assert port_mesh.batch_axes(port_mesh.MeshShape(
        (2, 16, 16), ("pod", "data", "model"))) == ("pod", "data")
    assert port_mesh.batch_axes(port_mesh.MeshShape(
        (16, 16), ("data", "model"))) == ("data",)
    assert port_mesh.MeshShape((4, 2), ("data", "model")).shape == {
        "data": 4, "model": 2}


def test_meshes_want_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_test_mesh((2, 2), device_type="cpu")


class _StandInMesh:
    """What ``NamedSharding`` reads of a ``DeviceMesh``: its axes, their
    sizes and this rank's coordinate."""
    mesh_dim_names = ("pod", "data", "model")
    sizes = (2, 4, 2)

    def __init__(self, coordinate):
        self.coordinate = coordinate

    @property
    def shape(self):
        return self.sizes

    def size(self, i):
        return self.sizes[i]

    def get_coordinate(self):
        return self.coordinate


def test_named_sharding_placements_and_local_shard():
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(16 * 6).reshape(16, 6)
    s = shd.NamedSharding(_StandInMesh([1, 2, 1]),
                          shd.PartitionSpec(("pod", "data"), "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(1))
    # rows: chunk 1 * 4 + 2 of 8; columns: chunk 1 of 2
    assert torch.equal(s.shard(x), x[12:14, 3:6])
    r = shd.NamedSharding(_StandInMesh([0, 3, 1]),
                          shd.PartitionSpec(None, "data"))
    assert r.placements == (Replicate(), Shard(1), Replicate())
    assert torch.equal(r.shard(torch.arange(8).reshape(1, 8)),
                       torch.tensor([[6, 7]]))
    with pytest.raises(ValueError, match="mesh's order"):
        shd.NamedSharding(_StandInMesh([0, 0, 0]),
                          shd.PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError, match="not on the mesh"):
        s.__class__(_StandInMesh(None), shd.PartitionSpec()).shard(x)


def test_shard_batch_cuts_divisible_leading_dims():
    class Replicas(_StandInMesh):
        mesh_dim_names = ("replica",)
        sizes = (2,)
    clouds = np.arange(4 * 3 * 3, dtype=np.float32).reshape(4, 3, 3)
    n_valid = np.arange(4, dtype=np.int32)
    plan = DevicePlan([torch.arange(8).reshape(4, 2)],
                      [torch.arange(8).reshape(4, 2)], (2,))
    c, nv, p = shd.shard_batch((clouds, n_valid, plan), Replicas([1]))
    np.testing.assert_array_equal(c, clouds[2:])
    np.testing.assert_array_equal(nv, n_valid[2:])
    assert torch.equal(p.orders[0], plan.orders[0][2:])
    assert p.layer_sizes == (2,)
    odd = shd.shard_batch((clouds[:3], None), Replicas([1]))
    assert odd[1] is None and odd[0].shape == (3, 3, 3)
