"""The port's checkpoints (``repro_torch.checkpoint``): atomic, keep-K, in
the JAX package's on-disk format, so that each package restores the
other's bit for bit, bfloat16 leaves included (the port views them
through torch, without any extension dtype package)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jck                                 # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig                 # noqa: E402
from repro.optim import adamw_init as jadamw_init                   # noqa: E402
from repro_torch.checkpoint import (cleanup_old, latest_step,       # noqa: E402
                                    restore_checkpoint,
                                    save_checkpoint)
from repro_torch.optim import AdamWConfig, adamw_init, tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed=0):
    """One tree of NumPy leaves: float32, int32, bfloat16 (random bits, so
    every mantissa bit counts) and a 0-d int32."""
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)
    return {"params": {"w": rng.normal(size=(8, 4)).astype(np.float32),
                       "blocks": [np.arange(6, dtype=np.int32).reshape(2, 3),
                                  bf]},
            "opt": {"step": np.int32(7)}}


def _torch_tree(arrs):
    bf = arrs["params"]["blocks"][1]
    return {"params": {"w": torch.from_numpy(arrs["params"]["w"].copy()),
                       "blocks": [torch.from_numpy(
                           arrs["params"]["blocks"][0].copy()),
                           torch.from_numpy(bf.view(np.int16).copy()).view(
                               torch.bfloat16)]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _jax_tree(arrs):
    return jax.tree.map(jnp.asarray, arrs)


def _bits(t) -> np.ndarray:
    """A leaf's bytes as unsigned integers (bit-for-bit comparisons)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a.reshape(-1).view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                               8: np.uint64}[a.dtype.itemsize])


def test_roundtrip(tmp_path):
    t = _torch_tree(_arrays())
    save_checkpoint(str(tmp_path), 5, t, meta={"arch": "x"})
    restored, step, meta = restore_checkpoint(str(tmp_path), t)
    assert step == 5 and meta == {"arch": "x"}
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def test_keep_k_and_latest(tmp_path):
    t = _torch_tree(_arrays())
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_4", "step_5"]
    assert latest_step(str(tmp_path)) == 5
    cleanup_old(str(tmp_path), keep=1)
    assert os.listdir(tmp_path) == ["step_5"]


def test_atomicity_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _torch_tree(_arrays()))
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_shape_mismatch_and_missing_leaf_raise(tmp_path):
    save_checkpoint(str(tmp_path), 1, _torch_tree(_arrays()))
    bad = _torch_tree(_arrays())
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="params/w"):
        restore_checkpoint(str(tmp_path), bad)
    extra = _torch_tree(_arrays())
    extra["opt"]["lr"] = torch.zeros(())
    with pytest.raises(KeyError, match="opt/lr"):
        restore_checkpoint(str(tmp_path), extra)


def test_no_checkpoint_raises(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _torch_tree(_arrays()))


def test_shardings_refused(tmp_path):
    """``shardings`` must be a tree of ``NamedSharding`` s over a mesh
    (``tests/test_torch_distributed.py`` restores onto one); a tree of
    anything else is refused."""
    t = _torch_tree(_arrays())
    save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(TypeError, match="NamedSharding"):
        restore_checkpoint(str(tmp_path), t, shardings=t)


def test_restore_casts_to_the_template_and_device(tmp_path):
    t = _torch_tree(_arrays())
    save_checkpoint(str(tmp_path), 2, t)
    tmpl = _torch_tree(_arrays())
    tmpl["params"]["w"] = torch.zeros((8, 4), dtype=torch.float64)
    out, _, _ = restore_checkpoint(str(tmp_path), tmpl, step=2,
                                   device="cpu")
    assert out["params"]["w"].dtype == torch.float64
    assert torch.equal(out["params"]["w"].float(), t["params"]["w"])


def test_manifest_and_keys_equal_the_reference(tmp_path):
    arrs = _arrays()
    jck.save_checkpoint(str(tmp_path / "jax"), 3, _jax_tree(arrs),
                        meta={"arch": "x"})
    save_checkpoint(str(tmp_path / "port"), 3, _torch_tree(arrs),
                    meta={"arch": "x"})
    man = [json.loads((tmp_path / d / "step_3" / "manifest.json")
                      .read_text()) for d in ("jax", "port")]
    assert man[0] == man[1]
    keys = [sorted(np.load(tmp_path / d / "step_3" / "arrays.npz").files)
            for d in ("jax", "port")]
    assert keys[0] == keys[1]
    assert "params/blocks/1" in keys[0]
    assert man[0]["leaves"]["params/blocks/1"]["dtype"] == "bfloat16"


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    arrs = _arrays(3)
    jck.save_checkpoint(str(tmp_path), 4, _jax_tree(arrs), meta={"m": 1})
    out, step, meta = restore_checkpoint(str(tmp_path), _torch_tree(arrs))
    assert step == 4 and meta == {"m": 1}
    assert out["params"]["blocks"][1].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(_jax_tree(arrs)), tree_leaves(out)):
        assert np.array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    arrs = _arrays(4)
    save_checkpoint(str(tmp_path), 6, _torch_tree(arrs), meta={"m": 2})
    out, step, meta = jck.restore_checkpoint(str(tmp_path), _jax_tree(arrs))
    assert step == 6 and meta == {"m": 2}
    assert out["params"]["blocks"][1].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(_jax_tree(arrs)), jax.tree.leaves(out)):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_optimizer_state_keys_cross_restore(tmp_path, moments):
    """A {"params", "opt"} checkpoint of the trainers: the optimizer state
    gives ``opt/m/...``, ``opt/v/...`` and a 0-d int32 ``opt/step`` in
    both packages, and each restores the other's."""
    rng = np.random.default_rng(5)
    params = {"sa": [[{"w": rng.normal(size=(4, 8)).astype(np.float32),
                       "b": np.zeros(8, np.float32)}]],
              "head": [{"w": rng.normal(size=(8, 3)).astype(np.float32),
                        "b": np.zeros(3, np.float32)}]}
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw_init(jp, JAdamWConfig(moment_dtype=moments))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    topt = adamw_init(tp, AdamWConfig(moment_dtype=moments))
    topt["m"]["head"][0]["w"].fill_(0.3)        # some non-zero moment bits
    jck.save_checkpoint(str(tmp_path / "jax"), 1, {"params": jp,
                                                   "opt": jopt})
    save_checkpoint(str(tmp_path / "port"), 1, {"params": tp, "opt": topt})
    keys = [set(np.load(tmp_path / d / "step_1" / "arrays.npz").files)
            for d in ("jax", "port")]
    assert keys[0] == keys[1]
    assert {"opt/step", "opt/m/head/0/w", "opt/v/sa/0/0/b"} <= keys[0]
    out, _, _ = restore_checkpoint(str(tmp_path / "port"),
                                   {"params": tp, "opt": topt})
    assert out["opt"]["step"].dtype == torch.int32
    assert out["opt"]["m"]["head"][0]["w"].dtype == getattr(torch, moments)
    assert torch.equal(out["opt"]["m"]["head"][0]["w"],
                       topt["m"]["head"][0]["w"])
    back, _, _ = jck.restore_checkpoint(str(tmp_path / "port"),
                                        {"params": jp, "opt": jopt})
    assert np.array_equal(_bits(back["opt"]["m"]["head"][0]["w"]),
                          _bits(topt["m"]["head"][0]["w"]))


def test_the_port_needs_no_extension_dtype_package():
    code = ("import sys, repro_torch.checkpoint\n"
            "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n")
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
