"""Atomic, keep-K checkpoints of trees of tensors, in the JAX package's
on-disk format, so that either package restores the other's.

Layout:  <dir>/step_<N>/
             manifest.json       step, meta, and every leaf's shape and
                                 logical dtype
             arrays.npz          one entry per leaf, keyed by its path

A leaf's key is its path joined with ``/``: dict keys (the entries in
sorted key order) and list or tuple positions, so the optimizer's state
gives ``opt/m/...``, ``opt/v/...`` and a 0-d int32 ``opt/step``. NumPy
cannot store bfloat16, so a bfloat16 leaf (and a float16 one, as the
reference does) is stored as an unsigned view of its bits with its logical
dtype in the manifest; the view is taken through torch (``int16`` <->
``bfloat16``), so no extension dtype package is needed.

A save writes ``step_<N>.tmp`` and then ``os.replace``s it, so an
interruption never leaves a half-written latest checkpoint, and keeps the
newest ``keep`` steps.

Elastic: leaves are stored as *global* arrays with their global shapes. A
sharded leaf (a ``DTensor``) is gathered at save; under a started process
group every rank calls :func:`save_checkpoint`, global rank 0 writes and
all wait for it. :func:`restore_checkpoint` with ``shardings`` (a tree of
``launch.sharding.NamedSharding`` s) re-cuts each global array into this
rank's shard for the mesh given, whatever the mesh it was saved from, so a
job resumes on another number of ranks.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

__all__ = ["cleanup_old", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")

#: Logical dtypes stored as an unsigned view of their bits: name ->
#: (torch dtype, the signed torch view, the numpy view on disk).
_VIEWED = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
           "float16": (torch.float16, torch.int16, np.uint16)}


def _flatten(tree, prefix: tuple = ()) -> dict:
    """``{path key: leaf}`` in the JAX package's leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(template, flat: dict, prefix: tuple = ()):
    """``template``'s structure with the leaves of ``flat``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    return flat["/".join(prefix)]


def _to_savable(t) -> tuple[np.ndarray, str]:
    """A leaf as the array stored and its logical dtype's name (a
    ``DTensor`` gathered whole)."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = torch.as_tensor(t).detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _VIEWED:
        _, signed, on_disk = _VIEWED[name]
        return t.view(signed).numpy().view(on_disk), name
    a = t.numpy()
    return a, str(a.dtype)


def _from_saved(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _VIEWED:
        dtype, signed, on_disk = _VIEWED[logical]
        if arr.dtype == on_disk:
            return torch.from_numpy(arr.view(np.int16).copy()).view(dtype)
        return torch.from_numpy(np.array(arr)).to(dtype)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(logical)))


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    meta: dict | None = None) -> str:
    """Blocking save of ``tree`` (tensors, arrays or ``DTensor`` s at the
    leaves) as step ``step``. Returns the final checkpoint path."""
    import torch.distributed as dist
    arrays, logical = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], logical[k] = _to_savable(v)
    final = os.path.join(ckpt_dir, f"step_{step}")
    if dist.is_initialized():
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, arrays, logical, meta, keep)
        dist.barrier()
    else:
        _write(ckpt_dir, final, step, arrays, logical, meta, keep)
    return final


def _write(ckpt_dir: str, final: str, step: int, arrays: dict,
           logical: dict, meta, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {
        "step": int(step),
        "meta": meta or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": logical[k]}
                   for k, v in arrays.items()},
    }
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    cleanup_old(ckpt_dir, keep=keep)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def cleanup_old(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def restore_checkpoint(ckpt_dir: str, template, *, step: int | None = None,
                       device=None, shardings=None):
    """Restore into the structure of ``template`` (a tree of tensors, or of
    anything with ``shape`` and ``dtype``), each leaf cast to the
    template's dtype and placed on ``device`` (by default the template
    leaf's device, the CPU for a leaf that is not a tensor). The latest
    step unless ``step`` names one. Returns ``(tree, step, meta)``.
    ``shardings``: a matching tree of ``launch.sharding.NamedSharding`` s,
    the elastic-resize path: each global array is cut into this rank's
    shard for that mesh and returned as a ``DTensor`` on the mesh's
    device (``device`` is not read)."""
    shd_flat = None
    if shardings is not None:
        from repro_torch.launch.sharding import NamedSharding
        shd_flat = _flatten(shardings)
        bad = [k for k, s in shd_flat.items()
               if not isinstance(s, NamedSharding)]
        if bad:
            raise TypeError(f"shardings= takes a tree of NamedShardings "
                            f"(launch/sharding.py::named_shardings); "
                            f"{bad[0]!r} is a {type(shd_flat[bad[0]])}")
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, tmpl in _flatten(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _from_saved(data[key], manifest["leaves"][key]["dtype"])
            want = tuple(tmpl.shape)
            if tuple(t.shape) != want:
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(t.shape)} != template {want}")
            dtype = _torch_dtype(tmpl.dtype)
            if shd_flat is not None:
                out[key] = shd_flat[key].put(t.to(dtype))
                continue
            dev = device if device is not None else (
                tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
            out[key] = t.to(device=dev, dtype=dtype)
    return _unflatten(template, out), manifest["step"], manifest["meta"]


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or a NumPy one (or its name) as torch's."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    return getattr(torch, name)
