"""The port's LM training loop (``repro_torch.launch.train.run_training``)
on the CPU: SIGTERM preemption and resume, in a subprocess, as
``tests/test_checkpoint_fault.py`` drives the reference's; and checkpoints
that either package restores from the other's, leaf for leaf and bit for
bit, at ``reduced()`` of qwen1.5-0.5b (float32) and of rwkv6-3b in bf16
with bf16 moments and the compression residuals. JAX is imported inside
the fixtures.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa
from repro_torch.configs import get_config                          # noqa: E402
from repro_torch.launch import (TrainLoopConfig, init_train_state,  # noqa: E402
                                run_training)
from repro_torch.optim import AdamWConfig, tree_leaves              # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_preemption_checkpoints_and_resumes(tmp_path):
    """SIGTERM mid-training -> a clean checkpoint and exit 0; a restart
    resumes from the latest step and runs only the steps left."""
    script = f"""
import os, signal, sys
sys.path.insert(0, {SRC!r})
import torch
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.launch import TrainLoopConfig, run_training

cfg = get_config("qwen1.5-0.5b").reduced()
loop = TrainLoopConfig(steps=2000, batch_size=2, seq_len=16, ckpt_every=3,
                       ckpt_dir={str(tmp_path)!r}, log_every=1000)

class Bomb:
    def __init__(self): self.n = 0
    def __call__(self, step):
        self.n += 1
        if self.n == 5: os.kill(os.getpid(), signal.SIGTERM)
        ids, labels = TokenStream(cfg.vocab_size, 16, 2, seed=0).batch(step)
        return {{"ids": torch.from_numpy(ids),
                 "labels": torch.from_numpy(labels)}}

hist, state, _ = run_training(cfg, loop, data=Bomb(), verbose=False,
                              device="cpu")
assert len(hist) < 2000, "should have stopped early"
print("STOPPED_AT", len(hist))
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-2000:]
    stopped = int(r.stdout.split("STOPPED_AT")[1].split()[0])
    step = latest_step(str(tmp_path))
    assert step == stopped == 5
    cfg = get_config("qwen1.5-0.5b").reduced()
    loop = TrainLoopConfig(steps=step + 2, batch_size=2, seq_len=16,
                           ckpt_every=1000, ckpt_dir=str(tmp_path))
    hist, state, _ = run_training(cfg, loop, verbose=False, device="cpu")
    assert len(hist) == 2
    assert int(state["opt"]["step"]) == step + 2
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_resume_continues_the_uninterrupted_run_bitwise(tmp_path):
    """Resuming from step 2 gives the uninterrupted run's losses and
    final state, bit for bit."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    kw = dict(batch_size=2, seq_len=16, ckpt_every=2, log_every=1000)
    whole, w_state, _ = run_training(
        cfg, TrainLoopConfig(steps=4, ckpt_dir=str(tmp_path / "a"), **kw),
        verbose=False, device="cpu")
    run_training(cfg, TrainLoopConfig(steps=2, ckpt_dir=str(tmp_path / "b"),
                                      **kw),
                 AdamWConfig(total_steps=4, warmup_steps=1), verbose=False,
                 device="cpu")
    rest, r_state, _ = run_training(
        cfg, TrainLoopConfig(steps=4, ckpt_dir=str(tmp_path / "b"), **kw),
        verbose=False, device="cpu")
    assert [h["loss"] for h in rest] == [h["loss"] for h in whole[2:]]
    assert all(torch.equal(a.detach(), b.detach()) for a, b in
               zip(tree_leaves(r_state), tree_leaves(w_state)))


CROSS = {"qwen-f32": ("qwen1.5-0.5b", {}, "float32", False),
         "rwkv-bf16": ("rwkv6-3b", {"dtype": "bfloat16"}, "bfloat16", True)}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.configs import get_config as ref_get_config
    from repro.launch import train as ref_train
    from repro.optim import AdamWConfig as RefAdamWConfig
    return dict(jax=jax, restore=ref_restore, get_config=ref_get_config,
                train=ref_train, AdamWConfig=RefAdamWConfig)


def _configs(ref, case):
    arch, over, moments, compress = CROSS[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    rcfg = dataclasses.replace(ref["get_config"](arch).reduced(), **over)
    kw = dict(total_steps=3, warmup_steps=1, moment_dtype=moments)
    loop = dict(steps=3, batch_size=2, seq_len=16, ckpt_every=3,
                log_every=1000, grad_compression=compress)
    return cfg, rcfg, AdamWConfig(**kw), ref["AdamWConfig"](**kw), loop


@pytest.mark.parametrize("case", list(CROSS))
def test_port_checkpoint_restores_in_the_reference(ref, case, tmp_path):
    jax = ref["jax"]
    cfg, rcfg, opt, ropt, loop = _configs(ref, case)
    _, state, _ = run_training(cfg, TrainLoopConfig(ckpt_dir=str(tmp_path),
                                                    **loop), opt,
                               verbose=False, device="cpu")
    template = ref["train"].init_train_state(
        jax.random.PRNGKey(0), rcfg, ropt,
        grad_compression=loop["grad_compression"])
    restored, step, meta = ref["restore"](str(tmp_path), template)
    assert step == 3 and meta == {"arch": cfg.name}
    got, want = jax.tree.leaves(restored), tree_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype.name == str(b.dtype).removeprefix(
            "torch.")
        assert np.array_equal(_np_bits(a), _bits(b))


@pytest.mark.parametrize("case", list(CROSS))
def test_reference_checkpoint_restores_in_the_port(ref, case, tmp_path):
    jax = ref["jax"]
    cfg, rcfg, opt, ropt, loop = _configs(ref, case)
    _, rstate, _ = ref["train"].run_training(
        rcfg, ref["train"].TrainLoopConfig(ckpt_dir=str(tmp_path), **loop),
        ropt, verbose=False)
    template = init_train_state(0, cfg, opt, device="cpu",
                                grad_compression=loop["grad_compression"])
    restored, step, _ = restore_checkpoint(str(tmp_path), template)
    assert step == 3
    for a, b in zip(tree_leaves(restored), jax.tree.leaves(rstate)):
        assert np.array_equal(_bits(a), _np_bits(jax.device_get(b)))
    # the port's loop resumes from it: the reference's state, then on
    hist, state, _ = run_training(
        cfg, TrainLoopConfig(**dict(loop, steps=4, ckpt_every=1000),
                             ckpt_dir=str(tmp_path)), opt, verbose=False,
        device="cpu")
    assert len(hist) == 1 and int(state["opt"]["step"]) == 4
    assert np.isfinite(hist[0]["loss"])
