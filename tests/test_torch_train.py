"""PointNet++ training on the port against the JAX package: the float
backend's loss and gradients, AdamW steps, the trainer example, and the
fault-tolerance primitives.

A model0-shaped tiny config (two SA layers, 64 points, widths up to 32)
carries the reference's weights across (``params_from_numpy``). The
reference takes ``jax.value_and_grad`` of ``compile_model(p,
cfg).loss_fn``; the port compiles once with leaves that require grad and
takes ``torch.autograd.grad`` of the same loss.

Tolerances, and why:
- the loss within ``1e-6`` relative and the accuracy equal: the float
  matmuls sum in another order in each framework;
- every gradient leaf within ``1e-4 * max|g|`` of the reference's: the
  backward of the feature gathers is a scatter-add whose summation order
  differs (and on the card is not fixed at all);
- parameters after three AdamW steps within ``1e-5`` relative to each
  leaf's largest value, except where a step's reference gradient lies at
  rounding level (below ``1e-6 * max|g|`` of its leaf, and not the port's
  own value: an exact zero in both frameworks is held strictly). There
  the true gradient is zero: SA-1's last bias shifts a feature channel,
  and the neighbour-minus-centre difference does not see a shift, wherever
  the unit is active at every row a max picks. Each framework leaves its
  own rounding residue there (~1e-9, or exactly 0), and Adam's
  ``m / sqrt(v)`` turns a residue into a step of up to ``lr``, of either
  sign. Those elements are held to that bound instead: within twice the
  summed learning rates.
"""
import os
import pathlib
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compile_model as jcompile                         # noqa: E402
from repro.core.workload import PointNetConfig as JConfig           # noqa: E402
from repro.core.workload import SALayerSpec as JSpec                # noqa: E402
from repro.models import pointnet2 as jpn                           # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig                 # noqa: E402
from repro.optim import adamw_init as jadamw_init                   # noqa: E402
from repro.optim import adamw_update as jadamw_update               # noqa: E402
import repro_torch                                                  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint               # noqa: E402
from repro_torch.convert import params_from_numpy                   # noqa: E402
from repro_torch.core.workload import PointNetConfig, SALayerSpec   # noqa: E402
from repro_torch.launch.fault import (GracefulShutdown,             # noqa: E402
                                      StragglerWatchdog, retry)
from repro_torch.models import pointnet2 as tpn                     # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,             # noqa: E402
                               adamw_update, tree_leaves, tree_map)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import train_pointnet_torch as trainer                              # noqa: E402

N_CLASSES = 10


def _tiny(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=32, n_neighbors=8, in_features=4,
                 mlp=(4, 16, 16, 32)),
        spec_cls(n_centers=8, n_neighbors=8, in_features=32,
                 mlp=(32, 32, 32, 32))))


def _batch(seed, batch=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 64, 3)).astype(np.float32),
            rng.integers(0, N_CLASSES, batch).astype(np.int32))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = _tiny(JConfig, JSpec), _tiny(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j,
                              n_classes=N_CLASSES)
    return cfg_j, cfg_t, jparams


def _trained(jparams):
    """The port's copy of the reference's weights, leaves requiring grad."""
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_numpy(jax.device_get(jparams)))


_JAX_STEPS: dict = {}


def _jax_value_and_grad(cfg_j, jparams, clouds, labels):
    """The reference trainer's loss and gradients, jitted as it jits them
    (once per config)."""
    if cfg_j not in _JAX_STEPS:
        _JAX_STEPS[cfg_j] = jax.jit(jax.value_and_grad(
            lambda p, c, l: jcompile(p, cfg_j).loss_fn(c, l), has_aux=True))
    return _JAX_STEPS[cfg_j](jparams, jnp.asarray(clouds),
                             jnp.asarray(labels))


def _port_value_and_grad(model, params, clouds, labels):
    loss, acc = model.loss_fn(clouds, labels)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss, acc, grads


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_the_reference(setup, seed):
    cfg_j, cfg_t, jparams = setup
    clouds, labels = _batch(seed)
    (jloss, jacc), jgrads = _jax_value_and_grad(cfg_j, jparams, clouds,
                                                labels)
    params = _trained(jparams)
    model = repro_torch.compile_model(params, cfg_t, device="cpu")
    loss, acc, grads = _port_value_and_grad(model, params, clouds, labels)
    assert loss.requires_grad and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    assert float(acc) == float(jacc)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for jg, g in zip(jleaves, grads):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max())


def test_the_delegate_loss_carries_gradients(setup):
    cfg_j, cfg_t, jparams = setup
    clouds, labels = _batch(2)
    params = _trained(jparams)
    loss, _ = tpn.loss_fn(params, cfg_t, clouds, labels, device="cpu")
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(bool(g.abs().sum() > 0) for g in grads)


def test_three_adamw_steps_match_the_reference(setup):
    cfg_j, cfg_t, jparams = setup
    kw = dict(lr=1e-3, total_steps=3, warmup_steps=1, weight_decay=0.01)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    params = _trained(jparams)
    model = repro_torch.compile_model(params, cfg_t, device="cpu")
    jp, jopt, topt = jparams, jadamw_init(jparams, jcfg), adamw_init(params,
                                                                     tcfg)
    noise, lr_sum = None, 0.0
    for step in range(3):
        clouds, labels = _batch(10 + step)
        (jloss, _), jg = _jax_value_and_grad(cfg_j, jp, clouds, labels)
        jp, jopt, jm = jadamw_update(jp, jg, jopt, jcfg)
        lr_sum += float(jm["lr"])
        loss, _, grads = _port_value_and_grad(model, params, clouds, labels)
        small = [(np.abs(g) < 1e-6 * np.abs(g).max()) & (g != pg.numpy())
                 for g, pg in zip(map(np.asarray, jax.tree.leaves(jg)),
                                  grads)]
        noise = small if noise is None else [a | b for a, b in zip(noise,
                                                                   small)]
        it = iter(grads)
        params, topt, _ = adamw_update(params, tree_map(lambda _: next(it),
                                                        params), topt, tcfg)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-6)
    for jw, w, at_noise in zip(jax.tree.leaves(jp), tree_leaves(params),
                               noise):
        jw, w = np.asarray(jw), w.detach().numpy()
        np.testing.assert_allclose(w[~at_noise], jw[~at_noise], rtol=0,
                                   atol=1e-5 * np.abs(jw).max())
        assert np.all(np.abs(w - jw)[at_noise] <= 2 * lr_sum)
    assert sum(int(n.sum()) for n in noise) <= 32    # SA-1's last bias


def _entry_points(model, clouds, labels):
    nll, acc = model.eval_step(clouds, labels)
    return {"forward": model.forward(clouds[0]),
            "batched_forward": model.batched_forward(clouds),
            "eval_nll": nll, "eval_acc": acc,
            "jit_forward": model.jit_forward(clouds[0]),
            "jit_batched_forward": model.jit_batched_forward(clouds)}


@pytest.mark.parametrize("schedule", ["baseline", "pointer"])
def test_inference_entry_points_unchanged_by_trained_leaves(setup,
                                                            schedule):
    """The 'float' inference entry points of a model compiled from leaves
    that require grad (kept, not copied) equal bit for bit those of one
    compiled from plain tensors (copied into buffers, as before), carry no
    graph, and their captured forms equal the eager ones."""
    cfg_j, cfg_t, jparams = setup
    clouds, labels = _batch(3)
    plain = repro_torch.compile_model(
        params_from_numpy(jax.device_get(jparams)), cfg_t,
        schedule=schedule, device="cpu")
    params = _trained(jparams)
    kept = repro_torch.compile_model(params, cfg_t, schedule=schedule,
                                     device="cpu")
    assert kept.backend.head.w0 is params["head"][0]["w"]
    want, got = (_entry_points(m, clouds, labels) for m in (plain, kept))
    for name in want:
        assert torch.equal(want[name], got[name]), name
        assert not got[name].requires_grad, name
    assert torch.equal(got["jit_batched_forward"], got["batched_forward"])
    assert torch.equal(got["jit_forward"], got["forward"])
    loss, _ = kept.loss_fn(clouds, labels)
    assert torch.equal(loss.detach(), got["eval_nll"])
    assert loss.requires_grad == (schedule == "baseline")


@pytest.mark.parametrize("backend", ["reram", "reram-fused"])
def test_crossbar_losses_carry_no_gradient(setup, backend):
    cfg_j, cfg_t, jparams = setup
    params = _trained(jparams)
    model = repro_torch.compile_model(params, cfg_t, backend=backend,
                                      device="cpu")
    loss, _ = model.loss_fn(*_batch(4))
    assert not loss.requires_grad
    if backend == "reram":
        assert model.backend.head.w0 is not params["head"][0]["w"]


def test_compiled_once_the_update_in_place_is_read(setup):
    cfg_j, cfg_t, jparams = setup
    params = _trained(jparams)
    model = repro_torch.compile_model(params, cfg_t, device="cpu")
    clouds, _ = _batch(5)
    before = model.batched_forward(clouds)
    with torch.no_grad():
        params["head"][1]["b"].add_(1.0)
    assert torch.allclose(model.batched_forward(clouds), before + 1.0,
                          atol=1e-5)


def test_trained_leaves_must_sit_on_the_model_device(setup):
    cfg_j, cfg_t, jparams = setup
    params = _trained(jparams)
    params["head"][0]["w"] = torch.zeros((32, 256), device="meta",
                                         requires_grad=True)
    with pytest.raises(ValueError, match="model's device"):
        repro_torch.compile_model(params, cfg_t, device="cpu")
    params = _trained(jparams)
    params["head"][0]["b"] = torch.zeros(256, dtype=torch.float64,
                                         requires_grad=True)
    with pytest.raises(TypeError, match="float32"):
        repro_torch.compile_model(params, cfg_t, device="cpu")


def test_train_config_is_model0_at_1024_and_scaled_below():
    cfg0 = repro_torch.PAPER_MODELS["model0"]
    assert trainer.train_config(1024) is cfg0
    cfg = trainer.train_config(256)
    assert cfg.n_points == 256
    assert [s.n_centers for s in cfg.layers] == [128, 32]   # the reference's
    assert [s.mlp for s in cfg.layers] == [s.mlp for s in cfg0.layers]


def test_trainer_main_lowers_the_loss_and_checkpoints(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = trainer.main(["--device", "cpu", "--steps", "100", "--batch",
                        "16", "--points", "64", "--seed", "0", "--ckpt",
                        str(ckpt)])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 100 and all(np.isfinite(losses))
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    assert out["ckpt"] == str(ckpt / "step_100")
    restored, step, meta = restore_checkpoint(
        str(ckpt), {"params": out["params"], "opt": out["opt"]})
    assert step == 100 and meta == {"arch": "pointnet2-model0"}
    want = tree_leaves({"params": out["params"], "opt": out["opt"]})
    for a, b in zip(want, tree_leaves(restored)):
        assert torch.equal(a.detach(), b)
    assert int(out["opt"]["step"]) == 100


def test_trainer_wants_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.main(["--steps", "1", "--ckpt", str(tmp_path)])


# ---------------------------------------------------------------------------
# fault tolerance (the port's copy of repro.launch.fault)
# ---------------------------------------------------------------------------

def test_straggler_watchdog_flags_slow_steps():
    w = StragglerWatchdog(threshold=2.0, alpha=0.5)
    for s in range(10):
        assert not w.observe(s, 0.10)
    assert w.observe(10, 0.50)           # 5x baseline -> straggler
    assert w.flagged_steps and w.flagged_steps[0][0] == 10
    assert w.ewma == pytest.approx(0.10, rel=0.05)


def test_graceful_shutdown_flag():
    g = GracefulShutdown(signals=(signal.SIGUSR1,))
    assert not g.requested
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert g.requested
    g.restore()


def test_retry_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 42
    assert retry(flaky, attempts=5, backoff_s=0.001) == 42
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("x")).__next__(),
              attempts=2, backoff_s=0.001)
    with pytest.raises(ValueError):
        retry(flaky, attempts=0)


def test_retry_jitter_deterministic_with_injected_rng():
    def always_fails():
        raise OSError("transient")

    def trajectory(seed):
        sleeps = []
        with pytest.raises(OSError):
            retry(always_fails, attempts=4, backoff_s=0.5, jitter_s=0.25,
                  rng=np.random.default_rng(seed), sleep=sleeps.append)
        return sleeps

    a, b, c = trajectory(7), trajectory(7), trajectory(8)
    assert len(a) == 3 and a == b and a != c
    for i, s in enumerate(a):
        base = 0.5 * (2 ** i)
        assert base <= s <= base + 0.25
    sleeps = []
    with pytest.raises(OSError):
        retry(always_fails, attempts=3, backoff_s=0.1, jitter_s=0.0,
              sleep=sleeps.append)
    assert sleeps == [0.1, 0.2]
