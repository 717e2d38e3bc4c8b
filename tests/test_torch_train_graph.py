"""The training step captured into one CUDA graph
(``examples/train_pointnet_torch.py::make_step`` over
``models/backend.py::StepGraphs``), and what it rests on.

On the CPU:
- ``adamw_update(..., step_in_place=True)``, the form a captured step
  needs, equals the functional form bit for bit and the JAX package's
  AdamW within ``test_torch_optim.py``'s stated bounds (rtol 1e-6; the
  learning rate bit for bit), over 3 steps, and advances the state's own
  step tensor;
- ``CudaGraphCall.warm_up`` (a capture with ``state=``, as the serving
  sessions use) leaves the parameters, moments and step counter bit for
  bit as they were, so a run that warms up, then steps, goes through the
  eager run's states;
- off the card ``StepGraphs`` calls the step itself every time, and
  ``make_step`` is the eager step.

On the card (``cuda`` marker; skipped here; the file imports no JAX at
the top, so it runs where there is none): P4 bit for bit against its
plain version at the training path's shapes, two eager runs bit for bit
equal, captured steps bit for bit the eager ones (the first two calls
eager, real steps; one graph per state and shapes), the graph holding the
live parameter tensors, and K7 and P4 at 2 launches a replayed step.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (launch_counts,                     # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.gather_backward import (                   # noqa: E402
    gather_rows_backward_cuda, gather_rows_backward_plain, segments)
from repro_torch.models.backend import (CudaGraphCall,              # noqa: E402
                                        StepGraphs)
from repro_torch.optim import (AdamWConfig, adamw_init,             # noqa: E402
                               adamw_update, tree_leaves, tree_map)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import train_pointnet_torch as trainer                              # noqa: E402


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa
    return {"sa": [[{"w": mk(4, 16), "b": mk(16)}]],
            "head": [{"w": mk(16, 10), "b": mk(10)}]}


def _torch_tree(tree):
    return tree_map(lambda a: torch.tensor(np.array(a)), tree)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_in_place_step_counter_matches_functional_and_reference(moments):
    jax = pytest.importorskip("jax")       # the card's machine has no JAX
    jnp = jax.numpy
    from repro.optim import optimizer as ref
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
              clip_norm=5.0, moment_dtype=moments)
    rcfg, pcfg = ref.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    fp, ip = _torch_tree(_tree(0)), _torch_tree(_tree(0))
    js, fs, ist = ref.adamw_init(jp, rcfg), adamw_init(fp, pcfg), \
        adamw_init(ip, pcfg)
    counter = ist["step"]
    for step in range(3):
        grads = _tree(10 + step, scale=0.5 + step)
        jp, js, jm = ref.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                      js, rcfg)
        fp, fs, fm = adamw_update(fp, _torch_tree(grads), fs, pcfg)
        ip, ist, im = adamw_update(ip, _torch_tree(grads), ist, pcfg,
                                   step_in_place=True)
        assert ist["step"] is counter and fs["step"] is not counter
        assert int(counter) == int(fs["step"]) == int(js["step"]) == step + 1
        assert torch.equal(im["lr"], fm["lr"])
        assert float(im["lr"]) == float(jm["lr"])
        assert torch.equal(im["grad_norm"], fm["grad_norm"])
    for a, b in zip(tree_leaves((fp, fs["m"], fs["v"])),
                    tree_leaves((ip, ist["m"], ist["v"]))):
        assert torch.equal(a, b)
    for w, g in zip(jax.tree.leaves(jp), tree_leaves(ip)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


def _args(device, steps=3, points=64, batch=2):
    return trainer.parse_args(["--device", device, "--points", str(points),
                               "--batch", str(batch), "--steps", str(steps),
                               "--seed", "0"])


def _state(run):
    return tree_leaves(run["params"]) + tree_leaves(run["opt"])


def _train(args, step_of):
    """``args.steps`` steps of a fresh run through ``step_of(run)``.
    Returns the losses and the final state."""
    run = trainer.setup(args)
    step = step_of(run)
    dev = run["device"]
    batches = [(torch.from_numpy(c).to(dev), torch.from_numpy(l).to(dev))
               for c, l in run["data"].batches(args.batch, args.steps)]
    losses = [step(*b)[0] for b in batches]
    return [float(x) for x in losses], _state(run), run


def _eager(run):
    def step(clouds, labels):
        return trainer.train_step(run["model"], run["params"], run["opt"],
                                  run["opt_config"], clouds, labels)[1:]
    return step


def _captured(run):
    return trainer.make_step(run["model"], run["params"], run["opt"],
                             run["opt_config"])


def test_warm_up_restores_params_moments_and_step_bitwise():
    run = trainer.setup(_args("cpu"))
    state = _state(run)
    before = [t.detach().clone() for t in state]
    clouds, labels = next(run["data"].batches(2, 1))
    calls = []

    def step(c, l):
        calls.append(1)
        return _eager(run)(c, l)
    CudaGraphCall.warm_up(step, (torch.from_numpy(clouds),
                                 torch.from_numpy(labels)), state)
    assert len(calls) == CudaGraphCall.WARMUP
    assert all(t.requires_grad for t in tree_leaves(run["params"]))
    for t, b in zip(state, before):
        assert torch.equal(t.detach(), b)
    assert int(run["opt"]["step"]) == 0


def test_a_warmed_up_run_goes_through_the_eager_states():
    """Warm-ups then 3 steps: the losses and the final state of 3 steps
    without warm-ups, bit for bit (the captured run's sequence)."""
    want, w_state, _ = _train(_args("cpu"), _eager)
    got, g_state, _ = _train(_args("cpu"), _warmed_up)
    assert got == want
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(g_state, w_state))


def _warmed_up(run):
    """The eager step, its first call preceded by
    :meth:`CudaGraphCall.warm_up` on that call's batch, as a capture with
    ``state=`` does."""
    step, first = _eager(run), []

    def warmed(clouds, labels):
        if not first:
            first.append(1)
            CudaGraphCall.warm_up(step, (clouds, labels), _state(run))
        return step(clouds, labels)
    return warmed


def test_step_graphs_call_the_step_every_time_off_the_card():
    calls = []

    def step(x, y):
        calls.append((x, y))
        return x + 1, y

    graphs = StepGraphs()
    x, state = torch.zeros(3), [torch.ones(2)]
    for i in range(4):
        out = graphs(step, state, (x, None))
        assert torch.equal(out[0], x + 1) and out[1] is None
        assert len(calls) == i + 1 and calls[-1][0] is x
    assert graphs.graphs == {}


def test_make_step_on_the_cpu_is_the_eager_step():
    want, w_state, _ = _train(_args("cpu"), _eager)
    got, g_state, run = _train(_args("cpu"), _captured)
    assert got == want and int(run["opt"]["step"]) == 3
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(g_state, w_state))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


#: model0 at 256 points (128 and 32 centres), batch 4: the trainer's own
#: reduced run, on the card.
CARD = dict(points=256, batch=4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,p,c", [(16, 512, 128 * 16, 128),
                                     (16, 512, 128, 128),
                                     (3, 9, 300, 5), (1, 4, 0, 8)])
def test_p4_kernel_bitwise_against_plain(cuda, b, n, p, c):
    """At the training path's SA-2 gathers (16 clouds, 128 x 16
    neighbours and 128 centres into 512 rows of 128), at heavy duplication
    (300 positions into 9 rows), and with no position at all."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n, (b, p))).to(cuda)
    g = torch.from_numpy(rng.normal(size=(b * p, c)).astype(np.float32)) \
        .to(cuda)
    perm, starts = segments(idx, n)
    reset_launch_counts()
    got = gather_rows_backward_cuda(g, perm, starts)
    want = gather_rows_backward_plain(g, perm, starts)
    torch.cuda.synchronize()
    assert launch_counts()["gather_rows_backward"] == 1
    assert got.shape == want.shape == (b * n, c)
    assert torch.equal(got, want)
    cpu = gather_rows_backward_plain(g.cpu(), perm.cpu(), starts.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_two_eager_card_runs_are_bitwise_equal(cuda):
    reset_launch_counts()
    a, a_state, _ = _train(_args("cuda", steps=5, **CARD), _eager)
    counts = launch_counts()
    b, b_state, _ = _train(_args("cuda", steps=5, **CARD), _eager)
    assert counts["gather_rows_backward"] == 2 * 5      # SA-2's two gathers
    assert counts["fps"] == 2 * 5
    assert a == b
    assert all(torch.equal(x.detach(), y.detach())
               for x, y in zip(a_state, b_state))


@pytest.mark.cuda
def test_captured_steps_are_the_eager_steps_bitwise(cuda):
    want, w_state, _ = _train(_args("cuda", steps=5, **CARD), _eager)
    got, g_state, run = _train(_args("cuda", steps=5, **CARD), _captured)
    assert got == want and int(run["opt"]["step"]) == 5
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(g_state, w_state))


@pytest.mark.cuda
def test_the_graph_holds_the_live_parameter_tensors(cuda):
    """The replays write the very tensors the loop checkpoints and the
    model reads as its weights: their addresses never change, and each
    replay changes their values."""
    run = trainer.setup(_args("cuda", steps=3, **CARD))
    state = _state(run)
    ptrs = [t.data_ptr() for t in state]
    weights = {b.data_ptr() for b in run["model"].backend.buffers()}
    assert {t.data_ptr() for t in tree_leaves(run["params"])} <= weights
    step = _captured(run)
    batches = [(torch.from_numpy(c).to(cuda), torch.from_numpy(l).to(cuda))
               for c, l in run["data"].batches(CARD["batch"], 3)]
    before = [t.detach().clone() for t in state]
    for i, bt in enumerate(batches):
        step(*bt)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in _state(run)] == ptrs
        assert int(run["opt"]["step"]) == i + 1
    assert all(not torch.equal(t.detach(), b)
               for t, b in zip(tree_leaves(run["params"]), before))


@pytest.mark.cuda
def test_a_replayed_step_launches_k7_and_p4_twice(cuda):
    from torch.profiler import ProfilerActivity, profile
    run = trainer.setup(_args("cuda", steps=2, **CARD))
    step = _captured(run)
    clouds, labels = (torch.from_numpy(a).to(cuda)
                      for a in next(run["data"].batches(CARD["batch"], 1)))
    reset_launch_counts()
    for _ in range(CudaGraphCall.WARMUP + 1):   # eager steps, the capture
        step(clouds, labels)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fps"] == counts["gather_rows_backward"] == \
        2 * (CudaGraphCall.WARMUP + 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(clouds, labels)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             for _ in range(e.count)]
    assert sum("fps_" in n and "kernel" in n for n in names) == 2
    assert sum("gather_rows_backward_kernel" in n for n in names) == 2
    assert launch_counts() == counts      # a replay moves no counter


@pytest.mark.cuda
def test_step_graphs_warm_up_with_real_steps_then_capture(cuda):
    """The first two calls per state and shapes run the step (each a real
    step on the state), the third captures it, later ones replay; another
    state, or other shapes, get a graph of their own."""
    calls = []

    def step(x):
        calls.append(1)
        state[0].add_(x)
        return state[0].sum()

    graphs = StepGraphs()
    state = [torch.zeros(4, device=cuda)]
    x = torch.ones(4, device=cuda)
    sums = [float(graphs(step, state, (x,))) for _ in range(5)]
    assert sums == [4.0, 8.0, 12.0, 16.0, 20.0]
    assert len(calls) == CudaGraphCall.WARMUP + 1 and len(graphs.graphs) == 1
    graphs(step, state, (torch.ones(2, 4, device=cuda)[0],))
    assert len(graphs.graphs) == 1              # the same shapes replay
    other = [torch.zeros(4, device=cuda)]
    graphs(step, other, (x,))
    assert len(graphs.graphs) == 2
