"""P4 on the card (``cuda`` marker; every test skips without a card): the
radix sort of ``csrc/gather_backward.cu`` ``torch.equal`` to
``segments()``, and the sums bit for bit ``gather_rows_backward_plain`` on
the same operands, on both paths (the fused launch, whose sort is in
shared memory, where a batch row fits there; the radix sort and the
segment sum elsewhere) and at their boundaries; the backward captured twice and replayed, bit for bit; and no
launch on the card's path but the port's own kernels. The file imports no
JAX, so it runs where there is none:

    python -m pytest -q -m cuda tests/test_torch_gather_backward_cuda.py

Tolerances: none. Each output element is the same additions in the same
order (left to right in increasing position from 0.0, ``__fadd_rn``) as
the plain version's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (launch_counts,                     # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.gather_backward import (                   # noqa: E402
    FUSED_MAX_POSITIONS, FUSED_MAX_ROWS, fused_fits, gather_rows_backward,
    gather_rows_backward_cuda, gather_rows_backward_fused_cuda,
    gather_rows_backward_plain, segments, segments_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _idx(lead, positions, n_rows, draw="all", seed=0):
    rng = np.random.default_rng(seed)
    if draw == "one":
        idx = np.full((lead, positions), n_rows // 2)
    elif draw == "zero":
        idx = np.zeros((lead, positions), dtype=np.int64)
    elif draw == "low":
        idx = rng.integers(0, 7, (lead, positions))
    elif draw == "zipf":
        idx = np.minimum(rng.zipf(1.3, (lead, positions)) - 1, n_rows - 1)
    else:
        idx = rng.integers(0, n_rows, (lead, positions))
    return idx.astype(np.int64)


#: (L, P, n_rows, draw): the main path's shapes (SA-2's neighbours and
#: centres at batch 16, qwen's embedding, llama4-scout's dispatch at 2 x
#: 1024 tokens), both backward paths' edges, and the boundary between
#: them. The radix sort runs at each; the fused launch sorts (in shared
#: memory) at those that :func:`fused_fits`.
SORT_CASES = {
    "sa2-neighbours": (16, 2048, 512, "all"),
    "sa2-centres": (16, 128, 512, "all"),
    "qwen-embedding": (1, 8192, 151936, "zipf"),
    "moe-dispatch": (1, 2048, 2048, "all"),
    "one-key-every-position-few-rows": (3, 3000, 40, "one"),
    "one-key-every-position-many-rows": (2, 5000, 9000, "one"),
    "every-key-row-0-many-rows": (1, 300, 151936, "zero"),
    "no-positions-few-rows": (4, 0, 9, "all"),
    "no-positions-many-rows": (4, 0, 9000, "all"),
    "one-row": (5, 17, 1, "all"),
    "many-batch-rows": (1000, 12, 6, "all"),
    "rows-below-the-fused-limit": (2, 700, FUSED_MAX_ROWS - 1, "all"),
    "rows-at-the-fused-limit": (2, 700, FUSED_MAX_ROWS, "all"),
    "rows-past-the-fused-limit": (2, 700, FUSED_MAX_ROWS + 1, "all"),
    "positions-at-the-fused-limit": (3, FUSED_MAX_POSITIONS, 300, "low"),
    "positions-past-the-fused-limit": (3, FUSED_MAX_POSITIONS + 1, 300,
                                       "low"),
    "three-radix-passes": (4, 3000, 2 ** 18, "all"),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_equals_segments(cuda, case):
    lead, positions, n_rows, draw = SORT_CASES[case]
    idx = torch.from_numpy(_idx(lead, positions, n_rows, draw)).to(cuda)
    reset_launch_counts()
    perm, starts = segments_cuda(idx, n_rows)
    want_perm, want_starts = segments(idx, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(perm, want_perm)
    assert torch.equal(starts, want_starts)
    counts = launch_counts()
    assert counts["segments_bounds"] == 1
    assert counts["segments_count"] == counts["segments_scatter"] >= \
        (1 if positions else 0)


@pytest.mark.parametrize("case", sorted(
    k for k, v in SORT_CASES.items() if fused_fits(*v[:3])))
def test_fused_launch_at_the_sort_cases(cuda, case):
    """The fused launch's shared-memory sort at the sort cases it takes,
    through its sum: bit for bit the plain version with random gradients
    (5 channels, scalar lanes), one launch."""
    lead, positions, n_rows, draw = SORT_CASES[case]
    idx, g = _operands(cuda, lead, positions, n_rows, 5, draw)
    reset_launch_counts()
    got = gather_rows_backward_fused_cuda(g, idx, n_rows)
    torch.cuda.synchronize()
    assert launch_counts()["gather_rows_backward"] == \
        (1 if got.numel() else 0)
    assert torch.equal(got, _plain(g, idx, n_rows))


def _operands(cuda, lead, positions, n_rows, c, draw="all", seed=0):
    idx = torch.from_numpy(_idx(lead, positions, n_rows, draw, seed)) \
        .to(cuda)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.normal(size=(lead * positions, c))
                         .astype(np.float32)).to(cuda)
    return idx, g


def _plain(g, idx, n_rows):
    return gather_rows_backward_plain(g, *segments(idx, n_rows))


#: (L, P, n_rows, draw) of each path at a few widths: fused (SA-2-like,
#: and MoE-like at L = 1) and radix (past the fused rows).
SUM_SHAPES = {"fused": (4, 512, 200, "all"), "fused-moe": (1, 1024, 900,
                                                             "all"),
              "radix": (2, 600, FUSED_MAX_ROWS + 1000, "low")}


@pytest.mark.parametrize("c", [1, 5, 128, 1024, 5120])
@pytest.mark.parametrize("shape", sorted(SUM_SHAPES))
def test_sum_bitwise_against_plain(cuda, shape, c):
    lead, positions, n_rows, draw = SUM_SHAPES[shape]
    idx, g = _operands(cuda, lead, positions, n_rows, c, draw)
    reset_launch_counts()
    got = gather_rows_backward(g.view(lead, positions, c), idx, n_rows)
    torch.cuda.synchronize()
    assert launch_counts()["gather_rows_backward"] == 1
    want = _plain(g, idx, n_rows).view(lead, n_rows, c)
    assert torch.equal(got, want)
    # the sum alone on the card's own radix sort, and the fused launch
    got = gather_rows_backward_cuda(g, *segments_cuda(idx, n_rows))
    assert torch.equal(got.view(lead, n_rows, c), want)
    if shape != "radix":
        got = gather_rows_backward_fused_cuda(g, idx, n_rows)
        assert torch.equal(got.view(lead, n_rows, c), want)


@pytest.mark.parametrize("c", [5, 128, 260])
@pytest.mark.parametrize("n_rows", [40, FUSED_MAX_ROWS + 10])
def test_a_segment_longer_than_the_loads_in_flight(cuda, n_rows, c):
    """One row takes 1000 positions (more than 32 perm entries, more than
    16 loads in flight) beside rows with a few, on both paths."""
    idx, g = _operands(cuda, 2, 1500, n_rows, c)
    idx[:, :1000] = 3
    got = gather_rows_backward(g.view(2, 1500, c), idx, n_rows)
    assert torch.equal(got.view(-1, c), _plain(g, idx, n_rows))


def test_unaligned_gradient_takes_scalar_lanes(cuda):
    """A gradient whose data pointer is not 16-byte aligned (C % 4 == 0):
    both sums read it with scalar lanes, bit for bit."""
    lead, positions, c = 2, 300, 64
    idx, g = _operands(cuda, lead, positions, 50, c)
    buf = torch.empty(g.numel() + 1, device=cuda)
    shifted = buf[1:].view(lead * positions, c)
    shifted.copy_(g)
    assert shifted.data_ptr() % 16 != 0
    for n_rows in (50, FUSED_MAX_ROWS + 1):
        want = _plain(g, idx, n_rows)
        got = gather_rows_backward(shifted.view(lead, positions, c), idx,
                                   n_rows)
        assert torch.equal(got.view(-1, c), want)


def test_embedding_like_shape_at_reduced_vocabulary(cuda):
    """qwen's embedding gradient as the LM step makes it (2 x 4096 zipf
    tokens, 1024 channels) into 20000 rows: the radix path."""
    idx, g = _operands(cuda, 1, 8192, 20000, 1024, "zipf")
    assert not fused_fits(1, 8192, 20000)
    got = gather_rows_backward(g[None], idx, 20000)
    assert torch.equal(got[0], _plain(g, idx, 20000))


@pytest.mark.parametrize("n_rows", [512, 20000])
def test_two_captures_replay_bit_for_bit(cuda, n_rows):
    """The backward captured twice into CUDA graphs (no host read, scratch
    sized by the shapes alone) and each replayed: every replay bit for bit
    the eager call and the plain version."""
    lead, positions, c = 4, 2048, 128
    idx, g = _operands(cuda, lead, positions, n_rows, c, "zipf")
    g3 = g.view(lead, positions, c)
    eager = gather_rows_backward(g3, idx, n_rows)
    assert torch.equal(eager.view(-1, c), _plain(g, idx, n_rows))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather_rows_backward(g3, idx, n_rows)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(gather_rows_backward(g3, idx, n_rows))
        graphs.append(graph)
    for _ in range(2):
        for graph, out in zip(graphs, outs):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.parametrize("n_rows", [512, 151936])
def test_the_cards_path_launches_only_the_ports_kernels(cuda, n_rows):
    """One backward on the card, profiled: no ``torch.sort``,
    ``searchsorted`` or ``arange`` (no kernel but the port's), and one
    segment sum."""
    from torch.profiler import ProfilerActivity, profile
    idx, g = _operands(cuda, 1, 2048, n_rows, 128, "zipf")
    gather_rows_backward(g[None], idx, n_rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gather_rows_backward(g[None], idx, n_rows)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() for _ in range(e.count)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("gather_rows_backward_kernel" in n
                         or "segments_" in n for n in names), names
    assert sum("gather_rows_backward_kernel" in n for n in names) == 1
