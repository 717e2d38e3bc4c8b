"""Roofline analysis of the LM stack's steps on the H100: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

Hardware model (:data:`HW`): one H100 SXM5 80GB. The peaks are NVIDIA's
spec-sheet figures (dense, at 700 W), not measurements: bf16 989 TFLOP/s on
the tensor cores (:data:`PEAK_FLOPS`), float32 67 TFLOP/s
(:data:`FP32_FLOPS`), HBM3 3.35 TB/s (:data:`HBM_BW`). The link
(:data:`LINK_BW`) is the network between nodes: the production meshes'
'model' axis of 16 spans two 8-card nodes, so a ring over it runs at the
rate of one card's InfiniBand NDR port, 400 Gb/s = 50 GB/s each way (one
ConnectX-7 a card, as in a DGX H100), not NVLink 4's 450 GB/s each way
within a node. :data:`HBM_PER_CHIP` is the device memory that
``torch.cuda.get_device_properties(0).total_memory`` reports on an H100
80GB HBM3 at 700 W (``chip_smoke.py``, phase ``dryrun``).

:func:`model_flops` (the analytic operations of a cell) and
:func:`roofline` (its three terms) are the reference's arithmetic, the
latter with the card as ``hw``. :func:`lm_prefill_flops`,
:func:`lm_decode_bytes` and :func:`lm_train_flops` are the bounds that
``chip_smoke.py`` prints beside its measured LM times.

The reference reads a step's costs off XLA's compiled HLO text
(``analyze_hlo``, ``parse_collectives``, ``scan_trip_counts``,
``_fusion_io_bytes``). The port compiles nothing: it runs its steps
eagerly, one kernel an op, and its collectives are calls of
``torch.distributed``. Those four have no counterpart here. In their place
:class:`StepCounter` counts one step as it runs, typically on ``meta``
tensors as rank 0 of a fake process group (``launch/dryrun.py``), where
every op is shapes only and every collective returns at once:

- operations, by ``torch.utils.flop_counter.FlopCounterMode`` (the
  matrix products' and convolutions' multiply-adds, 2 each);
- bytes: the input and output bytes of every op that does not return a
  view of its input (nor only allocates); an op in place reads and writes
  its destination. No op is fused in the eager
  port, so each op's operands cross HBM: this is the port's HBM traffic
  as it runs, not the least the step could move;
- collective bytes and calls by op, from the c10d ops' result tensors as
  the reference counts them from HLO result types: ``all-gather``,
  ``reduce-scatter``, ``all-reduce``, ``all-to-all``, and point-to-point
  sends and receives as ``collective-permute``;
- the most bytes alive at once (``peak_bytes``): the arguments given to
  :meth:`StepCounter.arguments` (the rank's state or parameter shards,
  caches and batch shard) and every storage an op allocates, each freed
  when its storage is, tracked by weak references.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HW", "PEAK_FLOPS", "FP32_FLOPS", "HBM_BW", "LINK_BW",
           "HBM_PER_CHIP", "roofline", "model_flops", "lm_decode_bytes",
           "lm_prefill_flops", "lm_train_flops", "StepCounter",
           "COLLECTIVES", "tree_bytes"]

#: H100 SXM5 bf16 dense tensor-core peak, FLOP/s (NVIDIA spec sheet, 700 W)
PEAK_FLOPS = 989e12
#: H100 SXM5 float32 peak (no tensor cores), FLOP/s (spec sheet)
FP32_FLOPS = 67e12
#: H100 SXM5 HBM3 bandwidth, B/s (spec sheet)
HBM_BW = 3.35e12
#: one card's InfiniBand NDR port between nodes, B/s each way (400 Gb/s;
#: spec sheet): the slowest link of a 16-rank ring over two 8-card nodes
LINK_BW = 50e9
#: device memory of an H100 80GB HBM3 (700 W), bytes, as
#: ``torch.cuda.get_device_properties(0).total_memory`` reports it
HBM_PER_CHIP = 85_017_493_504
HW = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, link_bw=LINK_BW,
          hbm_bytes=HBM_PER_CHIP)


def roofline(*, flops_per_device: float, bytes_per_device: float,
             collective_bytes_per_device: float, chips: int,
             model_flops_global: float, hw: dict | None = None) -> dict:
    """Three roofline terms (seconds) + bottleneck + useful-compute ratio,
    on ``hw`` (:data:`HW` unless given: a dict with ``peak_flops``,
    ``hbm_bw`` and ``link_bw``)."""
    hw = HW if hw is None else hw
    t_compute = flops_per_device / hw["peak_flops"]
    t_memory = bytes_per_device / hw["hbm_bw"]
    t_collective = collective_bytes_per_device / hw["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    bottleneck = max(terms, key=terms.get)
    hlo_flops_global = flops_per_device * chips
    return {
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "model_flops_global": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": (model_flops_global / hlo_flops_global
                         if hlo_flops_global else float("nan")),
        "bound_step_time_s": max(terms.values()),
        "roofline_fraction": (
            t_compute / max(terms.values()) if max(terms.values()) else 0.0),
    }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for one step of (arch, shape):
       train   : 6 * N_active * tokens  + attention term
       prefill : 2 * N_active * tokens  + attention term
       decode  : 2 * N_active * batch   + cache-read attention term
    Attention term (causal): 2 * 2 * 0.5 * L_attn * S^2 * H * Dh * B per
    forward; x3 for train (fwd+bwd). SSM/RWKV state math adds
    ~10 * B*S*H*K*V per layer (projections already in N)."""
    n_act = cfg.n_active_params()
    s, b = shape.seq_len, shape.global_batch
    tokens = s * b
    h, dh = cfg.eff_heads, cfg.head_dim
    if cfg.family == "hybrid":
        l_attn = cfg.n_layers // cfg.attn_interval
    elif cfg.family == "ssm":
        l_attn = 0
    elif cfg.family == "vlm":
        l_attn = cfg.n_layers  # + cross handled below
    else:
        l_attn = cfg.n_layers

    def attn_fwd(ctx):
        return 2.0 * ctx * h * dh * l_attn  # per query token, qk+pv, causal

    extra = 0.0
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_interval
        extra = 4.0 * cfg.n_image_tokens * h * dh * g   # per query token
    if cfg.family in ("hybrid", "ssm"):
        hs = 64 if cfg.family == "hybrid" else cfg.head_size
        nh = (2 * cfg.d_model // 64 if cfg.family == "hybrid"
              else cfg.d_model // cfg.head_size)
        state_n = cfg.ssm_state if cfg.family == "hybrid" else hs
        extra += 10.0 * nh * hs * state_n * cfg.n_layers

    if shape.kind == "train":
        return 6.0 * n_act * tokens + 3.0 * tokens * (attn_fwd(s / 2) + extra)
    if shape.kind == "prefill":
        return 2.0 * n_act * tokens + tokens * (attn_fwd(s / 2) + extra)
    # decode: context = full cache
    return 2.0 * n_act * b + b * (attn_fwd(s) + extra)


# ---------------------------------------------------------------------------
# the bounds chip_smoke.py prints beside its LM times
# ---------------------------------------------------------------------------

def _attention_applications(cfg) -> int:
    """Self-attention layers a token passes: the hybrid's one shared block
    once per group of ``attn_interval`` Mamba layers, none in RWKV."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_interval
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def _expert_weights(cfg) -> int:
    """One expert's gate, up and down weights."""
    return 3 * cfg.d_model * cfg.d_ff


def lm_decode_bytes(cfg, batch: int, positions: int,
                    routed_experts: int | None = None) -> int:
    """Bytes one decode step must move at least: every weight read once
    (``ArchConfig.n_params()``; the tied embedding once, for the logits);
    for moe the non-expert weights and only ``routed_experts`` experts'
    (summed over the layers: the experts the step's tokens route to), not
    all of them; ``positions`` cached rows of each attention application's
    keys and values for each of ``batch`` sequences (the hybrid's shared
    block applied ``n_layers // attn_interval`` times, RWKV none); and the
    state-space families' decode state read once and written once: the
    float32 SSM and RWKV states, the conv and token-shift rows in the
    model's dtype."""
    esize = torch.empty((), dtype=cfg.jdtype).element_size()
    weights = cfg.n_params()
    if cfg.family == "moe":
        if routed_experts is None:
            raise ValueError("a moe step's bytes need its routed experts")
        weights += (routed_experts - cfg.n_layers * cfg.n_experts) \
            * _expert_weights(cfg)
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * esize
    nbytes = weights * esize \
        + batch * positions * _attention_applications(cfg) * kv_row
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.head_size
        state = h * cfg.head_size ** 2 * 4 + 2 * cfg.d_model * esize
        nbytes += 2 * cfg.n_layers * batch * state
    elif cfg.family == "hybrid":
        from repro_torch.models.ssm import CONV_K
        h = 2 * cfg.d_model // 64
        state = h * 64 * cfg.ssm_state * 4 \
            + (CONV_K - 1) * (2 * cfg.d_model + 2 * cfg.ssm_state) * esize
        nbytes += 2 * cfg.n_layers * batch * state
    return nbytes


def lm_prefill_flops(cfg, batch: int, seq: int) -> int:
    """Operations (2 a multiply-add) a prefill of ``batch`` x ``seq`` must
    do: every block weight once a token (moe: only the routed experts',
    ``n_active_params``; the hybrid's shared block once per application),
    the LM head for the last position only (the port's prefill computes no
    other logits), and causal attention's QK and PV over the position
    pairs i >= j of each attention application. The state-space
    recurrences' own operations (float32, a few per state element and
    token) are not counted: the bound stays a lower one."""
    heads = 1 if cfg.tie_embeddings else 2
    weights = (cfg.n_active_params() if cfg.family == "moe"
               else cfg.n_params())
    blocks = weights - heads * cfg.vocab_size * cfg.d_model
    if cfg.family == "hybrid":
        d, dh = cfg.d_model, cfg.head_dim
        shared = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh \
            + cfg.n_heads * dh * d + 3 * d * cfg.d_ff
        blocks += (_attention_applications(cfg) - 1) * shared
    pairs = seq * (seq + 1) // 2
    attention = 2 * 2 * _attention_applications(cfg) * batch * cfg.n_heads \
        * cfg.head_dim * pairs
    return (2 * blocks * batch * seq + 2 * cfg.vocab_size * cfg.d_model
            * batch + attention)


def _padded(n: int, chunk: int) -> int:
    return -(-n // chunk) * chunk


def _causal_chunk_pairs(seq: int, qc: int, kc: int) -> int:
    """Query and key chunk pairs of a causal mask over ``seq`` tokens that
    hold a query at or after a key: the pairs that need computing."""
    return sum(1 for i in range(-(-seq // qc)) for j in range(-(-seq // kc))
               if j * kc <= min((i + 1) * qc, seq) - 1)


def lm_train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations (2 a multiply-add) of one training step: the bf16 GEMMs
    as 6 x (active) parameters x tokens, and, listed apart, attention's
    products over the chunk pairs the causal mask leaves (whole chunks),
    once per attention application (the hybrid's shared block once per
    group; the sequence first padded to the Mamba2 chunk there): the four
    with bf16 operands (the forward's QK and PV, the backward's recomputed
    QK and dP; float32 accumulation, at the bf16 tensor-core rate) and the
    three with a float32 operand (dV from float32 probabilities, dQ and dK
    from float32 ``ds``; at float32's rate)."""
    from repro_torch.models import ssm
    s = _padded(seq, ssm.CHUNK) if cfg.family == "hybrid" else seq
    qc, kc = min(cfg.q_chunk, s), min(cfg.kv_chunk, s)
    product = 2 * batch * cfg.n_heads * qc * kc * cfg.head_dim \
        * _causal_chunk_pairs(s, qc, kc) * _attention_applications(cfg)
    gemm = 6 * cfg.n_active_params() * batch * seq
    ms = {"gemm_ms": 1e3 * gemm / PEAK_FLOPS,
          "attention_bf16_ms": 1e3 * 4 * product / PEAK_FLOPS,
          "attention_f32_ms": 1e3 * 3 * product / FP32_FLOPS}
    return {"gemm_flops": gemm, "attention_bf16_flops": 4 * product,
            "attention_f32_flops": 3 * product, **ms,
            "step_ms": sum(ms.values())}


# ---------------------------------------------------------------------------
# counting a step as it runs
# ---------------------------------------------------------------------------

#: the HLO names the reference counts, by c10d op
COLLECTIVES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def _tensors(x) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts)."""
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


class _Tally(TorchDispatchMode):
    """Every aten and c10d op: its bytes, its collectives, and the
    storages it allocates (alive until their storages die)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.coll_bytes = {}
        self.coll_counts = {}
        self.alive = self.peak = 0
        self._seen = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as alive until it is freed (once)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.alive += n
        self.peak = max(self.peak, self.alive)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.alive -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "c10d":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                # the result tensor: the output buffer where the op takes
                # one (gather, reduce-scatter, all-to-all), else the
                # tensors it reduces or sends in place
                res = _tensors(args[0])
                n = sum(_nbytes(t) for t in res)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            return out
        aliases = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in aliases):
            return out          # a view: no bytes, no storage
        outs = _tensors(out)
        if all(a is None for a in aliases):
            for t in outs:      # not in place: new storages
                self.track(t)
        if not name.startswith(("empty", "new_empty")):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))
                              + outs)
        return out


class StepCounter:
    """Counts what runs inside ``with StepCounter() as c:`` (module
    docstring). :meth:`arguments` registers the step's inputs (tensors or
    trees of them, DTensors by their local shards) as alive and as its
    argument bytes, both by the storages they live in (a view counts the
    whole storage it views, once); :meth:`outputs` its
    results' bytes (those not among the arguments: a state or cache
    updated in place is not an output); :meth:`result` the counts."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._tally = _Tally()
        self.argument_bytes = 0
        self.output_bytes = 0
        self._args = set()

    def __enter__(self):
        self._flops.__enter__()
        self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def arguments(self, *trees) -> None:
        for t in _tensors(trees):
            st = _local(t).untyped_storage()
            if st._cdata not in self._args:
                self._args.add(st._cdata)
                self.argument_bytes += st.nbytes()
            self._tally.track(_local(t))

    def outputs(self, *trees) -> None:
        for t in _tensors(trees):
            t = _local(t)
            if t.untyped_storage()._cdata not in self._args:
                self.output_bytes += _nbytes(t)

    def result(self) -> dict:
        """``{"flops", "bytes", "ops", "collectives": {"bytes_by_op",
        "counts", "total_bytes"}, "argument_bytes", "output_bytes",
        "peak_bytes"}``, per device (this rank)."""
        ta = self._tally
        by_op = {k: ta.coll_bytes.get(k, 0)
                 for k in ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute")}
        counts = {k: ta.coll_counts.get(k, 0) for k in by_op}
        return {"flops": int(self._flops.get_total_flops()),
                "bytes": ta.bytes, "ops": ta.ops,
                "collectives": {"bytes_by_op": by_op, "counts": counts,
                                "total_bytes": sum(by_op.values())},
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "peak_bytes": ta.peak}


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (DTensors: their local shards)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))

