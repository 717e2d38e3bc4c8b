"""The reliability path in the port against the JAX package: ECC encode,
decode and overhead bit for bit; ``FaultModel``'s transform bit for bit on
the reference's own draws (noise: equal except on cells within 2^-20 of a
half-integer before rounding, where XLA may contract ``g + sigma * noise``
into an FMA, counted); whole-model logits bit for bit given the reference's
faulted and corrected programs on every fused backend, and a faulted
'reram' layer given the reference's draws for its site; the port's own
protect-inject-correct pipeline on those draws equal to the reference's
programs; the zero-fault model and protected programs bit for bit
the ideal model's; ``stats()["reliability"]`` as the reference's; the
Pareto harness on the port alone (the reference's own sweep test fails
under the installed JAX), its front and archetypes as the reference's on
the same points.

Shapes are the JAX suite's ``tiny_config`` (``tests/test_reliability.py``)
and small programs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                       # noqa: E402
import repro_torch                                                 # noqa: E402
from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.kernels import CrossbarProgram as JProgram             # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro.reliability import ecc as jecc                          # noqa: E402
from repro.reliability import pareto as jpareto                    # noqa: E402
from repro.reliability import FaultModel as JFault                 # noqa: E402
from repro_torch.convert import params_from_numpy                  # noqa: E402
from repro_torch.core.workload import PointNetConfig, SALayerSpec  # noqa: E402
from repro_torch.kernels import CrossbarProgram, build_program     # noqa: E402
from repro_torch.reliability import (ArchetypeBands, DesignPoint,  # noqa: E402
                                     EccConfig, EccLayerLayout, EccSpec,
                                     FaultModel, classify_archetypes,
                                     correct_model_program,
                                     correct_program, ecc_overhead,
                                     pareto_front, protect_program, sweep)
from repro_torch.reliability import ecc as tecc                    # noqa: E402
from repro_torch.reliability.faults import (FaultDraws,            # noqa: E402
                                            fault_transform)

CROSSBAR_BACKENDS = ("reram-fused", "reram-fused-mtiled",
                     "reram-fused-wstat")


def tiny_config(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_config(JConfig, JSpec)
    cfg_t = tiny_config(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    return cfg_j, cfg_t, jparams, tparams, clouds


def _layers(widths=(24, 48, 130, 10), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(k, n)).astype(np.float32),
             rng.normal(size=(n,)).astype(np.float32))
            for k, n in zip(widths[:-1], widths[1:])]


def _port(widths=(24, 48, 130, 10), seed=0):
    return build_program([(torch.from_numpy(w), torch.from_numpy(b))
                          for w, b in _layers(widths, seed)])


def to_jax(tp: CrossbarProgram) -> JProgram:
    """A bare port program as the JAX package's (the two build programs
    bit for bit alike: ``tests/test_torch_program.py``)."""
    j = lambda t: jnp.asarray(t.numpy())
    return JProgram(j(tp.planes), j(tp.bias), j(tp.w_scale), j(tp.col_mask),
                    tp.widths, tp.weight_bits, tp.cell_bits)


def _pair(widths=(24, 48, 130, 10), seed=0):
    tp = _port(widths, seed)
    return to_jax(tp), tp


#: The reference's ECC transforms, jitted (one compile each instead of an
#: eager compile per operation; the integer results are the same).
_j_protect = jax.jit(jecc.protect_program, static_argnums=1)
_j_correct = jax.jit(jecc.correct_program)


def _port_spec(spec):
    if spec is None:
        return None
    return EccSpec(group=spec.group, layouts=tuple(
        EccLayerLayout(**dataclasses.asdict(l)) for l in spec.layouts))


def to_port(jp) -> CrossbarProgram:
    """A JAX package program as the port's, through NumPy."""
    t = lambda a: torch.from_numpy(np.array(a))
    return CrossbarProgram(t(jp.planes), t(jp.bias), t(jp.w_scale),
                           t(jp.col_mask), jp.widths, jp.weight_bits,
                           jp.cell_bits, ecc=_port_spec(jp.ecc))


def _same_program(got: CrossbarProgram, want):
    for name in ("planes", "bias", "w_scale", "col_mask"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert got.widths == want.widths
    assert got.ecc == _port_spec(want.ecc)


# ---------------------------------------------------------------------------
# FaultModel
# ---------------------------------------------------------------------------

def test_fault_model_validation_equals_jax():
    for kw in ({"sigma": -0.1}, {"p_stuck0": 1.5}, {"p_stuck1": -0.1},
               {"adc_bits": 0}):
        with pytest.raises(ValueError) as want:
            JFault(**kw)
        with pytest.raises(ValueError) as got:
            FaultModel(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{}, {"adc_bits": 2}, {"adc_bits": 1},
                                {"sigma": 0.1}, {"p_stuck0": 0.5},
                                {"p_stuck1": 0.5}, {"adc_bits": 8}])
def test_ideal_flags_equal_jax(kw):
    a, b = FaultModel(**kw), JFault(**kw)
    assert a.is_ideal == b.is_ideal
    for cell_bits in (1, 2, 3):
        assert a.is_ideal_for(cell_bits) == b.is_ideal_for(cell_bits)


def test_zero_fault_model_returns_the_program_itself():
    prog = _port()
    assert FaultModel().apply(prog) is prog
    assert FaultModel(adc_bits=2).apply(prog) is prog
    progs = {"sa": [prog], "head": prog}
    out = FaultModel().apply_model_program(progs)
    assert out["sa"][0] is prog and out["head"] is prog


def test_fault_injection_seeded_and_deterministic():
    prog = _port()
    fm = FaultModel(p_stuck0=0.05, sigma=0.2, seed=3)
    a, b = fm.apply(prog), fm.apply(prog)
    assert torch.equal(a.planes, b.planes)
    assert not torch.equal(a.planes, prog.planes)
    other = FaultModel(p_stuck0=0.05, sigma=0.2, seed=4).apply(prog)
    assert not torch.equal(a.planes, other.planes)
    site = fm.apply(prog, (1,))
    assert not torch.equal(site.planes, a.planes)
    d1, d2 = fm.draw((4, 5, 6), 2, 1), fm.draw((4, 5, 6), 2, 1)
    assert all(torch.equal(x, y) for x, y in zip(d1[:2], d2[:2]))
    assert d1.u_stuck1 is None                 # p_stuck1 = 0: no draw


def _reference_draws(key, shape):
    k_noise, k_s0, k_s1 = jax.random.split(key, 3)
    t = lambda a: torch.from_numpy(np.array(a))
    return (FaultDraws(t(jax.random.normal(k_noise, shape)),
                       t(jax.random.uniform(k_s0, shape)),
                       t(jax.random.uniform(k_s1, shape))), k_noise)


@pytest.mark.parametrize("kw", [
    {"p_stuck0": 0.1}, {"p_stuck1": 0.1}, {"p_stuck0": 0.2, "p_stuck1": 0.3},
    {"adc_bits": 1}, {"adc_bits": 1, "p_stuck1": 0.05},
    {"p_stuck0": 1.0}, {"p_stuck1": 1.0}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_transform_on_reference_draws_bitwise(kw):
    planes = jnp.asarray(np.random.default_rng(0).integers(
        0, 4, size=(4, 64, 130)), jnp.int8)
    key = jax.random.PRNGKey(7)
    want = JFault(**kw).transform_planes(planes, key)
    draws, _ = _reference_draws(key, planes.shape)
    got = FaultModel(**kw).transform_planes(
        torch.from_numpy(np.array(planes)), draws)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), np.asarray(planes))


@pytest.mark.parametrize("sigma", [0.1, 0.3, 0.7, 5.0])
def test_noise_on_reference_draws_equal_but_near_ties(sigma):
    planes = jnp.asarray(np.random.default_rng(1).integers(
        0, 4, size=(4, 128, 130)), jnp.int8)
    key = jax.random.PRNGKey(11)
    fm_kw = {"sigma": sigma, "p_stuck0": 0.01, "p_stuck1": 0.01,
             "adc_bits": 1 if sigma == 5.0 else None}
    want = np.asarray(JFault(**fm_kw).transform_planes(planes, key))
    draws, _ = _reference_draws(key, planes.shape)
    got = FaultModel(**fm_kw).transform_planes(
        torch.from_numpy(np.array(planes)), draws).numpy()
    # the level before rounding, product and sum each rounded to float32
    g = (np.asarray(planes, np.float32)
         + np.float32(sigma) * draws.noise.numpy()).astype(np.float32)
    near = np.abs(np.abs(g - np.floor(g)) - 0.5) <= 2.0 ** -20
    diff = got != want
    assert not (diff & ~near).any()
    assert diff.sum() <= near.sum()


def test_fault_transform_is_pure_and_in_the_cell_domain():
    planes = torch.full((4, 16, 16), 2, dtype=torch.int8)
    draws = FaultModel(sigma=5.0, p_stuck0=0.5).draw(planes.shape, 0)
    kw = {"sigma": 5.0, "p_stuck0": 0.5, "p_stuck1": 0.0, "adc_bits": None}
    a, b = (fault_transform(planes, draws, **kw),
            fault_transform(planes, draws, **kw))
    assert torch.equal(a, b) and torch.equal(planes, torch.full_like(a, 2))
    assert a.dtype == torch.int8 and int(a.min()) >= 0 and int(a.max()) <= 3


def test_apply_model_program_sites_equal_jax_folding():
    """The port keys MLP i at site (i + 1,) and the head at (0,), the
    reference's fold-in order: given the reference's per-site draws the
    whole-model programs are equal."""
    jp, tp = _pair()
    fmj = JFault(p_stuck0=0.05, p_stuck1=0.05, seed=5)
    fmt = FaultModel(p_stuck0=0.05, p_stuck1=0.05, seed=5)
    want = jax.jit(fmj.apply_model_program)({"sa": [jp, jp], "head": jp})
    base = fmj.base_key()
    for ix, got_prog in ((1, None), (2, None), (0, None)):
        draws, _ = _reference_draws(jax.random.fold_in(base, ix),
                                    jp.planes.shape)
        got = fmt.transform_planes(tp.planes, draws)
        ref = want["head"] if ix == 0 else want["sa"][ix - 1]
        assert np.array_equal(got.numpy(), np.asarray(ref.planes))


# ---------------------------------------------------------------------------
# ECC
# ---------------------------------------------------------------------------

def test_hamming_code_tables_equal_jax():
    for k in range(1, 70):
        r = tecc.hamming_r(k)
        assert r == jecc.hamming_r(k)
        assert np.array_equal(tecc._data_positions(k, r),
                              jecc._data_positions(k, r))
        assert np.array_equal(tecc._parity_matrix(k, r),
                              jecc._parity_matrix(k, r))
    for bad in (0, -3):
        with pytest.raises(ValueError, match="data bit"):
            tecc.hamming_r(bad)
    with pytest.raises(ValueError, match="group"):
        EccConfig(group=0)


@pytest.mark.parametrize("widths,group", [
    ((24, 48, 130, 10), 16), ((24, 48, 130, 10), 4), ((24, 48, 130, 10), 1),
    ((16, 120, 64), 4), ((40, 40), 3), ((100, 256, 40), 16)])
def test_protect_program_equals_jax(widths, group):
    jp, tp = _pair(widths)
    want = _j_protect(jp, jecc.EccConfig(group))
    got = protect_program(tp, EccConfig(group))
    _same_program(got, want)
    assert got.d_pad == want.d_pad
    assert ecc_overhead(got) == jecc.ecc_overhead(want)
    assert torch.equal(tp.planes, _port(widths).planes)   # not mutated
    assert build_program(
        [(torch.from_numpy(w), torch.from_numpy(b))
         for w, b in _layers(widths)], ecc=EccConfig(group)).planes.equal(
        got.planes)


def test_protect_default_and_errors_equal_jax():
    jp, tp = _pair()
    _same_program(protect_program(tp), _j_protect(jp, jecc.EccConfig()))
    prot = protect_program(tp)
    with pytest.raises(ValueError, match="already ECC-protected"):
        protect_program(prot)
    for fn in (correct_program, ecc_overhead):
        with pytest.raises(ValueError, match="no ECC spec"):
            fn(tp)


@pytest.mark.parametrize("group", [16, 4])
def test_correct_program_on_faulted_planes_equals_jax(group):
    jp, tp = _pair()
    jprot = _j_protect(jp, jecc.EccConfig(group))
    fmj = JFault(p_stuck0=0.02, p_stuck1=0.02, sigma=0.2, seed=9)
    key = jax.random.PRNGKey(9)
    jfault = jax.jit(fmj.apply)(jprot, key)
    draws, _ = _reference_draws(key, jprot.planes.shape)
    tprot = protect_program(tp, EccConfig(group))
    tfault = tprot.replace(planes=FaultModel(
        p_stuck0=0.02, p_stuck1=0.02, sigma=0.2).transform_planes(
        tprot.planes, draws))
    assert np.array_equal(tfault.planes.numpy(), np.asarray(jfault.planes))
    _same_program(correct_program(tfault), _j_correct(jfault))
    # a clean protected program round-trips bit for bit
    assert torch.equal(correct_program(tprot).planes, tprot.planes)
    progs = {"sa": [tfault, tp], "head": tfault}
    fixed = correct_model_program(progs)
    assert fixed["sa"][1] is tp
    assert torch.equal(fixed["head"].planes, correct_program(tfault).planes)


def test_ecc_corrects_every_single_cell_fault_in_a_codeword():
    tp = _port((24, 48, 130, 10))
    prot = protect_program(tp, EccConfig(group=8))
    lay = prot.ecc.layouts[1]
    cols = list(range(lay.k)) + list(range(
        lay.parity_start, lay.parity_start + lay.r))
    for col in cols:
        for level in range(4):
            bad = prot.planes.clone()
            bad[1, 2, 5, col] = level
            assert torch.equal(correct_program(prot.replace(
                planes=bad)).planes, prot.planes), (col, level)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

#: The whole-model fault model of the comparisons below.
FAULTS = {"p_stuck0": 0.05, "p_stuck1": 0.05, "seed": 7}


@pytest.fixture(scope="module")
def reference_programs(setup):
    """The reference's faulted-and-corrected whole-model programs, raw and
    under ECC at group 4 — its compile path (protect, inject, correct:
    ``repro/models/backend.py:262-281``) with the reference's own
    functions, jitted to keep the test short — and its compiled model on
    each and logits on the first cloud."""
    cfg_j, _, jparams, _, clouds = setup
    fm = JFault(**FAULTS)
    from repro_torch.models.pointnet2 import build_model_program
    tprogs = build_model_program(setup[3])
    programs = {"sa": [to_jax(p) for p in tprogs["sa"]],
                "head": to_jax(tprogs["head"])}
    protect = jax.jit(lambda q: jecc.protect_program(q, jecc.EccConfig(4)))
    inject = jax.jit(lambda ps: jecc.correct_model_program(
        fm.apply_model_program(ps)))
    out = {}
    for label, progs in (("raw", programs),
                         ("ecc4", {"sa": [protect(q) for q in programs["sa"]],
                                   "head": protect(programs["head"])})):
        faulted = inject(progs)
        m = repro.compile_model(jparams, cfg_j, backend="reram-fused",
                                program=faulted)
        out[label] = (faulted, np.asarray(m.forward(jnp.asarray(clouds[0]))),
                      m)
    return out


@pytest.mark.parametrize("backend", CROSSBAR_BACKENDS)
@pytest.mark.parametrize("label", ["raw", "ecc4"])
def test_logits_on_the_references_faulted_programs_bitwise(
        setup, reference_programs, backend, label):
    _, cfg_t, _, tparams, clouds = setup
    jprog, want, _ = reference_programs[label]
    program = {"sa": [to_port(p) for p in jprog["sa"]],
               "head": to_port(jprog["head"])}
    model = repro_torch.compile_model(tparams, cfg_t, backend=backend,
                                      program=program, device="cpu")
    assert np.array_equal(model.forward(clouds[0]).numpy(), want)
    batched = model.batched_forward(clouds)
    assert torch.equal(batched[0], model.forward(clouds[0]))


@pytest.mark.parametrize("label", ["raw", "ecc4"])
def test_port_pipeline_on_the_references_draws_equals_jax(
        setup, reference_programs, label):
    """The port's protect -> inject -> correct, given the reference's
    draws for each MLP's site, gives the reference's programs."""
    _, cfg_t, _, tparams, _ = setup
    from repro_torch.models.pointnet2 import build_model_program
    progs = build_model_program(tparams, ecc=None if label == "raw"
                                else EccConfig(4))
    fm, jfm = FaultModel(**FAULTS), JFault(**FAULTS)
    base = jfm.base_key()
    faulted = {"sa": [], "head": None}
    for ix, prog in [(i + 1, p) for i, p in enumerate(progs["sa"])] + [
            (0, progs["head"])]:
        draws, _ = _reference_draws(jax.random.fold_in(base, ix),
                                    tuple(prog.planes.shape))
        out = prog.replace(planes=fm.transform_planes(prog.planes, draws))
        if ix:
            faulted["sa"].append(out)
        else:
            faulted["head"] = out
    fixed = correct_model_program(faulted)
    want = reference_programs[label][0]
    for got, ref in zip(fixed["sa"] + [fixed["head"]],
                        want["sa"] + [want["head"]]):
        _same_program(got, ref)


def test_reram_linear_on_the_references_draws_bitwise():
    """One 'reram' layer (``reram_linear(fault_model=, fault_key=)``):
    faults on the encoded ``(P, K, N)`` planes before the product, equal
    to the reference's given its draws for the site."""
    from repro.kernels.ops import reram_linear as j_reram_linear
    from repro_torch.kernels.ops import reram_linear
    rng = np.random.default_rng(3)
    x = rng.normal(size=(37, 48)).astype(np.float32)
    w = rng.normal(size=(48, 20)).astype(np.float32)
    b = np.zeros(20, np.float32)
    for kw in ({"p_stuck0": 0.1, "p_stuck1": 0.05}, {"adc_bits": 1}):
        jfm = JFault(seed=2, **kw)
        key = jfm.key_for(1, 2)
        want = np.asarray(j_reram_linear(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), fault_model=jfm,
                                         fault_key=key))
        draws, _ = _reference_draws(key, (4, 48, 20))
        got = reram_linear(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), fault_model=FaultModel(
                               seed=2, **kw), fault_key=draws)
        assert np.array_equal(got.numpy(), want)
        ideal = reram_linear(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))
        assert not torch.equal(got, ideal)


def test_reram_backend_draws_once_and_replays_the_same_faults(setup):
    """'reram' with a fault model keeps each (MLP, layer) site's draws as
    buffers, made once at build from the site ``(mlp, layer)`` (the head
    MLP 0, SA layer i's MLP i + 1): calls draw nothing, and each layer's
    product sees its site's faults."""
    _, cfg_t, _, tparams, clouds = setup
    fm = FaultModel(sigma=0.2, **FAULTS)
    tm = repro_torch.compile_model(tparams, cfg_t, backend="reram",
                                   fault_model=fm, device="cpu")
    be = tm.backend
    for key in (("sa", 0), ("sa", 1), "head"):
        mlp_ix = 0 if key == "head" else key[1] + 1
        for l, lyr in enumerate(be._mlp(key).layers()):
            want = fm.draw((4, *lyr["w"].shape), mlp_ix, l)
            got = be.fault_draws(key, l)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    first = tm.batched_forward(clouds)
    torch.manual_seed(123)                   # no global stream is read
    assert torch.equal(tm.batched_forward(clouds), first)
    assert torch.equal(tm.forward(clouds[0]), first[0])
    again = repro_torch.compile_model(tparams, cfg_t, backend="reram",
                                      fault_model=fm, device="cpu")
    assert torch.equal(again.batched_forward(clouds), first)


@pytest.mark.parametrize("backend", ("reram",) + CROSSBAR_BACKENDS)
def test_zero_fault_and_protection_bitwise_ideal(setup, backend):
    _, cfg_t, _, tparams, clouds = setup

    def logits(**kw):
        return repro_torch.compile_model(
            tparams, cfg_t, backend=backend, schedule="pointer",
            device="cpu", **kw).batched_forward(clouds)
    ideal = logits()
    assert torch.equal(logits(fault_model=FaultModel()), ideal)
    faulted = logits(fault_model=FaultModel(p_stuck0=0.05, p_stuck1=0.05,
                                            seed=7))
    assert not torch.equal(faulted, ideal)
    if backend != "reram":
        for group in (16, 4):
            assert torch.equal(logits(ecc=EccConfig(group)), ideal)


def test_float_backend_rejects_fault_model(setup):
    _, cfg_t, _, tparams, _ = setup
    with pytest.raises(ValueError, match="does not support fault"):
        repro_torch.compile_model(tparams, cfg_t, backend="float",
                                  fault_model=FaultModel(), device="cpu")


def test_ecc_with_a_prebuilt_program_is_refused(setup):
    _, cfg_t, _, tparams, _ = setup
    from repro_torch.models.pointnet2 import build_model_program
    with pytest.raises(ValueError, match="build_model_program"):
        repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                  program=build_model_program(tparams),
                                  ecc=EccConfig(), device="cpu")


def test_reliability_stats_equal_jax(setup, reference_programs):
    _, cfg_t, _, tparams, _ = setup
    jm = reference_programs["ecc4"][2]
    tm = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                   ecc=EccConfig(4),
                                   fault_model=FaultModel(**FAULTS),
                                   device="cpu")
    rel = tm.stats()["reliability"]
    assert rel["ecc"] == jm.stats()["reliability"]["ecc"]
    assert rel["fault_model"] == dataclasses.asdict(JFault(**FAULTS))
    assert "reliability" not in repro_torch.compile_model(
        tparams, cfg_t, backend="reram-fused", device="cpu").stats()
    assert tm.stats()["launch_plan"]["head"]["kernel"] in ("K1", "K2", "K3")


# ---------------------------------------------------------------------------
# the Pareto harness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swept(setup):
    _, cfg_t, _, tparams, _ = setup
    return sweep(tparams, cfg_t, fault_rates=(0.0, 0.05, 0.12),
                 protections=("none", "ecc"), n_clouds=8, ecc_group=4,
                 n_classes=10, device="cpu")


def test_sweep_monotone_curve_ecc_flattens(swept):
    by = {(p.protection, p.fault_rate): p for p in swept}
    raw = [by[("none", r)].accuracy for r in (0.0, 0.05, 0.12)]
    prot = [by[("ecc", r)].accuracy for r in (0.0, 0.05, 0.12)]
    assert raw[0] == prot[0] == 1.0
    assert raw == sorted(raw, reverse=True)
    assert all(p >= r for p, r in zip(prot, raw))
    assert sum(1 - a for a in prot) < sum(1 - a for a in raw)
    assert by[("ecc", 0.0)].energy_j > by[("none", 0.0)].energy_j
    assert by[("ecc", 0.0)].area_arrays > by[("none", 0.0)].area_arrays
    assert all(p.ecc_group == (4 if p.protection == "ecc" else None)
               for p in swept)


def test_sweep_is_deterministic_and_validates(setup, swept):
    _, cfg_t, _, tparams, _ = setup
    again = sweep(tparams, cfg_t, fault_rates=(0.0, 0.05, 0.12),
                  protections=("none", "ecc"), n_clouds=8, ecc_group=4,
                  n_classes=10, device="cpu")
    assert again == swept
    with pytest.raises(ValueError, match="unknown protection"):
        sweep(tparams, cfg_t, fault_rates=(0.0,), protections=("tmr",),
              n_clouds=1, n_classes=10, device="cpu")


def test_front_archetypes_and_protection_equal_jax(swept):
    jpts = [jpareto.DesignPoint(**dataclasses.asdict(p)) for p in swept]
    front = pareto_front(swept)
    assert [dataclasses.asdict(p) for p in front] == [
        dataclasses.asdict(p) for p in jpareto.pareto_front(jpts)]
    for bands in (ArchetypeBands(),
                  ArchetypeBands(fortress_acc=0.5, energy_band=0.9)):
        got = classify_archetypes(swept, bands)
        want = jpareto.classify_archetypes(
            jpts, jpareto.ArchetypeBands(**dataclasses.asdict(bands)))
        assert got["counts"] == want["counts"]
        assert [dataclasses.asdict(p) for p in got["points"]] == [
            dataclasses.asdict(p) for p in want["points"]]
    assert classify_archetypes([]) == {"points": [], "counts": {}}
    pick = repro_torch.PlanPolicy(reliability_target=0.5).select_protection(
        swept)
    assert pick.accuracy >= 0.5
    assert isinstance(pick, DesignPoint)
