"""The sharded train step and the sharded prefill and decode on gloo ranks
for the "tp" cases of ``tests/test_torch_distributed.py``'s
:data:`RANK_SETS`, on the CPU: ``cfg.remat`` in the sharded step
(``tp_remat``: the ``tp`` case's widths, each layer checkpointed), the MoE
experts on 'model' shards (``moe_tp``: gate and up column-parallel, down
re-cut from d to f by an all-to-all and row-parallel) and vlm's
cross-attention (``vlm_tp``).

Its own 8 gloo ranks (:func:`ranks`, ``python tests/test_torch_distributed.py
RANK 8 DIR tp``), so that each file's ranks stay well inside
``RANK_TIMEOUT``; the checks are that file's, case by case, with its
bounds (``F32_BOUNDS``), and the checks of what these cases add: which
blocks compute on 'model' shards, that a checkpointed step gathers each
gathered leaf exactly twice (its forward and its recompute, which serves
the backward: no re-gather), that each checkpointed layer keeps as its
input the rank's d_model slice of the block-boundary activation (the
reference's ``_shard_batch`` cut over 'model'), and that no weight's copy
is kept for the backward (but vlm's gates' ``tanh``, 4 bytes a cross
layer).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_distributed as td                               # noqa: E402

jx = td.jx
WHICH = "tp"
CASES, SERVE_CASES = td.RANK_SETS[WHICH]


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    """Every rank's results for this file's cases and the reference's
    train state and 2 steps per case."""
    return td.run_ranks(jx, tmp_path_factory.mktemp("gloo_tp"), WHICH)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_losses_match_the_references(ranks, case):
    td.test_sharded_step_losses_match_the_references(ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_grad_norms_match_the_references(ranks, case):
    td.test_sharded_step_grad_norms_match_the_references(ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_parameters_match_the_unsharded_step(ranks, case):
    td.test_sharded_step_parameters_match_the_unsharded_step(ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_moments_match_the_unsharded_step(ranks, case):
    td.test_sharded_step_moments_match_the_unsharded_step(ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_state_shards_are_the_reference_specs_cut(ranks, jx, case):
    td.test_sharded_state_shards_are_the_reference_specs_cut(ranks, jx,
                                                              case)


@pytest.mark.parametrize("case", CASES)
def test_restore_recuts_an_8_rank_checkpoint_for_4(ranks, case):
    td.test_restore_recuts_an_8_rank_checkpoint_for_4(ranks, case)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_prefill_and_decode_match_the_unsharded_port(ranks, case):
    td.test_sharded_prefill_and_decode_match_the_unsharded_port(ranks, case)


def test_tp_blocks_compute_on_model_shards(ranks):
    """The MoE experts; vlm's plain and crossed attention and the
    cross-attention (the MLPs, under the floor, whole), the embedding and
    head; with remat, the ``tp`` case's blocks."""
    for r in ranks["rank"]:
        assert r["moe_tp"]["tp_blocks"] == {"blocks": ("moe",)}
        assert r["vlm_tp"]["tp_blocks"] == {
            "plain": ("attn",), "crossed": ("attn", "xattn"),
            "embed": ("",), "lm_head": ("",)}
        assert r["tp_remat"]["tp_blocks"] == {
            "blocks": ("attn", "mlp"), "embed": ("",), "lm_head": ("",)}


def test_checkpointed_step_gathers_each_leaf_twice(ranks):
    """``tp_remat``: in every step, on every rank, the gathered bytes are
    exactly twice a step's layers' and unstacked leaves' (each gathered
    once in the forward and once in the recompute, which serves the
    backward), at most two layers' alive at once; no case keeps a weight's
    copy for the backward but vlm's 2 cross layers' gates (``tanh`` of a
    float32 gate)."""
    for r in ranks["rank"]:
        res = r["tp_remat"]
        layer, unstacked = res["gathered_layer"], res["gathered_unstacked"]
        assert layer > 0
        for g in res["gathers"]:
            assert g["gathered_bytes"] == 2 * (res["layers"] * layer
                                               + unstacked)
            assert 0 < g["peak_alive_bytes"] <= 2 * layer + unstacked
        for case in CASES:
            kept = 2 * 4 if case == "vlm_tp" else 0
            assert all(g["kept_copy_bytes"] == kept
                       for g in r[case]["gathers"]), case


def test_checkpointed_layers_keep_the_ranks_d_model_slice(ranks):
    """``tp_remat``: each checkpointed layer keeps the rank's half of its
    input's d_model, ``B_local·S·(D/2)·itemsize`` bytes
    (``td.check_kept_inputs``); the cases without ``remat`` checkpoint
    nothing."""
    td.check_kept_inputs(ranks, "tp_remat")
    for r in ranks["rank"]:
        assert r["moe_tp"]["kept_inputs"] == []
        assert r["vlm_tp"]["kept_inputs"] == []
