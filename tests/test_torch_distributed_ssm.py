"""The sharded train step and the sharded prefill and decode on gloo ranks
for the "ssm" cases of ``tests/test_torch_distributed.py``'s
:data:`RANK_SETS`, on the CPU: the hybrid's Mamba2 layers and shared
block on 'model' shards (``hybrid_tp``: a rank's heads of z, x and dt and
the whole B and C, the gated norm's sum of squares summed over 'model',
the decode cache's heads cut, its conv rows cut evenly) and RWKV6's time
and channel mix (``ssm_tp``: 17 heads padded to 18, the channel mix's v
re-cut from d to d_ff by an all-to-all; the decode state whole on every
rank), both with the published ``remat``.

Its own 8 gloo ranks (:func:`ranks`, ``python tests/test_torch_distributed.py
RANK 8 DIR ssm``), so that each file's ranks stay well inside
``RANK_TIMEOUT``; the checks are that file's, case by case, with its
bounds (``F32_BOUNDS``), which blocks compute on 'model' shards, and
that each checkpointed layer keeps as its input the rank's d_model slice
of the block-boundary activation.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_distributed as td                               # noqa: E402

jx = td.jx
WHICH = "ssm"
CASES, SERVE_CASES = td.RANK_SETS[WHICH]


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    """Every rank's results for this file's cases and the reference's
    train state and 2 steps per case."""
    return td.run_ranks(jx, tmp_path_factory.mktemp("gloo_ssm"), WHICH)


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
    """The grouped Mamba2 layers and the shared block (the trailing layer,
    under the floor, whole); RWKV6's time and channel mix; no weight's copy
    kept for the backward (every layer checkpointed, the shared block's
    copies re-gathered)."""
    for r in ranks["rank"]:
        assert r["hybrid_tp"]["tp_blocks"] == {
            "mamba": ("mamba",), "shared_attn": ("attn", "mlp")}
        assert r["ssm_tp"]["tp_blocks"] == {"blocks": ("time", "channel")}
        for case in CASES:
            assert all(g["kept_copy_bytes"] == 0
                       for g in r[case]["gathers"]), case


@pytest.mark.parametrize("case", CASES)
def test_checkpointed_layers_keep_the_ranks_d_model_slice(ranks, case):
    """Each checkpointed Mamba2 layer (the groups' and the trail's) and
    RWKV6 block keeps the rank's half of its padded input's d_model
    (``td.check_kept_inputs``)."""
    td.check_kept_inputs(ranks, case)
