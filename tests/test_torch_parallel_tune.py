"""The port's tuning step on several ranks on the CPU (gloo, spawned ranks):
dp=2, tp=2 and dp=2 x tp=2 against the JAX tuning step at the global batch
2, and tp=2 on a UNet whose middle block has one head, against one process.

The JAX step (UNet trained, clip 1.0 + AdamW) runs once, jitted, at batch 2
in a module-scoped fixture (``test_torch_parallel_train.jax_reference``),
its draws handed to the port. A dp rank takes its row of the batch; the tp
ranks of a pair take the same rows. The gradients compared are those AdamW
applies, the UNet's gathered to the unsplit layout; JAX's are its raw
gradients times optax's clip factor, max_norm / max(norm, max_norm).

The one-head middle block: tp=2 splits every other attention site, so that
block's attention stays whole on both ranks and its offsets' gradient is
whole on each; summing it over tp would double it.

Tolerances, f32 on the CPU, those of ``tests/test_torch_parallel_train.py``
and the JAX package's ``tests/test_tensor_parallel.py``: the loss terms rel
1e-5 at dp=2 and rel 2e-4 under tp (the row shards' partial products are
summed in another order); the gradients rel-L2 1e-4 per group; the update
(after minus before) rel-L2 1e-3 per group, as the one-process tuning step
holds its update against JAX (AdamW's first update, lr * g / (|g| + eps),
amplifies the rounding of the smallest gradients). The ranks end with the
same parameters bit for bit.
"""
import dataclasses

import pytest
import torch

from e4t_diffusion_torch.models.unet import UNetConfig
from e4t_diffusion_torch.parallel import mesh as pmesh

import torch_parallel_workers as workers
from test_torch_parallel_train import CFG, LR, _rel, jax_reference

LOSS_TOL = 1e-5
TP_LOSS_RTOL = 2e-4
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
TUNE_CFG = dict(CFG, train_unet=True, max_grad_norm=1.0)
# tp=2 splits the 4-head sites and leaves the one-head middle block whole
ONE_HEAD_MID = dataclasses.replace(UNetConfig.tiny(),
                                   attention_head_dim=(4, 1))


@pytest.fixture(scope="module")
def jax_tune():
    """The JAX tuning step at batch 2; "clipped": the gradients AdamW
    applies."""
    ref = jax_reference(TUNE_CFG)
    norm = ref["metrics"]["grad_norm"]
    assert norm > TUNE_CFG["max_grad_norm"]  # the clip is active
    coef = TUNE_CFG["max_grad_norm"] / norm
    ref["clipped"] = {g: {k: t * coef for k, t in grp.items()}
                      for g, grp in ref["grads"].items()}
    return ref


def _payload(jax_tune, cases):
    return {"sds": jax_tune["sds"], "batch": jax_tune["batch"], "lr": LR,
            "cases": cases,
            "overrides": {"tune_mixed": {"unet_config": ONE_HEAD_MID}}}


@pytest.fixture(scope="module")
def world2(jax_tune, tmp_path_factory):
    """One spawn of two ranks: the tuning step at dp=2, at tp=2, and at
    tp=2 on the one-head-middle UNet; and that UNet's one-process step."""
    payload = _payload(jax_tune, [("tune_dp", 1, False, TUNE_CFG),
                                  ("tune_tp", 2, False, TUNE_CFG),
                                  ("tune_mixed", 2, False, TUNE_CFG)])
    ranks = workers.run_ranks(workers.train_cases, 2, payload,
                              tmp_path_factory.mktemp("world2"))
    torch.set_num_threads(1)
    one = workers.train_step(pmesh.Mesh(), dict(
        payload, unet_config=ONE_HEAD_MID), TUNE_CFG)
    return ranks, one


def _rel_l2(got, want):
    num = sum(float((got[k] - want[k]).double().norm() ** 2) for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    assert den > 0
    return (num / den) ** 0.5


def _update_rel(after, want, before):
    keys = sorted(want)
    start = torch.cat([before[k].ravel() for k in keys]).double()
    got = torch.cat([after[k].ravel() for k in keys]).double() - start
    ref = torch.cat([want[k].ravel() for k in keys]).double() - start
    assert float(ref.abs().max()) > 0
    return float((got - ref).norm() / ref.norm())


def _assert_step(got, want, loss_tol, grads="clipped"):
    """One rank's step against a reference (JAX's or one process's): the
    losses and grad norm, every group's gradients and update."""
    for k in ("loss", "loss_diff", "loss_reg", "grad_norm"):
        assert _rel(got["metrics"][k], want["metrics"][k]) <= loss_tol, k
    assert set(got["after"]) == set(want["after"])
    for group, ref in want[grads].items():
        assert set(got["grads"][group]) == set(ref), group
        assert _rel_l2(got["grads"][group], ref) <= GRAD_TOL, group
        assert _update_rel(got["after"][group], want["after"][group],
                           want["before"][group]) <= UPDATE_TOL, group


def _assert_same_parameters(ranks, case):
    for rank in ranks[1:]:
        for group, tensors in rank[case]["after"].items():
            for k, t in tensors.items():
                assert torch.equal(t, ranks[0][case]["after"][group][k]), \
                    (case, k)


def test_dp2_tuning_step_matches_jax(jax_tune, world2):
    """Each rank one row, gradients averaged over dp: JAX's step at
    batch 2."""
    ranks, _ = world2
    for rank in ranks:
        _assert_step(rank["tune_dp"], jax_tune, LOSS_TOL)
    _assert_same_parameters(ranks, "tune_dp")


def test_tp2_tuning_step_matches_jax(jax_tune, world2):
    """tp=2 (both ranks the whole batch): the sharded clip norm, the
    offsets' gradients summed over tp and the GEGLU shards under the
    backward give JAX's step."""
    ranks, _ = world2
    for rank in ranks:
        _assert_step(rank["tune_tp"], jax_tune, TP_LOSS_RTOL)
    _assert_same_parameters(ranks, "tune_tp")


def test_dp2_tp2_tuning_step_matches_jax(jax_tune, tmp_path_factory):
    """Four ranks, dp=2 x tp=2: each tp pair one row of the batch."""
    ranks = workers.run_ranks(
        workers.train_cases, 4,
        _payload(jax_tune, [("grid", 2, False, TUNE_CFG)]),
        tmp_path_factory.mktemp("world4"))
    for rank in ranks:
        _assert_step(rank["grid"], jax_tune, TP_LOSS_RTOL)
    _assert_same_parameters(ranks, "grid")


def test_tp2_leaves_a_site_whole_and_its_offsets_gradient_too(world2):
    """The middle block's one head: its attention is not split, and its
    offsets' gradient (whole on each rank) is not summed over tp, so the
    grad norm, the clip and every group's gradients and update are one
    process's."""
    ranks, one = world2
    specs = ranks[0]["tune_mixed"]["specs"]
    split = {n for n in specs if n.endswith(".to_q.weight")}
    assert len(split) == 6
    assert not any(n.startswith("mid_block.attentions") for n in split)
    mid = {k: t for k, t in one["grads"]["offsets"].items()
           if k.startswith("mid_block.")}
    assert mid
    for rank in ranks:
        got = rank["tune_mixed"]["grads"]["offsets"]
        assert _rel_l2(got, mid) <= GRAD_TOL
        _assert_step(rank["tune_mixed"], one, TP_LOSS_RTOL, grads="grads")
    _assert_same_parameters(ranks, "tune_mixed")


def test_a_tp_that_splits_no_site_is_refused():
    """tp=3 divides neither the tiny UNet's 4 heads nor its feed-forward
    widths: nothing would be split, so tensor parallelism refuses it."""
    from e4t_diffusion_torch.diffusion.pipeline import E4TModules

    unet = E4TModules.tiny(device="cpu").unet
    with pytest.raises(ValueError, match="tp=3"):
        pmesh.apply_tensor_parallel(unet, pmesh.Mesh(tp=3))
    assert not hasattr(unet, "tp_specs")
