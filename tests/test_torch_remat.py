"""The UNet calls' rematerialisation policies of the port's train step
(``E4TTrainConfig.remat_policy``), on the CPU with the tiny modules.

"dots" keeps the outputs of the matrix products and convolutions for the
backward (``jax.checkpoint_policies.dots_saveable``) and recomputes the
rest; "nothing" recomputes the whole UNet call. The saved outputs are the
values the recompute would give, so the two give the same loss and
gradients bit for bit. A ``TorchDispatchMode`` counts the products and
convolutions that the backward runs: under "dots" as many as a backward
without rematerialisation (the products of the gradients alone, and no
forward convolution), under "nothing" more. One loss and backward a
policy (and one without rematerialisation), in a module fixture.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.ops import attention
from e4t_diffusion_torch.training import train_step as ts

from torch_parallel_workers import random_batch

CFG = dict(train_unet=True, train_text_encoder=True, max_grad_norm=1.0)
SHARDS = 3


class _DotCount(TorchDispatchMode):
    """Counts the ops of ``train_step.DOT_OPS`` dispatched under it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in ts.DOT_OPS:
            key = func.overloadpacket.__name__
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _run(policy, no_remat=False):
    """The tiny loss (seeded weights and batch) under ``policy`` inside the
    step's contexts (threshold 0, SHARDS batch shards), then its backward
    outside them: the loss, every group's gradient, the products and
    convolutions the backward ran, and the threshold and shards each UNet
    call saw (forward and recompute). ``no_remat`` runs the UNet calls
    without checkpointing."""
    torch.manual_seed(0)
    modules = E4TModules.tiny(device="cpu")
    offsets = wo.init_offset_bank(modules.unet.config,
                                  torch.Generator().manual_seed(1))
    cfg = ts.E4TTrainConfig(**CFG, remat_policy=policy)
    trainable, _ = ts.split_trainable(modules, offsets, cfg, torch.float32)
    seen = []
    real_call, real_checkpoint = ts.functional_call, ts.checkpoint

    def spy(module, *args, **kwargs):
        if module is modules.unet:
            seen.append((attention.flash_threshold_bytes(),
                         attention.batch_shards_in_force()))
        return real_call(module, *args, **kwargs)

    ts.functional_call = spy
    if no_remat:
        ts.checkpoint = lambda fn, *a, **kw: fn(*a)
    try:
        with attention.flash_threshold(0), attention.batch_shards(SHARDS):
            loss, _ = ts.e4t_loss_fn(modules, DDPMScheduler(), cfg,
                                     trainable, random_batch(0, 2))
        mode = _DotCount()
        with mode:
            loss.backward()
    finally:
        ts.functional_call, ts.checkpoint = real_call, real_checkpoint
    return {"loss": loss.item(), "counts": mode.counts, "seen": seen,
            "grads": {g: {k: t.grad for k, t in grp.items()}
                      for g, grp in trainable.items()}}


@pytest.fixture(scope="module")
def runs():
    return {"nothing": _run("nothing"), "dots": _run("dots"),
            "plain": _run("nothing", no_remat=True)}


def test_dots_gives_nothings_loss_and_gradients_bit_for_bit(runs):
    nothing, dots = runs["nothing"], runs["dots"]
    assert nothing["loss"] == dots["loss"]
    assert set(nothing["grads"]) == set(dots["grads"]) == {
        "unet", "text", "e4t", "offsets"}
    for g, grads in nothing["grads"].items():
        for k, t in grads.items():
            assert torch.equal(t, dots["grads"][g][k]), (g, k)


def test_dots_recomputes_no_matrix_product_or_convolution(runs):
    nothing, dots, plain = (runs[k]["counts"]
                            for k in ("nothing", "dots", "plain"))
    # the recompute of "nothing" runs the forward's convolutions and
    # products again; "dots" runs the backward's own only
    assert nothing.get("convolution", 0) > 0
    assert "convolution" not in dots and "convolution" not in plain
    assert dots == plain
    for op in ("mm", "addmm", "bmm"):
        assert nothing.get(op, 0) > dots.get(op, 0), op


@pytest.mark.parametrize("policy", ts.REMAT_POLICIES)
def test_the_recompute_reenters_the_threshold_and_batch_shards(runs,
                                                               policy):
    """The step's flash threshold and batch shards hold in every UNet call,
    the recomputes in the backward (outside the step's contexts)
    included: the tap and the full pass, each run again."""
    assert attention.batch_shards_in_force() != SHARDS
    assert runs[policy]["seen"] == [(0, SHARDS)] * 4
    assert runs["plain"]["seen"] == [(0, SHARDS)] * 2


def test_an_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy 'everything'"):
        ts.remat(lambda x: x, torch.ones(1, requires_grad=True),
                 policy="everything")
