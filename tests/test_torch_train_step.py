"""One tiny phase-2 tuning step of the port against the JAX package's.

The JAX step (``make_train_step``, clip 1.0 + AdamW, UNet and text encoder
trained) runs once, jitted, in a module-scoped fixture. Both steps get the
same weights (``state_dicts_from_jax``), latents, timesteps and noise; the
noise is drawn as the JAX ``e4t_loss_fn`` draws it inside the step, from
``jax.random.split(fold_in(rng, step), 3)[0]``, and handed to the port.
The JAX step's clipped gradients are read back from AdamW's first moment
(mu = (1 - b1) g after one update), its raw gradients from an identity
transformation chained before the optimizer that keeps them in its state.
The same compiled step runs once more, on a second batch from the same
starting parameters, for the gradient accumulation check. The updates of
``grads_bf16`` and of gradient accumulation are then applied to those raw
gradients outside the step, with the JAX package's own optimizer: the
bf16-cast gradients, as the step hands them to optax with ``grads_bf16``;
and the mean of the two calls' gradients, which is what
``optax.MultiSteps(tx, 2)`` (the JAX CLI's accumulation) applies on its
second call (compiling MultiSteps itself would take longer than the step).
Both are applied to the trees raveled into one vector: AdamW, its weight
decay and the clip are elementwise but for the global norm, so the update
is the same, and one vector traces in a fraction of the time a tree does.
The 8-bit AdamW (``use_8bit``) quantizes each tensor in blocks of its own,
in each framework's layout (a linear kernel is (in, out) in the JAX
package and (out, in) in the port, so its blocks hold other elements). Its
first update, from unquantized moments, is applied to one vector of the
tensors each zero-padded to whole 256-element blocks, whose blocks are
then each tensor's own (the JAX update pads each tensor so; padding has a
zero gradient and parameter, and stays zero), and held at UPDATE_TOL; the
second call's loss against the same compiled step's at those parameters.
The port's two updates are held against the JAX package's 8-bit AdamW fed
the gradients the port's step gave its optimizer, in the port's layout, at
OPT8_TOL (rel-L2 2e-6 to 1.1e-4 measured: the jitted JAX update rounds
a few codes elsewhere; 4e-6 at most, run op by op): the second update
dequantizes the codes the first stored. Against the JAX step's own
second update they differ by rel-L2 1.2-2.3e-2 per group, since the
gradients' 1e-4 drift and the other layout's blocks move codes by a step
(14% for a first moment), which f32 AdamW in the port's place also
reaches (1.0-2.0e-2).

Tolerances, f32 on the CPU: loss terms rel 1e-5 (one reduction of
O(1) values); gradients rel-L2 1e-4 per group, as the conv stacks' forward
parity (tests/test_torch_models.py), since the backward runs the same
reduction chains in another order; parameters after the step 1e-6 absolute
plus rel-L2 1e-3 on the updates, because AdamW's first update is
lr * g / (|g| + eps), which amplifies the rounding of the smallest
gradients. With grads_bf16 the gradients the optimizer sees are rel-L2
4e-3 from the JAX ones: the gradient tolerance plus the bf16 rounding
(2^-8 relative) of the elements whose rounding the 1e-4 drift flips; the
JAX grad norm is a bf16 number, so it is held at rel 1e-2, and optax forms
AdamW's moments of bf16 gradients in bf16 ((1 - b1) g and (1 - b2) g^2 are
rounded, 2^-9 relative each), so the updates are held at rel-L2 5e-3.
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e4t_diffusion_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from e4t_diffusion_tpu.training import train_step as jax_ts

from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
from e4t_diffusion_torch.training import train_step as ts
from e4t_diffusion_torch.utils import convert

from torch_parity import jax_tiny, port_tiny, rel_l2

LR = 1e-4
B1 = 0.9
CFG = dict(train_unet=True, train_text_encoder=True, max_grad_norm=1.0,
           reg_lambda=0.01, domain_embed_scale=0.1)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
BF16_GRAD_TOL = 4e-3
BF16_NORM_TOL = 1e-2
BF16_UPDATE_TOL = 5e-3
OPT8_TOL = 5e-4


def _batch(seed=0, bsz=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (bsz, 16))
    ph = np.array([3, 5][:bsz])
    ids[np.arange(bsz), ph] = 999
    return {
        "latents": rng.standard_normal((bsz, 4, 8, 8)).astype(np.float32),
        "pixel_values": rng.uniform(-1, 1, (bsz, 3, 32, 32)).astype(
            np.float32),
        "input_ids": ids.astype(np.int32),
        "placeholder_idx": ph.astype(np.int32),
        "uncond_ids": rng.integers(0, 1000, (1, 16)).astype(np.int32),
        "class_token_id": np.asarray(5, np.int32),
        "timesteps": np.array([100, 700][:bsz], np.int32),
    }


def _torch_batch(batch, noise):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("input_ids", "placeholder_idx", "uncond_ids", "class_token_id",
              "timesteps"):
        out[k] = out[k].long()
    out["noise"] = torch.from_numpy(np.asarray(noise))
    return out


def _port_names(group, tree, frozen, n_text_layers, n_vit_layers):
    """A JAX trainable group (params or gradients) under the port's
    parameter names."""
    if group == "unet":
        return convert.unet_from_jax(tree)
    if group == "offsets":
        return convert.offsets_from_jax(tree)
    if group == "text":
        return convert.clip_text_from_jax(tree, n_text_layers)
    sd = convert.e4t_encoder_from_jax(
        dict(tree, **frozen["e4t_frozen"]), n_vit_layers)
    n = sum(k.endswith(".bias") and k.startswith("first_linears.")
            for k in sd)
    sd["first_linears_weight"] = torch.stack(
        [sd.pop(f"first_linears.{i}.weight") for i in range(n)])
    sd["first_linears_bias"] = torch.stack(
        [sd.pop(f"first_linears.{i}.bias") for i in range(n)])
    return {k: v for k, v in sd.items() if not k.startswith("clip_vision.")}


class _Kept(NamedTuple):
    grads: Any


def _keep_grads():
    """An identity transformation whose state is the last update it saw:
    chained first, the step's raw gradients."""
    return optax.GradientTransformation(
        lambda params: _Kept(jax.tree_util.tree_map(jnp.zeros_like, params)),
        lambda updates, state, params=None: (updates, _Kept(updates)))


def _noise(rng, step, shape):
    """The noise the JAX step draws at ``step``."""
    return np.asarray(jax.random.normal(
        jax.random.split(jax.random.fold_in(rng, step), 3)[0], shape,
        jnp.float32))


def _ravel(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    shapes = [np.shape(x) for x in leaves]
    return (np.concatenate([np.asarray(x, np.float32).ravel()
                            for x in leaves]), (treedef, shapes))


def _unravel(vec, spec):
    treedef, shapes = spec
    ends = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    return jax.tree_util.tree_unflatten(
        treedef, [x.reshape(s) for x, s in zip(np.split(vec, ends), shapes)])


def _first_update(tx, grads, params, cast=jnp.float32):
    """(global norm of ``grads`` cast to ``cast``, ``params`` after ``tx``'s
    first update with them), on raveled trees."""
    def run(g, p):
        g = g.astype(cast)
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.global_norm(g), optax.apply_updates(p, updates)

    p, spec = _ravel(params)
    norm, after = jax.jit(run)(_ravel(grads)[0], p)
    return float(norm), _unravel(np.asarray(after), spec)


def _updates_8bit(tx, params, grads_at, updates=2, block=256):
    """``params`` after ``updates`` of ``tx``, the i-th with the gradients
    ``grads_at(i, the parameters then)``, on one vector of the tensors each
    padded with zeros to whole blocks (``tx``'s state carried over)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    sizes = [int(np.size(x)) for x in leaves]
    ends = np.cumsum([n + -n % block for n in sizes])

    def padded(tree):
        return np.concatenate([
            np.pad(np.asarray(x, np.float32).ravel(), (0, -n % block))
            for x, n in zip(jax.tree_util.tree_leaves(tree), sizes)])

    def unpadded(vec):
        return jax.tree_util.tree_unflatten(treedef, [
            vec[end - n - -n % block:end - -n % block].reshape(np.shape(x))
            for x, n, end in zip(leaves, sizes, ends)])

    @jax.jit
    def run(g, p, state):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    vec = padded(params)
    state, tree = tx.init(vec), params
    for i in range(updates):
        vec, state = run(padded(grads_at(i, tree)), vec, state)
        tree = unpadded(np.asarray(vec))
    return tree


@pytest.fixture(scope="module")
def world():
    jm, params = jax_tiny(seed=7)
    jcfg = jax_ts.E4TTrainConfig(**CFG)
    tx = optax.chain(_keep_grads(), jax_ts.make_optimizer(LR, jcfg))
    state, frozen = jax_ts.create_train_state(params, jcfg, tx)
    batch, batch2 = _batch(), _batch(seed=1)
    rng = jax.random.PRNGKey(3)
    step = jax.jit(jax_ts.make_train_step(jm, JaxDDPM(), jcfg, tx))
    new_state, metrics = step(state, frozen,
                              jax.tree_util.tree_map(jnp.asarray, batch), rng)
    # the same compile, as the second call of an accumulation: the second
    # batch at the unchanged parameters, step counter 1
    second, metrics2 = step(
        jax_ts.TrainState(jnp.ones((), jnp.int32), state.trainable,
                          state.opt_state),
        frozen, jax.tree_util.tree_map(jnp.asarray, batch2), rng)
    raw, raw2 = new_state.opt_state[0].grads, second.opt_state[0].grads
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    # grads_bf16, unclipped: the JAX step casts the gradient tree to bf16
    # before the optimizer
    bf16_norm, bf16_after = _first_update(
        jax_ts.make_optimizer(
            LR, jax_ts.E4TTrainConfig(**dict(CFG, max_grad_norm=None))),
        raw, state.trainable, jnp.bfloat16)
    mean_norm, mean_after = _first_update(
        jax_ts.make_optimizer(LR, jcfg),
        jax.tree_util.tree_map(lambda a, b: (np.asarray(a) + np.asarray(b))
                               / 2, raw, raw2), state.trainable)
    # the 8-bit AdamW's first update (clip 1.0 first) with the first call's
    # raw gradients, then the same compiled step at those parameters, step
    # 1: the second call of an 8-bit run
    after8 = _updates_8bit(jax_ts.make_optimizer(LR, jcfg, use_8bit=True),
                           state.trainable, lambda i, tree: raw, updates=1)
    _, metrics8 = step(
        jax_ts.TrainState(jnp.ones((), jnp.int32),
                          jax.tree_util.tree_map(jnp.asarray, after8),
                          state.opt_state),
        frozen, jax.tree_util.tree_map(jnp.asarray, batch), rng)
    n_text = jm.text_encoder.config.num_layers
    n_vit = jm.e4t_encoder.config.vit.num_layers

    def port_named(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return {g: _port_names(g, tree[g], frozen, n_text, n_vit)
                for g in tree}

    def floats(m):
        return {k: float(v) for k, v in m.items()}

    return {
        "params": params, "batch": batch,
        "noise": _noise(rng, 0, batch["latents"].shape),
        "metrics": floats(metrics),
        "grads": port_named(jax.tree_util.tree_map(
            lambda m: m / (1 - B1), adam.mu)),
        "before": port_named(state.trainable),
        "after": port_named(new_state.trainable),
        "bf16": {
            "grads": port_named(jax.tree_util.tree_map(
                lambda g: np.asarray(g).astype(jnp.bfloat16).astype(
                    np.float32), raw)),
            "grad_norm": bf16_norm,
            "after": port_named(bf16_after)},
        "after_8bit": port_named(after8),
        "metrics_8bit_2": floats(metrics8),
        "noise_2": _noise(rng, 1, batch["latents"].shape),
        "accum": {
            "batch": batch2,
            "noise": _noise(rng, 1, batch2["latents"].shape),
            "metrics": floats(metrics2),
            "grad_norm": mean_norm,
            "after": port_named(mean_after)},
    }


def _port(world, **overrides):
    modules, sds = port_tiny(world["params"])
    cfg = ts.E4TTrainConfig(**dict(CFG, **overrides))
    trainable, frozen = ts.split_trainable(modules, sds["offsets"], cfg,
                                           torch.float32)
    return modules, cfg, trainable, frozen


def _step_with_grads(modules, cfg, trainable, batch, **optimizer_options):
    """One port step; returns (metrics, the gradients the optimizer
    applied, i.e. after clipping)."""
    params = [t for g in trainable.values() for t in g.values()]
    optimizer = ts.make_optimizer(params, LR, **optimizer_options)
    seen = {}
    optimizer.register_step_pre_hook(lambda *_: seen.update(
        {g: {k: t.grad.clone() for k, t in group.items()}
         for g, group in trainable.items()}))
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                              optimizer, lambda n: LR)
    metrics = step(batch)
    return {k: float(v) for k, v in metrics.items()}, seen


def test_tuning_step_matches_jax(world):
    modules, cfg, trainable, frozen = _port(world)
    assert set(trainable) == {"unet", "text", "e4t", "offsets"}
    assert set(frozen) == {"vae", "e4t_frozen"}
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    for g, group in before.items():  # same starting point
        for k, t in group.items():
            torch.testing.assert_close(t, world["before"][g][k], msg=k)
    metrics, grads = _step_with_grads(
        modules, cfg, trainable, _torch_batch(world["batch"], world["noise"]))

    for k in ("loss", "loss_diff", "loss_reg", "grad_norm"):
        assert metrics[k] == pytest.approx(world["metrics"][k],
                                           rel=LOSS_TOL), k
    assert world["metrics"]["grad_norm"] > 1.0  # the clip was active
    for g, group in grads.items():
        got = np.concatenate([group[k].numpy().ravel() for k in sorted(group)])
        want = np.concatenate([world["grads"][g][k].numpy().ravel()
                               for k in sorted(group)])
        assert rel_l2(got, want) <= GRAD_TOL, g
    _assert_params_match(trainable, before, world["after"])
    # the frozen groups took no gradient
    for group in frozen.values():
        assert all(t.grad is None and not t.requires_grad
                   for t in group.values())


def _assert_params_match(trainable, before, want_after, tol=UPDATE_TOL):
    """The parameters after an update against JAX's, as in the step test."""
    for g, group in trainable.items():
        keys = sorted(group)
        got = np.concatenate([group[k].detach().numpy().ravel()
                              for k in keys])
        want = np.concatenate([want_after[g][k].numpy().ravel()
                               for k in keys])
        start = np.concatenate([before[g][k].numpy().ravel() for k in keys])
        np.testing.assert_allclose(got, want, atol=1e-6 + 2 * LR)
        assert not np.array_equal(got, start), g
        assert rel_l2(got - start, want - start) <= tol, g


def test_8bit_tuning_step_matches_jax(world):
    """use_8bit, two calls on the same batch (the second's noise drawn at
    step 1, as JAX's): each call's loss terms against the JAX step's at
    its own 8-bit run's parameters; the first update against JAX's
    (UPDATE_TOL); the two updates against the JAX package's 8-bit AdamW
    fed the gradients the port's step handed its optimizer, in the port's
    layout (OPT8_TOL: the second update dequantizes the codes the first
    stored)."""
    from e4t_diffusion_tpu.training.optim8bit import adamw_8bit

    modules, cfg, trainable, _ = _port(world)
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    params = [t for g in trainable.values() for t in g.values()]
    optimizer = ts.make_optimizer(params, LR, use_8bit=True)
    seen = []
    optimizer.register_step_pre_hook(lambda *_: seen.append(
        {g: {k: t.grad.numpy().copy() for k, t in group.items()}
         for g, group in trainable.items()}))
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                              optimizer, lambda n: LR)
    for i, (noise, want) in enumerate((
            (world["noise"], world["metrics"]),
            (world["noise_2"], world["metrics_8bit_2"]))):
        metrics = step(_torch_batch(world["batch"], noise))
        for k in ("loss", "loss_diff", "loss_reg", "grad_norm"):
            assert float(metrics[k]) == pytest.approx(want[k],
                                                      rel=LOSS_TOL), k
        if i == 0:
            _assert_params_match(trainable, before, world["after_8bit"])
    assert all(st["step"] == 2 for st in optimizer.state.values())
    start = {g: {k: t.numpy() for k, t in group.items()}
             for g, group in before.items()}
    want = _updates_8bit(adamw_8bit(LR), start, lambda i, tree: seen[i])
    for g, group in trainable.items():
        keys = sorted(group)
        got = np.concatenate([group[k].detach().numpy().ravel()
                              for k in keys])
        ref = np.concatenate([want[g][k].ravel() for k in keys])
        s0 = np.concatenate([start[g][k].ravel() for k in keys])
        assert rel_l2(got - s0, ref - s0) <= OPT8_TOL, g


def test_the_step_sets_the_8bit_step_rounding_from_grads_bf16(world):
    """The train step hands the 8-bit AdamW its step_bf16 from
    E4TTrainConfig.grads_bf16, the one place it is set."""
    for grads_bf16 in (True, False):
        modules, cfg, trainable, _ = _port(world, grads_bf16=grads_bf16)
        params = [t for g in trainable.values() for t in g.values()]
        optimizer = ts.make_optimizer(params, LR, use_8bit=True)
        assert optimizer.param_groups[0]["step_bf16"] is False
        step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                                  optimizer, lambda n: LR)
        step(_torch_batch(world["batch"], world["noise"]))
        assert optimizer.param_groups[0]["step_bf16"] is grads_bf16


def test_grads_bf16_matches_jax(world):
    """grads_bf16 (unclipped): the optimizer sees the gradients rounded to
    bf16, as the JAX step hands them to optax, and updates as it does."""
    modules, cfg, trainable, _ = _port(world, grads_bf16=True,
                                       max_grad_norm=None)
    metrics, seen = _step_with_grads(
        modules, cfg, trainable, _torch_batch(world["batch"], world["noise"]))
    ref = world["bf16"]
    assert metrics["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=BF16_NORM_TOL)
    for g, group in seen.items():
        for k, t in group.items():
            assert torch.equal(t, t.bfloat16().float()), k
        got = np.concatenate([group[k].numpy().ravel() for k in sorted(group)])
        want = np.concatenate([ref["grads"][g][k].numpy().ravel()
                               for k in sorted(group)])
        assert rel_l2(got, want) <= BF16_GRAD_TOL, g
    _assert_params_match(trainable, world["before"], ref["after"],
                         BF16_UPDATE_TOL)


def test_gradient_accumulation_matches_multisteps(world):
    """accumulate_steps=2 as optax.MultiSteps around the clipped AdamW: the
    first call updates nothing, the second applies the mean of the two
    calls' gradients."""
    modules, cfg, trainable, _ = _port(world)
    params = [t for g in trainable.values() for t in g.values()]
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                              ts.make_optimizer(params, LR), lambda n: LR,
                              accumulate_steps=2)
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    first = step(_torch_batch(world["batch"], world["noise"]))
    assert "grad_norm" not in first
    for g, group in trainable.items():
        for k, t in group.items():
            assert torch.equal(t.detach(), before[g][k]), k
    ref = world["accum"]
    second = step(_torch_batch(ref["batch"], ref["noise"]))
    assert float(first["loss"]) == pytest.approx(world["metrics"]["loss"],
                                                 rel=LOSS_TOL)
    for k in ("loss", "loss_diff", "loss_reg"):
        assert float(second[k]) == pytest.approx(ref["metrics"][k],
                                                 rel=LOSS_TOL), k
    assert float(second["grad_norm"]) == pytest.approx(ref["grad_norm"],
                                                       rel=LOSS_TOL)
    assert ref["grad_norm"] > 1.0  # the clip was active
    _assert_params_match(trainable, before, ref["after"])


def test_micro_batches_average_the_chunk_gradients(world):
    """micro_batches=2 applies the mean of the two halves' gradients, each
    half on its own rows of noise and timesteps."""
    modules, cfg, trainable, _ = _port(world, micro_batches=2,
                                       max_grad_norm=None)
    batch = _torch_batch(world["batch"], world["noise"])
    expected = {}
    for i in range(2):
        chunk = {k: (v.chunk(2)[i] if k in ts._PER_SAMPLE else v)
                 for k, v in batch.items()}
        loss, _ = ts.e4t_loss_fn(modules, DDPMScheduler(), cfg, trainable,
                                 chunk)
        grads = torch.autograd.grad(
            loss, [t for g in trainable.values() for t in g.values()])
        flat = iter(grads)
        for g, group in trainable.items():
            for k in group:
                expected.setdefault((g, k), 0.0)
                expected[(g, k)] = expected[(g, k)] + next(flat) / 2
    _, seen = _step_with_grads(modules, cfg, trainable, batch)
    for (g, k), want in expected.items():
        torch.testing.assert_close(seen[g][k], want, rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_draws_come_from_the_generator(world):
    """Without noise and timesteps in the batch, the loss draws them from
    the caller's generator: the same seed gives the same loss."""
    modules, cfg, trainable, _ = _port(world)
    batch = _torch_batch(world["batch"], world["noise"])
    del batch["noise"], batch["timesteps"]
    losses = [ts.e4t_loss_fn(modules, DDPMScheduler(), cfg, trainable, batch,
                             torch.Generator().manual_seed(s))[0].item()
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


def test_optimizer_options():
    from e4t_diffusion_torch.training.optim8bit import AdamW8bit

    for use_8bit, cls in ((False, torch.optim.AdamW), (True, AdamW8bit)):
        opt = ts.make_optimizer([torch.zeros(1, requires_grad=True)], LR,
                                use_8bit=use_8bit)
        assert type(opt) is cls
        group = opt.param_groups[0]
        assert (group["lr"], group["betas"], group["eps"],
                group["weight_decay"]) == (LR, (0.9, 0.999), 1e-8, 1e-2)
    assert opt.param_groups[0]["step_bf16"] is False
    # the same hyper-parameters as the JAX package's optax.adamw
    assert isinstance(jax_ts.make_optimizer(LR, jax_ts.E4TTrainConfig()),
                      optax.GradientTransformation)
