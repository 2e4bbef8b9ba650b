"""Phase-1 pretraining in the port: one tiny step against the JAX package's,
the train-state checkpoints, the encoder's start (seeded init, open_clip
tower weights), and the CLI on the CPU (pretrain, then tuning, then
inference, resume, SIGTERM, sampling left out of the training draws).

The JAX step (``make_train_step`` with ``train_unet=False``,
``max_grad_norm=None`` and no latents, so the VAE encodes inside the step)
runs once, jitted, in a module-scoped fixture. Its noise, timesteps and
posterior draw come from ``jax.random.split(fold_in(rng, step), 3)`` [0],
[1] and [2] inside the step; the test draws them from the same keys and
hands them to the port (``noise``, ``timesteps``, ``posterior_noise``). Its
raw gradients are read from an identity transformation chained before
AdamW (as in ``tests/test_torch_train_step.py``).

Tolerances, f32 on the CPU: the loss terms rel 1e-5 and each trainable
group's gradient rel-L2 1e-4, as the tuning step's parity; the offsets and
the encoder head after AdamW 1e-5 absolute, and the update itself (after
minus before, nonzero) rel-L2 1e-3 against JAX's, as the tuning step's
``_assert_params_match``: a first AdamW step moves each element by about
lr = 1e-5, so only the update's own comparison would see it skipped,
halved or left out of a group.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.config import AttributeDict as JaxAttributeDict
from e4t_diffusion_tpu.config import load_config as jax_load_config
from e4t_diffusion_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from e4t_diffusion_tpu.training import train_step as jax_ts
from e4t_diffusion_tpu.utils import artifacts as jax_artifacts
from e4t_diffusion_tpu.utils import convert as jax_convert
from e4t_diffusion_tpu.utils.tokenizer import make_tiny_tokenizer_files

from e4t_diffusion_torch import inference, pretrain_e4t, tuning_e4t
from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
from e4t_diffusion_torch.models.vit import ViTConfig
from e4t_diffusion_torch.training import train_step as ts
from e4t_diffusion_torch.training.setup import (init_e4t_encoder_params,
                                                make_lr_schedule)
from e4t_diffusion_torch.utils import artifacts, convert
from e4t_diffusion_torch.utils.image import to_pil
from e4t_diffusion_torch.utils.profiling import StepTimer
from e4t_diffusion_torch.utils.runtime import GracefulShutdown
from e4t_diffusion_torch.utils.trackers import (NullTracker,
                                                TensorBoardTracker,
                                                make_tracker)

from test_artifacts import _write_sd_base
from test_torch_train_step import _keep_grads, _port_names
from torch_parity import jax_tiny, port_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5
CFG = dict(train_unet=False, train_text_encoder=False, max_grad_norm=None,
           reg_lambda=0.01, domain_embed_scale=0.1)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
UPDATE_TOL = 1e-3
WORDS = ["photo", "of", "a", "the", "face", "monet", "style", "in"]
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, bsz=2):
    """A pretraining batch: pixels, no latents (the step encodes them)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (bsz, 16))
    ph = np.array([3, 5][:bsz])
    ids[np.arange(bsz), ph] = 999
    return {
        "pixel_values": rng.uniform(-1, 1, (bsz, 3, 32, 32)).astype(
            np.float32),
        "input_ids": ids.astype(np.int32),
        "placeholder_idx": ph.astype(np.int32),
        "uncond_ids": rng.integers(0, 1000, (1, 16)).astype(np.int32),
        "class_token_id": np.asarray(5, np.int32),
    }


@pytest.fixture(scope="module")
def world():
    jm, params = jax_tiny(seed=11)
    jcfg = jax_ts.E4TTrainConfig(**CFG)
    tx = optax.chain(_keep_grads(), jax_ts.make_optimizer(LR, jcfg))
    state, frozen = jax_ts.create_train_state(params, jcfg, tx)
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    step = jax.jit(jax_ts.make_train_step(jm, JaxDDPM(), jcfg, tx))
    new_state, metrics = step(state, frozen,
                              jax.tree_util.tree_map(jnp.asarray, batch), rng)
    # the draws of the step at state.step 0, from its own keys
    k_noise, k_t, k_vae = jax.random.split(jax.random.fold_in(rng, 0), 3)
    bsz, side = 2, 32 // 2 ** (len(jm.vae.config.block_out_channels) - 1)
    shape = (bsz, 4, side, side)
    draws = {
        "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(
            k_t, (bsz,), 0, JaxDDPM().config.num_train_timesteps)),
        "posterior_noise": np.array(jax.random.normal(
            k_vae, shape, jnp.float32))}
    n_text = jm.text_encoder.config.num_layers
    n_vit = jm.e4t_encoder.config.vit.num_layers

    def port_named(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return {g: _port_names(g, tree[g], frozen, n_text, n_vit)
                for g in tree}

    return {"params": params, "batch": batch, "draws": draws,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": port_named(new_state.opt_state[0].grads),
            "after": port_named(new_state.trainable)}


def _torch_batch(batch, draws):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("input_ids", "placeholder_idx", "uncond_ids",
              "class_token_id"):
        out[k] = out[k].long()
    out["noise"] = torch.from_numpy(draws["noise"])
    out["timesteps"] = torch.from_numpy(draws["timesteps"]).long()
    out["posterior_noise"] = torch.from_numpy(draws["posterior_noise"])
    return out


def _port_step(params, **step_kwargs):
    modules, sds = port_tiny(params)
    cfg = ts.E4TTrainConfig(**CFG)
    trainable, frozen = ts.split_trainable(modules, sds["offsets"], cfg,
                                           torch.float32)
    flat = [t for g in trainable.values() for t in g.values()]
    optimizer = ts.make_optimizer(flat, LR)
    seen = {}
    optimizer.register_step_pre_hook(lambda *_: seen.update(
        {g: {k: t.grad.clone() for k, t in group.items()}
         for g, group in trainable.items()}))
    step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                              optimizer, lambda n: LR, **step_kwargs)
    return modules, trainable, frozen, optimizer, step, seen


def test_pretraining_step_matches_jax(world):
    """Latents absent: the port encodes the pixels under no_grad with JAX's
    posterior draw; loss, per-group gradients and the AdamW update agree."""
    _, trainable, frozen, _, step, seen = _port_step(world["params"])
    before = {g: {k: t.detach().clone() for k, t in group.items()}
              for g, group in trainable.items()}
    assert set(trainable) == {"e4t", "offsets"}
    assert set(frozen) == {"unet", "text", "vae", "e4t_frozen"}
    metrics = step(_torch_batch(world["batch"], world["draws"]))
    for k in ("loss", "loss_diff", "loss_reg"):
        want = world["metrics"][k]
        assert abs(float(metrics[k]) - want) <= LOSS_TOL * abs(want), k
    for group in ("e4t", "offsets"):
        got, want = seen[group], world["grads"][group]
        assert set(got) == set(want)
        num = sum(float((got[k] - want[k]).double().norm() ** 2)
                  for k in want)
        den = sum(float(want[k].double().norm() ** 2) for k in want)
        assert (num / den) ** 0.5 <= GRAD_TOL, group
        assert den > 0
    norm = float(metrics["grad_norm"])
    assert abs(norm - world["metrics"]["grad_norm"]) <= GRAD_TOL * norm
    for group in ("e4t", "offsets"):
        for k, want in world["after"][group].items():
            got = trainable[group][k].detach()
            assert float((got - want).abs().max()) <= PARAM_TOL, (group, k)
        keys = sorted(world["after"][group])
        start = torch.cat([before[group][k].ravel() for k in keys]).double()
        got = torch.cat([trainable[group][k].detach().ravel()
                         for k in keys]).double() - start
        want = torch.cat([world["after"][group][k].ravel()
                          for k in keys]).double() - start
        assert float(got.abs().max()) > 0, group
        assert float((got - want).norm() / want.norm()) <= UPDATE_TOL, group


def test_posterior_draw_comes_from_the_generator(world):
    """Without ``posterior_noise`` the encode draws from the generator, as
    the noise and timesteps do: the same seed gives the same step, another
    seed another loss; micro-batches split the posterior draw."""
    batch = _torch_batch(world["batch"], world["draws"])
    for k in ("noise", "timesteps", "posterior_noise"):
        batch.pop(k)
    losses = []
    for seed in (1, 1, 2):
        _, _, _, _, step, _ = _port_step(world["params"])
        losses.append(float(step(batch, torch.Generator().manual_seed(
            seed))["loss"]))
    assert losses[0] == losses[1] != losses[2]

    full = _torch_batch(world["batch"], world["draws"])
    one, two = [], []
    for mb, out in ((1, one), (2, two)):
        params = world["params"]
        modules, sds = port_tiny(params)
        cfg = ts.E4TTrainConfig(**dict(CFG, micro_batches=mb))
        trainable, _ = ts.split_trainable(modules, sds["offsets"], cfg,
                                          torch.float32)
        flat = [t for g in trainable.values() for t in g.values()]
        step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                                  ts.make_optimizer(flat, LR), lambda n: LR)
        out.append(float(step(full)["loss_diff"]))
    # the mean of the two half-batch losses is the whole batch's (loss_reg
    # is a sum over a chunk's samples, as in the JAX step)
    assert abs(one[0] - two[0]) <= LOSS_TOL * abs(one[0])


def test_resumed_step_continues_the_schedule(world):
    """After ``step.resume(n)`` the update runs at schedule(n), under a
    linear schedule with warmup, and the counts go on from n."""
    schedule = make_lr_schedule("linear", 1e-3, 2, 10)
    batch = _torch_batch(world["batch"], world["draws"])
    used = []
    for resume in (None, 5):
        modules, sds = port_tiny(world["params"])
        cfg = ts.E4TTrainConfig(**dict(CFG, grads_bf16=False))
        trainable, _ = ts.split_trainable(modules, sds["offsets"], cfg,
                                          torch.float32)
        flat = [t for g in trainable.values() for t in g.values()]
        optimizer = ts.make_optimizer(flat, schedule(0))
        optimizer.register_step_pre_hook(lambda opt, *_: used.append(
            opt.param_groups[0]["lr"]))
        step = ts.make_train_step(modules, DDPMScheduler(), cfg, trainable,
                                  optimizer, schedule, accumulate_steps=2)
        assert step.counts == {"calls": 0, "updates": 0}
        if resume is not None:
            step.resume(resume)
            assert step.counts == {"calls": 2 * resume, "updates": resume}
        step(batch)
        step(batch)
    assert used == [schedule(0), schedule(5)]
    assert schedule(0) != schedule(5)
    assert step.counts == {"calls": 12, "updates": 6}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trained_state(seed=0):
    """A tiny trainable set with AdamW moments, and a used generator."""
    g = torch.Generator().manual_seed(seed)
    trainable = {"e4t": {"w": torch.randn(4, 3, generator=g)},
                 "offsets": {"a.v": torch.randn(5, generator=g),
                             "a.linear1.weight": torch.randn(2, 2,
                                                             generator=g)}}
    for group in trainable.values():
        for t in group.values():
            t.requires_grad_(True)
    flat = [t for grp in trainable.values() for t in grp.values()]
    opt = ts.make_optimizer(flat, 1e-3)
    for _ in range(2):
        for t in flat:
            t.grad = torch.randn(t.shape, generator=g)
        opt.step()
    gen = torch.Generator().manual_seed(seed + 1)
    torch.randn(7, generator=gen)
    return trainable, opt, gen


def _assert_same_state(a, b):
    (ta, oa, ga), (tb, ob, gb) = a, b
    for g in ta:
        for k in ta[g]:
            assert torch.equal(ta[g][k], tb[g][k]), (g, k)
    sa, sb = oa.state_dict(), ob.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert torch.equal(ga.get_state(), gb.get_state())


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    saved = _trained_state()
    path = artifacts.save_train_state(str(tmp_path), 7, *saved[:2], 13,
                                      saved[2])
    assert path == str(tmp_path / "checkpoint-7")
    assert os.listdir(path) == [artifacts.TRAIN_STATE_FILE]
    target = _trained_state(5)
    info = artifacts.restore_train_state(path, *target)
    assert info == {"step": 7, "updates": 13}
    _assert_same_state(saved, target)
    # the restored generator continues the saved stream
    assert torch.equal(torch.randn(3, generator=saved[2]),
                       torch.randn(3, generator=target[2]))
    with pytest.raises(KeyError):
        wrong = _trained_state(5)
        wrong[0]["e4t"]["extra"] = torch.zeros(1)
        artifacts.restore_train_state(path, *wrong)


def test_async_checkpoint_equals_sync(tmp_path):
    """The async save writes what the state held at the call, even when the
    state changes before the thread has written it."""
    state = _trained_state(3)
    artifacts.save_train_state(str(tmp_path / "sync"), 4, *state[:2], 4,
                               state[2])
    artifacts.save_train_state(str(tmp_path / "async"), 4, *state[:2], 4,
                               state[2], async_save=True)
    with torch.no_grad():  # the next step, before the write is joined
        state[0]["e4t"]["w"].add_(1.0)
    artifacts.wait_for_checkpoints()
    a = torch.load(tmp_path / "sync" / "checkpoint-4" / "train_state.pt")
    b = torch.load(tmp_path / "async" / "checkpoint-4" / "train_state.pt")
    assert a.keys() == b.keys()
    flat_a, spec_a = torch.utils._pytree.tree_flatten(a)
    flat_b, spec_b = torch.utils._pytree.tree_flatten(b)
    assert spec_a == spec_b
    for x, y in zip(flat_a, flat_b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert not os.path.exists(tmp_path / "async" / "checkpoint-4.tmp")


def test_latest_checkpoint_is_numeric(tmp_path):
    assert artifacts.find_latest_checkpoint(str(tmp_path / "none")) is None
    assert artifacts.find_latest_checkpoint(str(tmp_path)) is None
    for name in ("checkpoint-9", "checkpoint-10", "checkpoint-2",
                 "checkpoint-11.tmp", "10", "checkpoint-x"):
        os.makedirs(tmp_path / name)
    want = str(tmp_path / "checkpoint-10")
    assert artifacts.find_latest_checkpoint(str(tmp_path)) == want
    assert artifacts.resolve_checkpoint(str(tmp_path), "latest") == want
    assert artifacts.resolve_checkpoint(str(tmp_path), None) is None
    assert artifacts.resolve_checkpoint(
        str(tmp_path), str(tmp_path / "checkpoint-2")) == str(
        tmp_path / "checkpoint-2")
    assert artifacts.resolve_checkpoint(
        str(tmp_path), str(tmp_path / "checkpoint-3")) is None


# ---------------------------------------------------------------------------
# the encoder's start
# ---------------------------------------------------------------------------

def test_encoder_init_is_seeded():
    a = E4TModules.tiny(device="cpu")
    b = E4TModules.tiny(device="cpu")
    torch.manual_seed(123)
    before = torch.randn(3)
    torch.manual_seed(123)
    init_e4t_encoder_params(a, seed=4)
    assert torch.equal(torch.randn(3), before)  # the global stream is kept
    init_e4t_encoder_params(b, seed=4)
    sa, sb = a.e4t_encoder.state_dict(), b.e4t_encoder.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    init_e4t_encoder_params(b, seed=5)
    sb = b.e4t_encoder.state_dict()
    assert not torch.equal(sa["final_linear.weight"], sb["final_linear.weight"])
    assert not torch.equal(sa["clip_vision.conv1.weight"],
                           sb["clip_vision.conv1.weight"])


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_clip_vision_weights_match_jax(prefix, tmp_path):
    """An open_clip visual state dict (with a ``proj``, with or without the
    ``visual.`` prefix) loads strictly into the port's tower and equals
    JAX's ``vit_from_torch`` of the same file."""
    cfg = ViTConfig.tiny()
    rng = np.random.default_rng(8)
    ref = E4TModules.tiny(device="cpu").e4t_encoder.clip_vision.state_dict()
    sd = {prefix + k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in ref.items()}
    sd[prefix + "proj"] = torch.zeros(cfg.width, 16)
    if prefix:
        sd["transformer.text_only.weight"] = torch.zeros(2)  # not visual.
        sd["logit_scale"] = torch.zeros(())
    path = tmp_path / "open_clip_visual.pt"
    torch.save(sd, path)

    tower = E4TModules.tiny(device="cpu").e4t_encoder.clip_vision
    tower.load_state_dict(convert.vit_from_open_clip(
        convert.load_state_dict_file(str(path))), strict=True)
    jax_tree = jax_convert.vit_from_torch(
        {k: v.numpy() for k, v in sd.items()}, cfg, prefix=prefix)
    jm, params = jax_tiny(seed=0)
    e4t = dict(jax.tree_util.tree_map(np.asarray, params["e4t"]),
               clip_vision=jax_tree)
    want = convert.e4t_encoder_from_jax(e4t, cfg.num_layers)
    got = tower.state_dict()
    assert set(got) == {k[len("clip_vision."):] for k in want
                        if k.startswith("clip_vision.")}
    for k, v in got.items():
        assert torch.equal(v, want["clip_vision." + k]), k
    bad = convert.vit_from_open_clip(sd)
    bad.pop("ln_post.bias")
    with pytest.raises(RuntimeError):
        tower.load_state_dict(bad, strict=True)


# ---------------------------------------------------------------------------
# the small utilities
# ---------------------------------------------------------------------------

def test_trackers_timer_shutdown_and_to_pil(tmp_path):
    assert isinstance(make_tracker(None, str(tmp_path)), NullTracker)
    assert isinstance(make_tracker("tensorboard", str(tmp_path),
                                   is_main=False), NullTracker)
    tb = make_tracker("tensorboard", str(tmp_path / "tb"), config={"a": 1})
    assert isinstance(tb, TensorBoardTracker)
    tb.log({"train/loss": 1.0}, 1)
    tb.log_images({"train/samples": Image.new("RGB", (4, 4))}, 1)
    tb.finish()
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))
    with pytest.raises(ValueError):
        make_tracker("mlflow", str(tmp_path))

    timer = StepTimer(warmup_steps=1, batch_size=4)
    assert timer.metrics() == {}
    for _ in range(3):
        timer.step()
    m = timer.metrics()
    assert m["perf/samples_per_sec"] == pytest.approx(
        4 * m["perf/steps_per_sec"])

    shutdown = GracefulShutdown()
    try:
        assert not shutdown.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert shutdown.requested
        assert shutdown.describe() == "received SIGTERM"
    finally:
        shutdown.restore()
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL

    imgs = to_pil(torch.tensor([[[[0.0, 1.0]]] * 3]).reshape(1, 3, 1, 2))
    assert np.asarray(imgs[0]).tolist() == [[[0, 0, 0], [255, 255, 255]]]


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A tiny SD base (JAX-written, as the other CLI tests use) and a folder
    of images of mixed sizes."""
    root = tmp_path_factory.mktemp("pre")
    jm, params = jax_tiny(seed=3)
    sd_dir = _write_sd_base(str(root / "sd"), jm,
                            jax.tree_util.tree_map(np.asarray, params))
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=WORDS)
    os.makedirs(root / "data" / "sub")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(48, 40), (36, 60), (40, 40), (70, 45)]):
        where = root / "data" / ("sub" if i % 2 else "") / f"{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(where)
    return root


def _pretrain_argv(root, out, *extra):
    return ["--pretrained_model_name_or_path", str(root / "sd"),
            "--train_image_dataset", str(root / "data"),
            "--domain_class_token", "face",
            "--prompt_template", "a photo of {placeholder_token}",
            "--resolution", "32", "--train_batch_size", "2",
            "--learning_rate", "1e-3", "--report_to", "tensorboard",
            "--output_dir", str(out), "--vit_config", "tiny", "--seed", "0",
            *extra]


def test_cli_chain_pretrain_tune_infer(base_dir, tmp_path):
    """The port pretrains (3 steps, a checkpoint at 2, samples at every
    step), resumes from ``latest`` with the schedule at its count, tunes
    from the artifact and samples from the tuned one, all in-process on the
    CPU; the JAX package loads the pretrain artifact to the same tensors."""
    out = tmp_path / "pre"
    sched = ["--lr_scheduler", "linear", "--lr_warmup_steps", "1",
             "--max_train_steps", "3", "--checkpointing_steps", "2",
             "--device", "cpu"]
    first = pretrain_e4t.main(_pretrain_argv(
        base_dir, out, *sched, "--log_steps", "1", "--n_save_sample", "1",
        "--save_inference_steps", "2", "--save_sample_prompt",
        "a photo of *s"))
    assert first["global_step"] == 3 and first["resumed_from"] is None
    assert sorted(os.listdir(out)) == ["2", "3", "checkpoint-2", "logs",
                                       "samples"]
    assert sorted(os.listdir(out / "3")) == ["config.json", "encoder.pt",
                                             "weight_offsets.pt"]
    assert first["sampled"] == [1, 2, 3]
    images = first["last_samples"]
    assert images.shape == (1, 3, 32, 32)
    assert np.isfinite(images).all()
    assert images.min() >= 0.0 and images.max() <= 1.0
    for step in (1, 2, 3):
        assert Image.open(out / "samples" / f"sample-{step}.png").size == (
            32, 32)
    schedule = make_lr_schedule("linear", 1e-3, 1, 3)
    assert [m["lr"] for m in first["metrics"]] == [schedule(n)
                                                   for n in range(3)]
    assert all(np.isfinite(m[k]) for m in first["metrics"]
               for k in ("loss", "loss_diff", "loss_reg", "grad_norm"))

    again = pretrain_e4t.main(_pretrain_argv(
        base_dir, out, *sched, "--resume_from_checkpoint", "latest",
        "--n_save_sample", "0"))
    assert again["resumed_from"] == str(out / "checkpoint-2")
    assert again["global_step"] == 3 and len(again["metrics"]) == 1
    assert again["metrics"][0]["lr"] == schedule(2)

    # the JAX package reads the artifact to the port's tensors
    run = str(out / "3")
    config = jax_load_config(run)
    assert config.vit_config == "tiny" and config.placeholder_token == "*s"
    base = jax_artifacts.load_sd_base(str(base_dir / "sd"))
    enc_cfg = jax_artifacts.e4t_encoder_config_from_args(
        JaxAttributeDict(config.to_dict()),
        word_embedding_dim=base["text_config"].hidden_size,
        unet_config=base["unet_config"])
    loaded = jax_artifacts.load_e4t_weights(run, base, enc_cfg)
    offsets = convert.offsets_from_jax(
        jax.tree_util.tree_map(np.asarray, loaded["offsets"]))
    saved = torch.load(os.path.join(run, "weight_offsets.pt"))
    assert set(offsets) == set(saved)
    assert all(torch.equal(offsets[k], saved[k]) for k in saved)
    enc = convert.e4t_encoder_from_jax(
        jax.tree_util.tree_map(np.asarray, loaded["e4t"]),
        enc_cfg.vit.num_layers)
    saved = torch.load(os.path.join(run, "encoder.pt"))
    assert set(enc) == set(saved)
    assert all(torch.equal(enc[k], saved[k]) for k in saved)
    for k, v in again["trainable"]["offsets"].items():
        assert torch.equal(v.detach(), offsets[k])

    # a base directory holding encoder.pt / weight_offsets.pt is resumed
    # from, strictly; one without them starts from the seeded init
    args = pretrain_e4t.parse_args(_pretrain_argv(base_dir, tmp_path / "x"))
    args.pretrained_model_name_or_path = run
    modules = E4TModules.tiny(device="cpu")
    start = pretrain_e4t.load_e4t_start(args, modules, torch.device("cpu"))
    assert set(start) == set(offsets)
    assert all(torch.equal(start[k], offsets[k]) for k in offsets)
    got = modules.e4t_encoder.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    args.pretrained_model_name_or_path = str(base_dir / "sd")
    fresh = [pretrain_e4t.load_e4t_start(args, m, torch.device("cpu"))
             for m in (modules, E4TModules.tiny(device="cpu"))]
    assert all(torch.equal(fresh[0][k], fresh[1][k]) for k in fresh[0])
    assert not torch.equal(modules.e4t_encoder.final_linear.weight,
                           saved["final_linear.weight"])

    Image.fromarray(np.random.default_rng(4).integers(
        0, 255, (40, 40, 3), dtype=np.uint8)).save(tmp_path / "in.png")
    tuning_e4t.main([
        "--pretrained_model_name_or_path", run,
        "--train_image_path", str(tmp_path / "in.png"),
        "--resolution", "32", "--train_batch_size", "2",
        "--max_train_steps", "2", "--output_dir", str(tmp_path / "tune"),
        "--seed", "0", "--device", "cpu"])
    inference.main([
        "--pretrained_model_name_or_path", str(tmp_path / "tune" / "2"),
        "--image_path_or_url", str(tmp_path / "in.png"),
        "--prompt", "a photo of *s", "--num_inference_steps", "2",
        "--guidance_scale", "2.0", "--height", "16", "--width", "16",
        "--seed", "1", "--device", "cpu",
        "--output", str(tmp_path / "grid.png")])
    assert Image.open(tmp_path / "grid.png").size == (16, 16)


def test_sampling_leaves_training_unchanged(base_dir, tmp_path):
    """Two steps with a sample after each give the same trainables and
    AdamW state, bit for bit, as the same run without samples."""
    runs = []
    for name, n in (("with", "1"), ("without", "0")):
        result = pretrain_e4t.main(_pretrain_argv(
            base_dir, tmp_path / name, "--max_train_steps", "2",
            "--log_steps", "1", "--n_save_sample", n,
            "--save_inference_steps", "2", "--save_sample_prompt",
            "a photo of *s", "--device", "cpu"))
        runs.append(result)
    assert runs[0]["sampled"] == [1, 2] and not runs[1]["sampled"]
    assert runs[1]["last_samples"] is None
    a, b = runs
    for g in a["trainable"]:
        for k in a["trainable"][g]:
            assert torch.equal(a["trainable"][g][k], b["trainable"][g][k])
    sa, sb = a["optimizer"].state_dict(), b["optimizer"].state_dict()
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert [m["loss"] for m in a["metrics"]] == [m["loss"]
                                                  for m in b["metrics"]]


def test_cli_needs_a_gpu_unless_asked_for_cpu(base_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_e4t.main(_pretrain_argv(base_dir, tmp_path / "never"))
    assert not (tmp_path / "never").exists()


def test_cli_refuses_unported_flags_and_checks_the_class_token(base_dir,
                                                               tmp_path):
    argv = _pretrain_argv(base_dir, tmp_path / "out", "--device", "cpu")
    # the training extras parse to the JAX CLI's defaults
    args = pretrain_e4t.parse_args(argv)
    assert (args.use_8bit_adam, args.profile_steps, args.profile_dir) == (
        False, 0, None)
    args = pretrain_e4t.parse_args(argv + ["--use_8bit_adam",
                                           "--profile_steps", "2",
                                           "--profile_dir", "x"])
    assert (args.use_8bit_adam, args.profile_steps, args.profile_dir) == (
        True, 2, "x")
    with pytest.raises(SystemExit):
        pretrain_e4t.parse_args(argv + ["--profile_steps", "two"])
    # the multi-card flags are taken and reach the mesh: tp=2 needs a
    # torchrun launch of two processes
    args = pretrain_e4t.parse_args(argv + ["--zero1", "--tensor_parallel",
                                           "2"])
    assert (args.zero1, args.tensor_parallel) == (True, 2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        pretrain_e4t.main(argv + ["--tensor_parallel", "2"])
    assert not (tmp_path / "out").exists()
    args = pretrain_e4t.parse_args(argv + [
        "--enable_xformers_memory_efficient_attention", "--max_grad_norm",
        "0.5", "--num_train_epochs", "3", "--revision", "main"])
    assert (args.mixed_precision, args.micro_batches, args.report_to) == (
        "no", 1, "tensorboard")
    assert pretrain_e4t.parse_args(argv[:-2] + ["--domain_class_token",
                                                "face"]).device == "cuda"
    two_tokens = argv[:]
    two_tokens[two_tokens.index("face")] = "monet style"
    with pytest.raises(ValueError, match="single token"):
        pretrain_e4t.main(two_tokens)


def test_cli_8bit_profile_window_and_checkpoint(base_dir, tmp_path):
    """Eleven tiny updates with ``--use_8bit_adam --profile_steps 1``: the
    trace of update 11 (the window [10, 11)) is written into
    ``<output_dir>/profile``; checkpoint-10 holds the 8-bit state (int8
    codes, f32 scales) of update 10, and restores into a fresh optimizer
    bit for bit."""
    import json

    from e4t_diffusion_torch.training.optim8bit import AdamW8bit

    out = tmp_path / "p8"
    result = pretrain_e4t.main(_pretrain_argv(
        base_dir, out, "--max_train_steps", "11", "--checkpointing_steps",
        "10", "--n_save_sample", "0", "--use_8bit_adam", "--profile_steps",
        "1", "--device", "cpu"))
    assert result["global_step"] == 11
    assert result["profile_dir"] == str(out / "profile")
    traces = list((out / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {"aten::mm", "aten::convolution"} <= names
    opt = result["optimizer"]
    assert isinstance(opt, AdamW8bit)
    payload = torch.load(out / "checkpoint-10" / "train_state.pt",
                         weights_only=True)
    saved = payload["optimizer"]["state"]
    assert {st["step"] for st in saved.values()} == {10}
    for st in saved.values():
        assert st["mu_q"].dtype == st["nu_q"].dtype == torch.int8
        assert st["mu_scale"].dtype == torch.float32
    trainable = {g: {k: torch.zeros_like(t) for k, t in grp.items()}
                 for g, grp in result["trainable"].items()}
    fresh = ts.make_optimizer([t for g in trainable.values()
                               for t in g.values()], 1e-3, use_8bit=True)
    artifacts.restore_train_state(str(out / "checkpoint-10"), trainable,
                                  fresh, torch.Generator())
    restored = fresh.state_dict()["state"]
    assert set(restored) == set(saved)
    for i, st in saved.items():
        for k, v in st.items():
            got = restored[i][k]
            assert (got == v) if k == "step" else (
                got.dtype == v.dtype and torch.equal(got, v)), (i, k)


def test_cli_sigterm_saves_a_checkpoint_that_restores(base_dir, tmp_path):
    """SIGTERM after the first update: the run saves checkpoint-<n> at the
    next update boundary and its artifacts, exits 0, and the checkpoint
    restores into the same trainables."""
    out = tmp_path / "sigterm"
    cmd = [sys.executable, "-m", "e4t_diffusion_torch.pretrain_e4t",
           *_pretrain_argv(base_dir, out, "--max_train_steps", "100000",
                           "--checkpointing_steps", "100000",
                           "--n_save_sample", "0", "--device", "cpu")]
    proc = subprocess.Popen(cmd, cwd=REPO, env={**os.environ, **ONE_THREAD},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    buf = bytearray()
    reader = threading.Thread(target=lambda: [
        buf.extend(c) for c in iter(lambda: proc.stdout.read(64), b"")],
        daemon=True)
    reader.start()
    try:
        deadline = time.time() + 240
        while b"step 1:" not in bytes(buf):
            assert proc.poll() is None, bytes(buf).decode()[-3000:]
            assert time.time() < deadline, "no update before the deadline"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    reader.join(timeout=10)
    text = bytes(buf).decode(errors="replace")
    assert rc == 0, text[-3000:]
    assert "Preemption (received SIGTERM)" in text, text[-3000:]
    ckpts = [d for d in os.listdir(out) if d.startswith("checkpoint-")]
    assert len(ckpts) == 1, os.listdir(out)
    step = int(ckpts[0].split("-")[1])
    assert str(step) in os.listdir(out)  # the artifacts of that step
    payload = torch.load(out / ckpts[0] / "train_state.pt")
    assert payload["step"] == payload["updates"] == step
    saved = torch.load(out / str(step) / "weight_offsets.pt")
    for k, v in saved.items():
        assert torch.equal(payload["trainable"]["offsets"][k], v), k
