"""Multi-rank training in the port on the CPU (gloo, spawned ranks): the
data-parallel pretraining step against the JAX step at the global batch,
ZeRO-1 against replicated AdamW, and the pretraining CLI at dp=2 under
ZeRO-1 (per-rank images and draws, a SIGTERM to one rank, the checkpoint's
per-rank state). The tuning step's grids are in
``tests/test_torch_parallel_tune.py``.

The JAX pretraining step runs once, jitted, at batch 2 in a module-scoped
fixture, its draws handed to the port as in ``tests/test_torch_pretrain.py``;
each of the two ranks takes one row. The ranks are spawned once a fixture
(``torch_parallel_workers.run_ranks``, each spawn bounded by its own
timeout).

Tolerances, f32 on the CPU: against JAX those of the one-process
pretraining step (loss terms rel 1e-5, per-group gradients rel-L2 1e-4,
parameters after AdamW 1e-5 absolute); ZeRO-1 against replicated AdamW
atol 1e-5, rtol 1e-4 (the JAX package's ``tests/test_zero1.py``). The two
ranks of a data-parallel step end with the same parameters bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from e4t_diffusion_tpu.training import train_step as jax_ts

from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

import torch_parallel_workers as workers
from test_artifacts import _write_sd_base
from test_torch_pretrain import (CFG, LR, _batch, _pretrain_argv,
                                 _torch_batch, WORDS)
from test_torch_train_step import _keep_grads, _port_names
from torch_parity import jax_tiny, port_tiny

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
ZERO1_ATOL, ZERO1_RTOL = 1e-5, 1e-4


def jax_reference(cfg):
    """The JAX step (``cfg``: E4TTrainConfig fields) at batch 2 on the
    tiny weights: the port's weights and batch with the step's draws, the
    metrics, the raw gradients and the trainables before and after, under
    the port's names."""
    jm, params = jax_tiny(seed=11)
    jcfg = jax_ts.E4TTrainConfig(**cfg)
    tx = optax.chain(_keep_grads(), jax_ts.make_optimizer(LR, jcfg))
    state, frozen = jax_ts.create_train_state(params, jcfg, tx)
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    step = jax.jit(jax_ts.make_train_step(jm, JaxDDPM(), jcfg, tx))
    new_state, metrics = step(state, frozen,
                              jax.tree_util.tree_map(jnp.asarray, batch), rng)
    k_noise, k_t, k_vae = jax.random.split(jax.random.fold_in(rng, 0), 3)
    shape = (2, 4, 16, 16)
    draws = {
        "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(
            k_t, (2,), 0, JaxDDPM().config.num_train_timesteps)),
        "posterior_noise": np.array(jax.random.normal(
            k_vae, shape, jnp.float32))}
    n_text = jm.text_encoder.config.num_layers
    n_vit = jm.e4t_encoder.config.vit.num_layers

    def port_named(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return {g: _port_names(g, tree[g], frozen, n_text, n_vit)
                for g in tree}

    _, sds = port_tiny(params)
    return {"sds": sds, "batch": _torch_batch(batch, draws),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": port_named(new_state.opt_state[0].grads),
            "before": port_named(state.trainable),
            "after": port_named(new_state.trainable)}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX pretraining step at batch 2, its draws and results."""
    return jax_reference(CFG)


@pytest.fixture(scope="module")
def world2(jax_step, tmp_path_factory):
    """One spawn of two ranks: the dp=2 pretraining step replicated and
    under ZeRO-1."""
    payload = {"sds": jax_step["sds"], "batch": jax_step["batch"], "lr": LR,
               "cases": [("dp", 1, False, CFG), ("zero1", 1, True, CFG)]}
    return workers.run_ranks(workers.train_cases, 2, payload,
                             tmp_path_factory.mktemp("world2"))


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_dp2_pretraining_step_matches_jax_at_the_global_batch(jax_step,
                                                              world2):
    """Each rank one row, gradients averaged over dp: the losses (averaged
    over dp), the gradients AdamW sees and the parameters after it are the
    JAX step's at batch 2."""
    for rank in world2:
        got = rank["dp"]
        for k in ("loss", "loss_diff", "loss_reg"):
            want = jax_step["metrics"][k]
            assert _rel(got["metrics"][k], want) <= LOSS_TOL, k
        assert _rel(got["metrics"]["grad_norm"],
                    jax_step["metrics"]["grad_norm"]) <= GRAD_TOL
        for group in ("e4t", "offsets"):
            g, want = got["grads"][group], jax_step["grads"][group]
            num = sum(float((g[k] - want[k]).double().norm() ** 2)
                      for k in want)
            den = sum(float(want[k].double().norm() ** 2) for k in want)
            assert den > 0 and (num / den) ** 0.5 <= GRAD_TOL, group
            for k, w in jax_step["after"][group].items():
                assert float((got["after"][group][k] - w).abs().max()) \
                    <= PARAM_TOL, (group, k)


def test_dp_ranks_end_with_the_same_parameters(world2):
    for case in ("dp", "zero1"):
        a, b = world2[0][case]["after"], world2[1][case]["after"]
        for group in a:
            for k in a[group]:
                assert torch.equal(a[group][k], b[group][k]), (case, k)


def test_zero1_matches_replicated_adamw(world2):
    """ZeRO-1's update equals the replicated one, and its consolidated
    state has the replicated optimizer's layout and values."""
    ranks = world2
    for rank in ranks:
        z, r = rank["zero1"], rank["dp"]
        for group in r["after"]:
            for k in r["after"][group]:
                torch.testing.assert_close(z["after"][group][k],
                                           r["after"][group][k],
                                           atol=ZERO1_ATOL, rtol=ZERO1_RTOL)
    sz, sr = ranks[0]["zero1"]["optimizer"], ranks[0]["dp"]["optimizer"]
    assert sz is not None and ranks[1]["zero1"]["optimizer"] is None
    assert sorted(sz["state"]) == sorted(sr["state"])
    for i, st in sr["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sz["state"][i][k], st[k],
                                       atol=ZERO1_ATOL, rtol=ZERO1_RTOL)
    assert [g["params"] for g in sz["param_groups"]] == \
        [g["params"] for g in sr["param_groups"]]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The pretraining CLI on two ranks with --zero1: rank 1 receives
    SIGTERM in its first update."""
    root = tmp_path_factory.mktemp("cli")
    jm, params = jax_tiny(seed=3)
    sd_dir = _write_sd_base(str(root / "sd"), jm,
                            jax.tree_util.tree_map(np.asarray, params))
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=WORDS)
    os.makedirs(root / "data")
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(root / "data" / f"{i}.png")
    out = root / "out"
    argv = _pretrain_argv(root, out, "--device", "cpu", "--zero1",
                          "--max_train_steps", "3", "--n_save_sample", "0",
                          "--checkpointing_steps", "100")
    # short templates: the tiny text model holds 16 tokens
    templates = [t.replace("*", "{placeholder_token}") for t in (
        "a photo of *", "a * face", "the * photo", "a photo of the *",
        "a * in the style", "the face of *")]
    return workers.run_ranks(workers.pretrain_sigterm, 2,
                             {"argv": argv, "out": str(out),
                              "templates": templates}, root / "run")


def test_sigterm_to_one_rank_stops_both_at_the_same_update(cli_run):
    assert [r["global_step"] for r in cli_run] == [1, 1]
    assert [len(r["seen"]["ids"]) for r in cli_run] == [1, 1]
    assert [r["restored"] for r in cli_run] == [{"step": 1,
                                                 "updates": 1}] * 2


def test_ranks_read_their_own_images_and_draw_their_own_noise(cli_run):
    """Disjoint images, different templates and generator streams."""
    a, b = (r["seen"] for r in cli_run)
    pa = {x.numpy().tobytes() for x in a["pixels"][0]}
    pb = {x.numpy().tobytes() for x in b["pixels"][0]}
    assert len(pa) == len(pb) == 2 and not pa & pb
    assert not torch.equal(a["gen"][0], b["gen"][0])
    assert not torch.equal(a["ids"][0], b["ids"][0])


def test_checkpoint_keeps_every_ranks_state_bit_for_bit(cli_run):
    """Saved under ZeRO-1 at world 2 and restored into fresh state: the
    trainables and the consolidated optimizer state bit for bit, and each
    rank its own generator."""
    for r in cli_run:
        assert torch.equal(r["restored_generator"], r["saved_generator"])
        for g, tensors in r["trainable"].items():
            for k, t in tensors.items():
                assert torch.equal(r["restored_trainable"][g][k], t), k
    assert not torch.equal(cli_run[0]["saved_generator"],
                           cli_run[1]["saved_generator"])
    want, got = cli_run[0]["optimizer"], cli_run[0]["restored_optimizer"]
    assert sorted(want["state"]) == sorted(got["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
