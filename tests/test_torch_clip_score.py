"""The port's CLIP scorer against the JAX package, on the CPU.

The same weights (numpy, from a seed) in both packages' tiny ``CLIPScorer``;
pixels and ids made with numpy from a seed. Tolerances, in f32: image and
text features rel-L2 <= 1e-5, CLIP-I / CLIP-T abs <= 1e-5; the scoring CLI
against the JAX script on one tiny open_clip file: each score abs <= 1e-5.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.models import clip_score as jax_cs

from e4t_diffusion_torch import evaluate_clip_scores as score_cli
from e4t_diffusion_torch.models import clip_score as cs
from e4t_diffusion_torch.utils.convert import clip_scorer_from_jax
from e4t_diffusion_torch.utils.tokenizer import make_tiny_tokenizer_files

from torch_parity import _fill, rel_l2

FEATURES_REL_L2 = 1e-5
SCORE_ABS = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny77():
    """The tiny scorer with the scripts' 77-token context."""
    cfg = cs.CLIPScoreConfig.tiny()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, context_length=77))


def _jax_config(cfg):
    return jax_cs.CLIPScoreConfig(
        vit=jax_cs.ViTConfig(**dataclasses.asdict(cfg.vit)),
        text=jax_cs.OpenCLIPTextConfig(**dataclasses.asdict(cfg.text)),
        embed_dim=cfg.embed_dim)


def _world(cfg, seed=0):
    jcfg = _jax_config(cfg)
    jm = jax_cs.CLIPScorer(jcfg)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)),
        jnp.zeros((1, jcfg.text.context_length), jnp.int32))["params"]
    params = _fill(shapes, np.random.default_rng(seed))
    model = cs.CLIPScorer(cfg).eval()
    model.load_state_dict(clip_scorer_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    return jm, params, model


@pytest.fixture(scope="module")
def tiny():
    return _world(cs.CLIPScoreConfig.tiny())


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    pix = rng.uniform(-1, 1, (2, 3, 40, 40)).astype(np.float32)
    ids = rng.integers(1, 500, (2, cfg.text.context_length))
    return pix, ids


def test_features_and_scores_match_jax(tiny):
    jm, params, model = tiny
    pix, ids = _inputs(model.config, 1)
    jimg, jtxt = jm.apply({"params": params}, jnp.asarray(pix),
                          jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        img, txt = model(torch.from_numpy(pix), torch.from_numpy(ids))
    assert rel_l2(img, jimg) <= FEATURES_REL_L2
    assert rel_l2(txt, jtxt) <= FEATURES_REL_L2
    np.testing.assert_allclose(img.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    for fn, jfn, args, jargs in (
            (cs.clip_i, jax_cs.clip_i, (img, img.flip(0)),
             (jimg, jimg[::-1])),
            (cs.clip_t, jax_cs.clip_t, (img, txt), (jimg, jtxt))):
        score = float(fn(*args))
        assert -1.0 <= score <= 1.0
        assert abs(score - float(jfn(*jargs))) <= SCORE_ABS
    assert abs(float(cs.clip_i(img, img)) - 1.0) <= 1e-6


def test_eot_pooling_takes_argmax_token(tiny):
    """The text features sit at the largest id: a token after it changes
    nothing (causal attention), one before it does; as in JAX."""
    jm, params, model = tiny
    length = model.config.text.context_length
    base = np.zeros((1, length), np.int64)
    base[0, 3] = 599
    after, before = base.copy(), base.copy()
    after[0, 10] = 77
    before[0, 1] = 77
    with torch.no_grad():
        feats = [model.text_features(torch.from_numpy(x))
                 for x in (base, after, before)]
    assert torch.allclose(feats[0], feats[1], atol=1e-6)
    assert not torch.allclose(feats[0], feats[2], atol=1e-4)
    want = jm.apply({"params": params}, jnp.asarray(before, jnp.int32),
                    method=jax_cs.CLIPScorer.text_features)
    assert rel_l2(feats[2], want) <= FEATURES_REL_L2


def _open_clip_state_dict(model):
    """The port scorer's weights under open_clip's names, with the buffers
    the scorer ignores."""
    sd = {}
    for k, v in model.state_dict().items():
        if k == "visual_proj":
            sd["visual.proj"] = v.clone()
        elif k.startswith("text."):
            sd[k[len("text."):]] = v.clone()
        else:
            sd[k] = v.clone()
    length = model.config.text.context_length
    sd["logit_scale"] = torch.tensor(4.6052)
    sd["attn_mask"] = torch.full((length, length), float("-inf")).triu(1)
    return sd


def test_scorer_from_open_clip_strict(tiny):
    """An open_clip file maps onto the scorer (the JAX package's converter
    reads it to the same features); a missing or extra key raises."""
    jm, _, model = tiny
    cfg = model.config
    sd = _open_clip_state_dict(model)
    loaded = cs.CLIPScorer(cfg).eval()
    loaded.load_state_dict(cs.scorer_from_open_clip(sd, cfg), strict=True)
    jparams = jax_cs.scorer_from_open_clip(
        {k: v.numpy() for k, v in sd.items()}, _jax_config(cfg))
    pix, ids = _inputs(cfg, 2)
    jimg, jtxt = jm.apply({"params": jparams}, jnp.asarray(pix),
                          jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        img, txt = loaded(torch.from_numpy(pix), torch.from_numpy(ids))
    assert rel_l2(img, jimg) <= FEATURES_REL_L2
    assert rel_l2(txt, jtxt) <= FEATURES_REL_L2
    missing = {k: v for k, v in sd.items() if k != "ln_final.bias"}
    with pytest.raises(KeyError, match="text.ln_final.bias"):
        cs.scorer_from_open_clip(missing, cfg)
    with pytest.raises(KeyError, match="text.stray"):
        cs.scorer_from_open_clip({**sd, "stray": torch.zeros(1)}, cfg)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_clip_scores",
        os.path.join(REPO, "scripts", "evaluate_clip_scores.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_matches_jax_script(tmp_path, monkeypatch, capsys):
    """Both scripts on one tiny open_clip file (the scorer's config swapped
    for the tiny one with a 77-token context), one tokenizer and the same
    images: the same JSON line."""
    from PIL import Image

    cfg = _tiny77()
    _, _, model = _world(cfg, seed=3)
    weights = str(tmp_path / "open_clip.pt")
    torch.save(_open_clip_state_dict(model), weights)
    tok = make_tiny_tokenizer_files(str(tmp_path / "tok"),
                                    extra_words=["a", "photo", "of", "face"])
    gen = tmp_path / "gen"
    gen.mkdir()
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(((40, 40), (48, 36), (30, 30))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(gen / f"{i}.png")
    src = str(gen / "0.png")
    argv = ["--generated_dir", str(gen), "--source_image", src, "--prompt",
            "a photo of *s", "--class_word", "face", "--open_clip_weights",
            weights, "--tokenizer_dir", tok, "--resolution", "32"]

    script = _jax_script()
    monkeypatch.setattr(script, "CLIPScoreConfig",
                        lambda: _jax_config(cfg))
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    script.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(score_cli, "CLIPScoreConfig", lambda: cfg)
    got = score_cli.main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert got["n_images"] == want["n_images"] == 3
    for key in ("clip_i", "clip_t"):
        assert abs(got[key] - want[key]) <= SCORE_ABS
    # the source scored against itself among the generated images
    with torch.no_grad():
        pix = torch.from_numpy(score_cli.load_pixels(src, 32))
        feats = model.image_features(pix)
    assert abs(float(cs.clip_i(feats, feats)) - 1.0) <= 1e-6
