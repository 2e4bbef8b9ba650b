"""The whole slice on the CPU: the port's tiny StableDiffusionE4TPipeline
against the JAX pipeline on the same weights and injected latents, and the
port's inference CLI on a tiny artifact directory written by the JAX
package's own helpers."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.config import AttributeDict as JaxAttributeDict
from e4t_diffusion_tpu.diffusion.pipeline import (
    StableDiffusionE4TPipeline as JaxPipeline)
from e4t_diffusion_tpu.utils import artifacts as jax_artifacts
from e4t_diffusion_tpu.utils.tokenizer import (
    CLIPTokenizer as JaxTokenizer, make_tiny_tokenizer_files)

from e4t_diffusion_torch.config import AttributeDict
from e4t_diffusion_torch.diffusion.pipeline import (
    E4TModules, StableDiffusionE4TPipeline)
from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

from test_artifacts import _write_sd_base
from torch_parity import jax_tiny, port_tiny, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E4T_CONFIG = {"placeholder_token": "*s", "domain_class_token": "face",
              "domain_embed_scale": 0.1}
WORDS = ["photo", "of", "a", "face"]
PROMPTS = ["a photo of *s", "a *s face"]
# images in [0, 1] after 3 f32 denoise steps and a VAE decode; the two
# stacks agree to ~4e-6, so 1e-3 leaves room for summation-order drift
IMAGE_TOL = 1e-3
# the tiny models' ops are too small to gain from threads: one thread a
# process (here and in the CLI subprocesses) keeps several test processes on
# one machine from oversubscribing its cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    jm, params = jax_tiny(seed=1)
    modules, sds = port_tiny(params)
    tok_dir = make_tiny_tokenizer_files(
        str(tmp_path_factory.mktemp("tok")), extra_words=WORDS)
    jax_pipe = JaxPipeline(jm, params,
                           JaxTokenizer.from_pretrained(tok_dir,
                                                        model_max_length=16),
                           JaxAttributeDict(E4T_CONFIG))
    pipe = StableDiffusionE4TPipeline(
        modules, sds["offsets"],
        CLIPTokenizer.from_pretrained(tok_dir, model_max_length=16),
        AttributeDict(E4T_CONFIG))
    image = np.random.default_rng(0).uniform(0, 255, (32, 32, 3)).astype(
        np.uint8)
    return jax_pipe, pipe, image


def _latents(n, seed=2):
    return np.random.default_rng(seed).standard_normal((n, 4, 8, 8)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_images(pipes):
    """The JAX pipeline's images for a sampler setting, computed once a
    module and shared by the tests that compare with them."""
    jax_pipe, _, image = pipes
    cache = {}

    def images(scheduler_type, guidance):
        key = (scheduler_type, guidance)
        if key not in cache:
            cache[key] = np.asarray(jax_pipe(
                PROMPTS, image, num_inference_steps=3,
                guidance_scale=guidance, num_images_per_prompt=2,
                latents=_latents(4), scheduler_type=scheduler_type))
        return cache[key]

    return images


@pytest.mark.parametrize("scheduler_type,guidance", [
    ("ddim", 7.5), ("dpm_solver++", 7.5), ("ddim", 1.0)])
def test_pipeline_matches_jax(pipes, jax_images, scheduler_type, guidance):
    _, pipe, image = pipes
    kwargs = dict(num_inference_steps=3, guidance_scale=guidance,
                  num_images_per_prompt=2, latents=_latents(4),
                  scheduler_type=scheduler_type)
    ref = jax_images(scheduler_type, guidance)
    out = pipe(PROMPTS, image, **kwargs)
    assert out.shape == ref.shape == (4, 3, 16, 16)
    assert np.abs(out - ref).max() <= IMAGE_TOL
    assert not np.allclose(out[0], out[2])  # the two prompts differ


def test_pipeline_seeded_noise_and_batching(pipes):
    """Same seed -> same images; in a batched call each prompt's block
    draws the noise its standalone run would."""
    _, pipe, image = pipes
    a = pipe(PROMPTS, image, num_inference_steps=2, seed=9)
    b = pipe(PROMPTS, image, num_inference_steps=2, seed=9)
    np.testing.assert_array_equal(a, b)
    solo = pipe(PROMPTS[1], image, num_inference_steps=2, seed=9)
    np.testing.assert_allclose(a[1], solo[0], atol=1e-5)


def test_pipeline_output_types(pipes):
    _, pipe, image = pipes
    arr = pipe(PROMPTS[0], image, num_inference_steps=2, seed=3)
    pils = pipe(PROMPTS[0], image, num_inference_steps=2, seed=3,
                output_type="pil")
    lat = pipe(PROMPTS[0], image, num_inference_steps=2, seed=3,
               output_type="latent")
    assert lat.shape == (1, 4, 8, 8)
    assert pils[0].size == (16, 16)
    want = (arr[0].transpose(1, 2, 0) * 255).round()
    assert np.abs(np.asarray(pils[0]).astype(np.float64) - want).max() <= 1.0


def test_pipeline_requires_placeholder(pipes):
    _, pipe, image = pipes
    with pytest.raises(ValueError, match="placeholder"):
        pipe("a photo of face", image, num_inference_steps=1)


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E4TModules.tiny()


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """A tiny pretrain artifact dir, written by the JAX package."""
    root = tmp_path_factory.mktemp("cli")
    jm, params = jax_tiny(seed=3)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd_dir = _write_sd_base(str(root / "sd"), jm, params)
    make_tiny_tokenizer_files(os.path.join(sd_dir, "tokenizer"),
                              extra_words=WORDS)
    config = dict(E4T_CONFIG, pretrained_model_name_or_path=sd_dir,
                  vit_config="tiny")
    out = jax_artifacts.save_e4t_weights(
        str(root / "run"), 2, config, params["e4t"],
        jm.e4t_encoder.config, offsets=params["offsets"])
    Image.fromarray(np.random.default_rng(4).integers(
        0, 255, (40, 40, 3), dtype=np.uint8)).save(root / "in.png")
    return root, out


def _cli(root, out_dir, *extra):
    cmd = [sys.executable, "-m", "e4t_diffusion_torch.inference",
           "--pretrained_model_name_or_path", out_dir,
           "--image_path_or_url", str(root / "in.png"),
           "--prompt", "::".join(PROMPTS), "--num_inference_steps", "2",
           "--guidance_scale", "2.0", "--num_images_per_prompt", "2",
           "--height", "16", "--width", "16", "--seed", "1", *extra]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **ONE_THREAD})


def test_inference_cli_on_cpu(artifact_dir):
    root, out_dir = artifact_dir
    grids = []
    for extra in ((), ("--batch_prompts",)):
        path = root / f"grid{len(extra)}.png"
        proc = _cli(root, out_dir, "--device", "cpu", "--output", str(path),
                    *extra)
        assert proc.returncode == 0, proc.stderr[-2000:]
        grid = Image.open(path)
        assert grid.size == (32, 32)  # 2 images per prompt x 2 prompts
        grids.append(np.asarray(grid).astype(np.int16))
    # one batched run reproduces the per-prompt runs (deterministic DDIM)
    assert np.abs(grids[0] - grids[1]).max() <= 1


def test_inference_cli_refuses_without_gpu(artifact_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root, out_dir = artifact_dir
    proc = _cli(root, out_dir, "--output", str(root / "never.png"))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (root / "never.png").exists()


def test_inference_cli_fp32_resolves_to_f32_on_gpu(artifact_dir,
                                                   monkeypatch):
    """fp32 on a CUDA device is f32 (the f32 attention kernels take its
    flash sites), and the CLI passes it through to the modules it builds;
    auto stays bf16 there. The build is stopped where the modules would be
    made on the card."""
    from e4t_diffusion_torch import inference
    from e4t_diffusion_torch.diffusion.pipeline import resolve_dtype

    cuda = torch.device("cuda")
    assert resolve_dtype("fp32", torch.device("cpu")) == torch.float32
    assert resolve_dtype("fp32", cuda) == torch.float32
    assert resolve_dtype("bf16", cuda) == torch.bfloat16
    assert resolve_dtype("auto", cuda) == torch.bfloat16
    root, out_dir = artifact_dir
    built = {}

    def create(*configs, dtype, device):
        built.update(dtype=dtype, device=device)
        raise KeyboardInterrupt  # stop before anything runs on the card

    monkeypatch.setattr(inference, "resolve_device", lambda name: cuda)
    monkeypatch.setattr(inference.E4TModules, "create", create)
    for name, want in (("fp32", torch.float32), ("auto", torch.bfloat16)):
        with pytest.raises(KeyboardInterrupt):
            inference.main(["--pretrained_model_name_or_path", out_dir,
                            "--image_path_or_url", str(root / "in.png"),
                            "--dtype", name,
                            "--output", str(root / "never.png")])
        assert built == {"dtype": want, "device": cuda}
    assert not (root / "never.png").exists()


@pytest.mark.parametrize("profile_dir", [None, "traces"])
def test_tuning_cli_profiles_steps_2_to_3_with_the_extras(
        artifact_dir, tmp_path, profile_dir):
    """Three tiny tuning updates on the CPU with ``--profile_steps 1``
    (8-bit AdamW, ``dots``, the TensorBoard tracker): a trace of the third
    call is written into ``--profile_dir``, by default
    ``<output_dir>/profile``, and holds the step's host ops."""
    import json

    from e4t_diffusion_torch import tuning_e4t

    root, src = artifact_dir
    out = tmp_path / "out"
    extra = ["--profile_dir", str(tmp_path / profile_dir)] if profile_dir \
        else []
    calls = []
    real = tuning_e4t.make_train_step

    def counting(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(batch, generator=None):
            calls.append(torch.autograd.profiler._is_profiler_enabled)
            return step(batch, generator)

        return wrapped

    tuning_e4t.make_train_step = counting
    try:
        tuning_e4t.main([
            "--pretrained_model_name_or_path", src,
            "--train_image_path", str(root / "in.png"),
            "--prompt_template", "a photo of {placeholder_token}",
            "--resolution", "32", "--train_batch_size", "1",
            "--max_train_steps", "3", "--output_dir", str(out),
            "--device", "cpu", "--profile_steps", "1", "--use_8bit_adam",
            "--remat_policy", "dots", "--report_to", "tensorboard", *extra])
    finally:
        tuning_e4t.make_train_step = real
    assert calls == [False, False, True]
    where = tmp_path / profile_dir if profile_dir else out / "profile"
    traces = list(where.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {"aten::mm", "aten::convolution"} <= names
    assert (out / "3" / "unet.pt").exists()


def test_tuned_artifact_loads_strictly(artifact_dir):
    """A tuning artifact (unet.pt with the offsets embedded, plus
    text_encoder.pt) written by the JAX package loads into the port."""
    from e4t_diffusion_torch.models import weight_offsets as wo
    from e4t_diffusion_torch.utils import artifacts

    root, _ = artifact_dir
    jm, params = jax_tiny(seed=5)
    params = jax.tree_util.tree_map(np.asarray, params)
    config = {"pretrained_args": dict(
        E4T_CONFIG, pretrained_model_name_or_path=str(root / "sd"),
        vit_config="tiny")}
    out = jax_artifacts.save_e4t_weights(
        str(root / "tuned"), 30, config, params["e4t"],
        jm.e4t_encoder.config, offsets=params["offsets"],
        unet_params=params["unet"], text_params=params["text"],
        text_num_layers=jm.text_encoder.config.num_layers)
    base = artifacts.load_sd_base(str(root / "sd"))
    loaded = artifacts.load_e4t_weights(out, base)
    modules, sds = port_tiny(params)
    modules.load_state_dicts({k: loaded[k]
                              for k in ("unet", "vae", "text", "e4t")})
    wo.check_bank(loaded["offsets"], modules.unet.config)
    for name in ("unet", "text", "e4t"):
        for k, v in sds[name].items():
            torch.testing.assert_close(loaded[name][k], v, msg=k)


def _tune_cli(root, src, out, *extra):
    cmd = [sys.executable, "-m", "e4t_diffusion_torch.tuning_e4t",
           "--pretrained_model_name_or_path", src,
           "--train_image_path", str(root / "in.png"),
           "--prompt_template", "a photo of {placeholder_token}",
           "--resolution", "32", "--train_batch_size", "2",
           "--max_train_steps", "2", "--output_dir", str(out), "--seed", "0",
           *extra]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **ONE_THREAD})


def test_tuning_cli_on_cpu(artifact_dir):
    """Two tuning steps on the CPU from a JAX-written pretrain artifact; the
    output loads strictly into the JAX package and samples through the
    port's inference CLI."""
    import json

    from e4t_diffusion_tpu.models import weight_offsets as jax_wo

    root, src = artifact_dir
    proc = _tune_cli(root, src, root / "tuned_cli", "--device", "cpu",
                     "--train_text_encoder", "--lr_scheduler", "cosine",
                     "--lr_warmup_steps", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 2: loss" in proc.stdout
    run = root / "tuned_cli" / "2"
    assert sorted(os.listdir(run)) == ["config.json", "domain.png",
                                       "encoder.pt", "text_encoder.pt",
                                       "unet.pt"]
    with open(run / "config.json", encoding="utf-8") as f:
        config = json.load(f)
    assert config["max_train_steps"] == 2
    assert config["pretrained_args"]["placeholder_token"] == "*s"
    assert Image.open(run / "domain.png").size == (32, 32)

    base = jax_artifacts.load_sd_base(str(root / "sd"))
    enc_cfg = jax_artifacts.e4t_encoder_config_from_args(
        JaxAttributeDict(config["pretrained_args"]),
        word_embedding_dim=base["text_config"].hidden_size,
        unet_config=base["unet_config"])
    loaded = jax_artifacts.load_e4t_weights(str(run), base, enc_cfg)
    assert len(loaded["offsets"]) == len(
        jax_wo.attention_sites(base["unet_config"]))
    assert "text" in loaded

    proc = _cli(root, str(run), "--device", "cpu", "--output",
                str(root / "tuned.png"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert Image.open(root / "tuned.png").size == (32, 32)


def test_tuning_cli_saves_frozen_vit_as_loaded(artifact_dir, tmp_path):
    """In bf16 the frozen ViT tower is held in bf16 while tuning; encoder.pt
    carries it exactly as loaded (f32), and the trained head as trained."""
    from e4t_diffusion_torch import tuning_e4t
    from e4t_diffusion_torch.utils import artifacts

    root, src = artifact_dir
    tuning_e4t.main([
        "--pretrained_model_name_or_path", src,
        "--train_image_path", str(root / "in.png"),
        "--prompt_template", "a photo of {placeholder_token}",
        "--resolution", "32", "--train_batch_size", "1",
        "--max_train_steps", "1", "--output_dir", str(tmp_path),
        "--mixed_precision", "bf16", "--device", "cpu"])
    base = artifacts.load_sd_base(str(root / "sd"))
    given = artifacts.load_e4t_weights(src, base)["e4t"]
    saved = torch.load(tmp_path / "1" / "encoder.pt")
    assert set(saved) == set(given)
    vit = [k for k in given if k.startswith("clip_vision.")]
    assert vit and all(saved[k].dtype == torch.float32 for k in saved)
    for k in vit:
        assert torch.equal(saved[k], given[k]), k
    assert any(not torch.equal(saved[k], given[k])
               for k in given if not k.startswith("clip_vision."))


def test_tuning_cli_refuses_without_gpu(artifact_dir):
    from e4t_diffusion_torch import tuning_e4t

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root, src = artifact_dir
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuning_e4t.main(["--pretrained_model_name_or_path", src,
                         "--train_image_path", str(root / "in.png"),
                         "--mixed_precision", "bf16",
                         "--output_dir", str(root / "never")])
    assert not (root / "never").exists()


def test_tuning_cli_no_resolves_to_f32_on_gpu(artifact_dir, tmp_path,
                                              monkeypatch):
    """--mixed_precision no (the default) is f32 on a CUDA device too, and
    the CLI passes it through to ``tune``; fp16 and bf16 are bf16. The
    training extras parse to the JAX CLI's defaults and choices; the
    reference's ignored flags parse."""
    from e4t_diffusion_torch import tuning_e4t

    cuda = torch.device("cuda")
    for device in (torch.device("cpu"), cuda):
        assert tuning_e4t.resolve_train_dtype("no", device) == torch.float32
    for name in ("bf16", "fp16"):
        assert tuning_e4t.resolve_train_dtype(name, cuda) == torch.bfloat16
    root, src = artifact_dir
    seen = []

    def tune(args, *rest, save=None, mesh=None):
        seen.append(rest[-1])  # the dtype
        raise KeyboardInterrupt  # stop before a step runs

    # the GPU is named (the default --device cuda); the modules are built on
    # the CPU, where this test runs
    monkeypatch.setattr(tuning_e4t, "resolve_device",
                        lambda name: torch.device("cpu"))
    monkeypatch.setattr(tuning_e4t, "tune", tune)
    for extra, want in (([], torch.float32),
                        (["--mixed_precision", "bf16"], torch.bfloat16)):
        with pytest.raises(KeyboardInterrupt):
            tuning_e4t.main(["--pretrained_model_name_or_path", src,
                             "--train_image_path", str(root / "in.png"),
                             "--prompt_template", "a photo of {placeholder_token}",
                             "--output_dir", str(tmp_path / "out"), *extra])
        assert seen.pop() == want
    assert not (tmp_path / "out").exists()
    required = ["--pretrained_model_name_or_path", str(tmp_path / "missing"),
                "--train_image_path", str(tmp_path / "in.png")]
    args = tuning_e4t.parse_args(required)
    assert (args.use_8bit_adam, args.profile_steps, args.profile_dir,
            args.report_to, args.remat_policy, args.logging_dir) == (
        False, 0, None, None, "nothing", "logs")
    args = tuning_e4t.parse_args(required + [
        "--use_8bit_adam", "--profile_steps", "2", "--profile_dir", "p",
        "--report_to", "tensorboard", "--remat_policy", "dots"])
    assert (args.use_8bit_adam, args.profile_steps, args.profile_dir,
            args.report_to, args.remat_policy) == (
        True, 2, "p", "tensorboard", "dots")
    for bad in (["--remat_policy", "everything"], ["--report_to", "csv"]):
        with pytest.raises(SystemExit):
            tuning_e4t.parse_args(required + bad)
    # --tensor_parallel is taken and reaches the mesh, which needs a
    # torchrun launch of two processes for tp=2
    assert tuning_e4t.parse_args(
        required + ["--tensor_parallel", "2"]).tensor_parallel == 2
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tuning_e4t.main(required + ["--tensor_parallel", "2", "--device",
                                    "cpu"])
    args = tuning_e4t.parse_args(required + [
        "--enable_xformers_memory_efficient_attention",
        "--dataloader_num_workers", "4", "--revision", "main",
        "--local_rank", "0", "--logging_dir", "x"])
    assert (args.train_batch_size, args.max_train_steps, args.resolution,
            args.device) == (16, 15, None, "cuda")


def test_inference_cli_accepts_the_reference_xformers_flag(tmp_path):
    """A command copied from the reference's inference.py parses: its
    --enable_xformers_memory_efficient_attention is accepted and ignored,
    as in the port's tuning CLI."""
    from e4t_diffusion_torch import inference

    required = ["--pretrained_model_name_or_path", str(tmp_path / "a"),
                "--image_path_or_url", str(tmp_path / "in.png")]
    args = inference.parse_args(required + [
        "--enable_xformers_memory_efficient_attention", "--prompt",
        "a photo of *s", "--num_inference_steps", "4"])
    assert args.enable_xformers_memory_efficient_attention
    assert (args.num_inference_steps, args.device) == (4, "cuda")
    assert not inference.parse_args(
        required).enable_xformers_memory_efficient_attention


def test_pipeline_int8_static_matches_jax(pipes, jax_images, monkeypatch,
                                         tmp_path):
    """int8="static" with injected latents: the first call calibrates as the
    JAX pipeline does (every site's range to 1e-5 of that range) and later
    calls reuse the ranges; the images carry an int8 error of the size of
    JAX's. They are not compared value by value: over three steps and two
    UNet passes each, f32 ulps that move values across int8 rounding
    boundaries grow into differences of the size of the int8 error itself
    (tests/test_torch_quant.py holds the UNet site by site)."""
    from e4t_diffusion_tpu.ops import quant as jax_quant

    from e4t_diffusion_torch.ops import quant

    monkeypatch.setenv("E4T_INT8_CALIB_STEPS", "2")
    jax_pipe, pipe, image = pipes
    kwargs = dict(num_inference_steps=3, guidance_scale=7.5,
                  num_images_per_prompt=2, latents=_latents(4),
                  scheduler_type="ddim")
    jax8 = JaxPipeline(jax_pipe.modules, jax_pipe.params, jax_pipe.tokenizer,
                       jax_pipe.e4t_config, int8="static",
                       already_added_placeholder_token=True)
    port8 = StableDiffusionE4TPipeline(
        pipe.modules, pipe.offsets, pipe.tokenizer, pipe.e4t_config,
        already_added_placeholder_token=True, int8="static")
    ref8 = np.asarray(jax8(PROMPTS, image, **kwargs))
    out8 = port8(PROMPTS, image, **kwargs)
    ref = jax_images("ddim", 7.5)

    path = str(tmp_path / "jax_scales.json")
    jax_quant.save_act_scales(jax.device_get(jax8._act_amax), path)
    want = quant.load_act_scales(path)
    assert set(port8.act_amax) == set(want)
    for name, site in want.items():
        for k, v in site.items():
            np.testing.assert_allclose(port8.act_amax[name][k].numpy(),
                                       v.numpy(), rtol=0,
                                       atol=1e-5 * float(v.max()))
    jax_err, port_err = rel_l2(ref8, ref), rel_l2(out8, ref)
    assert 1e-3 < jax_err < 0.2
    assert 0.5 * jax_err < port_err < 1.5 * jax_err
    amax = port8.act_amax
    port8(PROMPTS[0], image, num_inference_steps=1)
    assert port8.act_amax is amax


def test_inference_cli_int8_act_scales(artifact_dir):
    """--int8_static_act --act_scales: the first run calibrates and writes
    the file (which the JAX package reads), the second reads it and renders
    the same grid; --int8_attn parses (the CPU has no flash site)."""
    from e4t_diffusion_tpu.ops import quant as jax_quant

    from e4t_diffusion_torch import inference

    root, out_dir = artifact_dir
    scales = root / "scales.json"
    grids = []
    for i in range(2):
        path = root / f"int8_{i}.png"
        proc = _cli(root, out_dir, "--device", "cpu", "--output", str(path),
                    "--int8", "--int8_static_act", "--act_scales",
                    str(scales), "--int8_attn", "qkpv")
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert (("saved" if i == 0 else "loaded") + " activation ranges"
                in proc.stdout)
        grids.append(np.asarray(Image.open(path)))
    np.testing.assert_array_equal(grids[0], grids[1])
    assert len(jax_quant.load_act_scales(str(scales))) > 0
    for flags, mode in (([], False), (["--int8"], True),
                        (["--int8_static_act"], "static"),
                        (["--int8_pc_act"], "static_pc")):
        args = inference.parse_args(["--pretrained_model_name_or_path", "-",
                                     "--image_path_or_url", "-", *flags])
        assert inference.int8_mode(args) == mode
