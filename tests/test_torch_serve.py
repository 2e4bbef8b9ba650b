"""The port's serving entry points on the CPU, on a tiny artifact directory
written by the JAX package's helpers: the inference CLI with each of the six
schedulers, a LoRA file and the int8 towers; the flags still refused; the
batch server (``python -m e4t_diffusion_torch.serve_e4t``) on three prompts
at batch 2 (one padded batch), a bad prompt refused before any render, and
its interactive mode."""
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from e4t_diffusion_torch import inference, serve_e4t
from e4t_diffusion_torch.models import lora
from e4t_diffusion_torch.models.unet import UNetConfig
from e4t_diffusion_torch.parallel import mesh as pmesh

from test_torch_pipeline import PROMPTS, artifact_dir  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lora_file(tmp_path_factory):
    """A rank-2 LoRA file for the tiny UNet with non-zero ``up``."""
    gen = torch.Generator().manual_seed(5)
    bank = lora.init_lora_bank(UNetConfig.tiny(), rank=2, generator=gen)
    for layers in bank.values():
        for layer in layers.values():
            layer["up"] = 0.1 * torch.randn(layer["up"].shape, generator=gen)
    path = tmp_path_factory.mktemp("lora") / "pytorch_lora_weights.bin"
    torch.save(lora.lora_to_torch(bank), path)
    return str(path)


def _infer(root, out_dir, output, *extra):
    inference.main(["--pretrained_model_name_or_path", out_dir,
                    "--image_path_or_url", str(root / "in.png"),
                    "--prompt", PROMPTS[0], "--num_inference_steps", "2",
                    "--guidance_scale", "2.0", "--height", "16", "--width",
                    "16", "--seed", "1", "--device", "cpu", "--output",
                    str(output), *extra])
    return np.asarray(Image.open(output)).astype(np.int16)


def test_inference_cli_schedulers_lora_and_int8_aux(artifact_dir,  # noqa: F811
                                                    lora_file, tmp_path):
    root, out_dir = artifact_dir
    grids = {}
    for name in ("ddim", "plms", "lms", "euler", "euler_ancestral",
                 "dpm_solver++"):
        grids[name] = _infer(root, out_dir, tmp_path / f"{name}.png",
                             "--scheduler_type", name,
                             "--num_inference_steps", "3")
        assert grids[name].shape == (16, 16, 3)
    assert len({g.tobytes() for g in grids.values()}) == 6
    lora_grid = _infer(root, out_dir, tmp_path / "lora.png",
                       "--lora_weights", lora_file, "--lora_scale", "0.8")
    assert np.abs(lora_grid - grids["ddim"]).max() > 1
    for flags in (["--int8_aux"], ["--int8_aux_static"],
                  ["--int8_static_act", "--int8_aux_static",
                   "--lora_weights", lora_file]):
        grid = _infer(root, out_dir, tmp_path / "aux.png", *flags)
        assert grid.shape == (16, 16, 3)
    for flags, mode in (([], False), (["--int8_aux"], True),
                        (["--int8_aux_static"], "static"),
                        (["--int8_aux", "--int8_aux_static"], "static")):
        args = inference.parse_args(["--pretrained_model_name_or_path", "-",
                                     "--image_path_or_url", "-", *flags])
        assert inference.int8_aux_mode(args) == mode


@pytest.mark.parametrize("flags", [["--tensor_parallel", "2"],
                                   ["--data_parallel_serving"]])
def test_parallel_serving_flags_are_refused(flags, monkeypatch):
    """Tensor- and data-parallel serving are ported (the name is the one
    this test had while they were not): both entry points take their flags
    and build_pipeline reaches the mesh first. One process is the
    one-process mesh (dp=1); tp=2 there asks for a torchrun launch."""
    for k in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    parsed = [
        inference.parse_args(["--pretrained_model_name_or_path", "-",
                              "--image_path_or_url", "-", "--device", "cpu",
                              *flags]),
        serve_e4t.parse_args(["--pretrained_model_name_or_path", "-",
                              "--image_path", "-", "--device", "cpu",
                              *flags])]
    for args in parsed:
        if args.tensor_parallel > 1:
            with pytest.raises(ValueError,
                               match="torchrun --nproc_per_node 2"):
                inference.build_pipeline(args)
        else:
            assert args.data_parallel_serving
            # past the mesh, the artifact name "-" is resolved
            # (utils/hub.py): neither a local path nor a registry name
            with pytest.raises(AssertionError, match="neither a local path"):
                inference.build_pipeline(args)


def _serve(root, out_dir, prompts, output_dir, *extra):
    path = output_dir.parent / f"{output_dir.name}.txt"
    path.write_text("# prompts\n\n" + "\n".join(prompts) + "\n",
                    encoding="utf-8")
    return serve_e4t.main([
        "--pretrained_model_name_or_path", out_dir,
        "--image_path", str(root / "in.png"), "--prompts_file", str(path),
        "--batch_size", "2", "--num_inference_steps", "2",
        "--guidance_scale", "2.0", "--height", "16", "--width", "16",
        "--seed", "3", "--device", "cpu", "--output_dir", str(output_dir),
        *extra])


def test_serve_batches_and_pads(artifact_dir, tmp_path, capsys):  # noqa: F811
    """Three prompts at batch 2: two batches, the second padded with its
    prompt; each image is the one its prompt's standalone run gives at the
    batch's seed (deterministic DDIM)."""
    root, out_dir = artifact_dir
    prompts = [PROMPTS[0], PROMPTS[1], "a photo of a *s"]
    out = tmp_path / "served"
    pipe, record = _serve(root, out_dir, prompts, out)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == record
    assert (record["images"], record["batch_size"]) == (3, 2)
    assert len(record["batch_walls_s"]) == 2
    assert record["value"] == pytest.approx(1 / record["batch_walls_s"][1])
    with open(out / "manifest.jsonl", encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    assert [r["prompt"] for r in rows] == prompts
    assert [r["warmup_batch"] for r in rows] == [True, True, False]
    assert sorted(os.listdir(out)) == ["00000.png", "00001.png", "00002.png",
                                       "manifest.jsonl"]
    image = Image.open(root / "in.png").convert("RGB")
    alone = pipe(prompts[2], image, num_inference_steps=2,
                 guidance_scale=2.0, height=16, width=16, seed=3 + 2,
                 output_type="pil")[0]
    served = np.asarray(Image.open(out / "00002.png")).astype(np.int16)
    assert np.abs(served - np.asarray(alone).astype(np.int16)).max() <= 1


def test_serve_refuses_a_bad_prompt_before_rendering(artifact_dir,  # noqa: F811
                                                     tmp_path, monkeypatch):
    root, out_dir = artifact_dir
    from e4t_diffusion_torch.diffusion import pipeline as pl

    def never(*args, **kwargs):
        raise AssertionError("rendered before validating every prompt")

    monkeypatch.setattr(pl.StableDiffusionE4TPipeline, "__call__", never)
    out = tmp_path / "bad"
    with pytest.raises(SystemExit, match="prompt 2: 'a photo of a face'"):
        _serve(root, out_dir, [PROMPTS[0], PROMPTS[1], "a photo of a face"],
               out)
    assert not out.exists() or not os.listdir(out)


def test_serve_interactive(artifact_dir, tmp_path, monkeypatch):  # noqa: F811
    root, out_dir = artifact_dir
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"{PROMPTS[1]}\n\nno placeholder here\n"))
    out = tmp_path / "live"
    pipe, record = serve_e4t.main([
        "--pretrained_model_name_or_path", out_dir,
        "--image_path", str(root / "in.png"), "--interactive",
        "--num_inference_steps", "1", "--height", "16", "--width", "16",
        "--device", "cpu", "--output_dir", str(out)])
    assert record is None
    assert sorted(os.listdir(out)) == ["interactive-0.png"]
