"""int8 auxiliary towers (``int8_aux``): the ViT-H and the VAE decode in
int8, against the JAX package on the tiny modules.

- the sites each package quantizes, by JAX path: the ViT with the default
  exclusions (its patch conv ``conv1`` included), the VAE with the
  encoder, ``quant_conv`` and the decoder's ``conv_in`` / ``conv_out``
  excluded (``post_quant_conv`` included);
- the patch-conv route of ``conv1`` bit for bit against the int8 conv's
  plain version, in every scale mode;
- the aux calibration's ranges against JAX's ``make_aux_calibration_fn``
  (1e-5 of each site's range);
- tiny sampling with dynamic and with calibrated ("static") aux scales
  against JAX's ``make_sample_fn`` on the same inputs, at the bounds of
  tests/test_quant.py (correlation above 0.97, mean absolute difference
  below 0.05 on images in [0, 1]): two f32 implementations of an int8
  network round some values across int8 boundaries apart, so runs are
  compared by error size, not value by value;
- the pipeline class calibrating the towers once, on the UNet
  calibration's final latents.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.diffusion.pipeline import (
    make_aux_calibration_fn as jax_aux_calibration_fn,
    make_sample_fn as jax_sample_fn)
from e4t_diffusion_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from e4t_diffusion_tpu.ops import quant as jax_quant

from e4t_diffusion_torch.diffusion import pipeline as pl
from e4t_diffusion_torch.diffusion.schedulers import DDIMScheduler
from e4t_diffusion_torch.ops import int8_conv as ic
from e4t_diffusion_torch.ops import quant

from torch_parity import jax_tiny, port_tiny, rel_l2, sampling_args

AMAX_REL = 1e-5
CORR_MIN = 0.97
MEAN_ABS_MAX = 0.05
# calibrated aux scales against dynamic ones on the same run's inputs
# (tests/test_quant.py's bound)
STATIC_VS_DYNAMIC_REL_L2 = 0.15
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    jm, params = jax_tiny(seed=11)
    modules, sds = port_tiny(params)
    jax_args, port_args = sampling_args(jm, params, modules, sds, seed=12)
    # representative decode inputs: the f32 run's final latents
    final = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1,
                              return_latents=True)(*port_args)
    return jm, params, modules, sds, jax_args, port_args, final


def _kernel_paths(tree, prefix=()):
    """JAX paths of the quantized kernels of a quantize_params tree."""
    out = set()
    for k, v in tree.items():
        if jax_quant.is_quantized(v):
            out.add("/".join(prefix))
        elif isinstance(v, dict):
            out |= _kernel_paths(v, prefix + (k,))
    return out


def test_aux_sites_match_jax(world):
    jm, params, modules, _, _, _, _ = world
    (vit, vit_sites), (vae, vae_sites) = pl._aux_sites(modules, None)
    assert vit is modules.e4t_encoder.clip_vision and vae is modules.vae
    want_vit = _kernel_paths(jax_quant.quantize_params(
        params["e4t"]["clip_vision"]))
    want_vae = _kernel_paths(jax_quant.quantize_params(
        params["vae"],
        exclude=jax_quant.DEFAULT_EXCLUDE + ("encoder", "quant_conv")))
    assert {quant.vit_path(n) for n in vit_sites} == want_vit
    assert {quant.vae_path(n) for n in vae_sites} == want_vae
    assert "conv1" in vit_sites and "post_quant_conv" in vae_sites
    assert not {"decoder.conv_in", "decoder.conv_out", "quant_conv"} & set(
        vae_sites)
    assert not any(n.startswith("encoder.") for n in vae_sites)
    # the packed in_proj keeps its state-dict keys
    keys = modules.e4t_encoder.state_dict()
    assert "clip_vision.transformer.resblocks.0.attn.in_proj_weight" in keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_conv_route_is_the_conv(dtype):
    """conv1's route (patch matrix, ``_int_mm``) gives the int8 conv's
    plain version bit for bit, in each scale mode; the image side is not
    a multiple of the patch (a VALID conv drops the rest)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 30, 29, generator=gen).to(dtype)
    w = torch.randn(16, 3, 14, 14, generator=gen)
    bias = torch.randn(16, generator=gen)
    base = quant.quantize_kernel(w)
    base["q"] = base["q"].permute(0, 2, 3, 1).contiguous()
    amax_c = x.float().abs().amax(dim=(0, 2, 3))
    sac = amax_c ** 0.75 * amax_c.max() ** 0.25 / 127.0
    pc = quant.quantize_kernel(w * sac.reshape(1, -1, 1, 1))
    modes = {
        "sa": ({**base, "sa": x.float().abs().amax() * 0.9 / 127.0}, False),
        "sac": ({"q": pc["q"].permute(0, 2, 3, 1).contiguous(),
                 "s": pc["s"], "sac": sac}, True),
        "dynamic": (base, False),
    }
    for mode, (site, per_channel) in modes.items():
        for b in (None, bias):
            got = quant.int8_conv2d(x, site, b, 14, 0)
            act = (site["sac"] if per_channel else
                   site.get("sa", quant.dynamic_scale(x))).reshape(-1)
            want = ic.int8_conv_act_reference(
                x, site["q"], act, per_channel, site["s"],
                None if b is None else b.to(dtype), 14, 0)
            assert got.shape == want.shape == (2, 16, 2, 2)
            assert got.dtype == dtype
            assert torch.equal(got, want), mode


@pytest.fixture(scope="module")
def aux_amax(world):
    """The aux calibration of both packages on the same pixels and
    latents."""
    jm, params, modules, _, jax_args, port_args, final = world
    jax_amax = jax_aux_calibration_fn(jm)(
        params["e4t"], params["vae"], jax_args[6], jnp.asarray(final.numpy()))
    port_amax = pl.make_aux_calibration_fn(modules)(port_args[2], final)
    return jax_amax, port_amax


def test_aux_calibration_matches_jax(aux_amax):
    jax_amax, port_amax = aux_amax
    towers = (("e4t", jax_amax["e4t"]["clip_vision"], quant.vit_path),
              ("vae", jax_amax["vae"], quant.vae_path))
    for tower, tree, path_of in towers:
        want = {}
        for p, v in jax.tree_util.tree_leaves_with_path(tree):
            keys = [str(k.key) for k in p]
            want.setdefault("/".join(keys[:-1]), {})[keys[-1]] = np.asarray(v)
        got = port_amax[tower]
        assert {path_of(n) for n in got} == set(want), tower
        for name, site in got.items():
            for k, v in site.items():
                ref = want[path_of(name)][k]
                np.testing.assert_allclose(
                    v.numpy(), ref, rtol=0,
                    atol=AMAX_REL * float(np.max(ref)), err_msg=name)


def _close(a, b):
    corr = np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]
    assert corr > CORR_MIN, corr
    assert np.abs(np.asarray(a) - np.asarray(b)).mean() < MEAN_ABS_MAX


def test_int8_aux_static_sampling_matches_jax(world, aux_amax):
    """Calibrated aux scales: the port against JAX (each calibrated by its
    own package), against the port's f32 run, and against the port's
    dynamic aux scales."""
    jm, params, modules, _, jax_args, port_args, _ = world
    jax_amax, port_amax = aux_amax
    ref = np.asarray(jax_sample_fn(jm, JaxDDIM(), STEPS, 7.5, 0.1,
                                   int8_aux="static")(*jax_args, jax_amax))
    out = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1,
                            int8_aux="static")(*port_args,
                                               aux_amax=port_amax).numpy()
    assert np.all(np.isfinite(out)) and out.shape == ref.shape
    _close(out, ref)
    full = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1)(
        *port_args).numpy()
    _close(out, full)
    assert not np.array_equal(out, full)  # the towers ran int8
    dyn = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1,
                            int8_aux=True)(*port_args).numpy()
    assert rel_l2(out, dyn) < STATIC_VS_DYNAMIC_REL_L2
    with pytest.raises(ValueError, match="aux_amax"):
        pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1,
                          int8_aux="static")(*port_args)


def test_pipeline_calibrates_the_towers_once(world, monkeypatch):
    """int8="static" with int8_aux="static": the first call calibrates the
    UNet, then the towers on that calibration's final latents; later calls
    reuse both."""
    _, _, modules, sds, _, _, _ = world
    from e4t_diffusion_torch.config import AttributeDict
    from e4t_diffusion_torch.utils.tokenizer import (
        CLIPTokenizer, make_tiny_tokenizer_files)
    import tempfile

    monkeypatch.setenv("E4T_INT8_CALIB_STEPS", "2")
    with tempfile.TemporaryDirectory() as tok_dir:
        make_tiny_tokenizer_files(tok_dir, extra_words=["a", "photo", "of",
                                                        "face"])
        tok = CLIPTokenizer.from_pretrained(tok_dir, model_max_length=16)
    seen = []
    aux_fn = pl.make_aux_calibration_fn

    def spy(mods):
        calibrate = aux_fn(mods)

        def run(pixel, latents):
            seen.append(latents)
            return calibrate(pixel, latents)
        return run

    monkeypatch.setattr(pl, "make_aux_calibration_fn", spy)
    pipe = pl.StableDiffusionE4TPipeline(
        modules, sds["offsets"], tok, AttributeDict({
            "placeholder_token": "*s", "domain_class_token": "face",
            "domain_embed_scale": 0.1}), int8="static", int8_aux="static")
    image = np.random.default_rng(0).uniform(0, 255, (32, 32, 3)).astype(
        np.uint8)
    latents = np.random.default_rng(1).standard_normal(
        (1, 4, 8, 8)).astype(np.float32)
    a = pipe("a photo of *s", image, num_inference_steps=2,
             guidance_scale=7.5, latents=latents)
    assert len(seen) == 1 and not torch.equal(seen[0],
                                              torch.from_numpy(latents))
    aux = pipe.aux_amax
    assert set(aux) == {"e4t", "vae"} and "conv1" in aux["e4t"]
    b = pipe("a photo of *s", image, num_inference_steps=2,
             guidance_scale=7.5, latents=latents)
    assert len(seen) == 1 and pipe.aux_amax is aux
    np.testing.assert_array_equal(a, b)


def test_int8_aux_dynamic_sampling_matches_jax(world):
    """Dynamic aux scales: the port against JAX and against the port's
    f32 run; the int8 error of the port is of the size of JAX's."""
    jm, params, modules, _, jax_args, port_args, _ = world
    ref = np.asarray(jax_sample_fn(jm, JaxDDIM(), STEPS, 7.5, 0.1,
                                   int8_aux=True)(*jax_args))
    out = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1,
                            int8_aux=True)(*port_args).numpy()
    full = pl.make_sample_fn(modules, DDIMScheduler(), STEPS, 7.5, 0.1)(
        *port_args).numpy()
    _close(out, ref)
    _close(out, full)
    jax_err, port_err = rel_l2(ref, full), rel_l2(out, full)
    assert 1e-4 < jax_err and 0.5 * jax_err < port_err < 2 * jax_err
