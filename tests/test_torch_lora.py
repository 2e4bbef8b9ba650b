"""The port's LoRA adapters (models/lora.py) against the JAX package's: the
fold after the weight offsets within 1e-6, the diffusers-0.14 attn-procs
file written by either package read by the other, and tiny sampling with a
LoRA bank against JAX's make_sample_fn on the same weights and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.diffusion.pipeline import (
    make_sample_fn as jax_sample_fn)
from e4t_diffusion_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from e4t_diffusion_tpu.models import lora as jax_lora
from e4t_diffusion_tpu.models import weight_offsets as jax_wo

from e4t_diffusion_torch.diffusion.pipeline import make_sample_fn
from e4t_diffusion_torch.diffusion.schedulers import DDIMScheduler
from e4t_diffusion_torch.models import lora
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.utils.convert import unet_from_jax

from torch_parity import jax_tiny, port_tiny, sampling_args

TOL = 1e-6
# images in [0, 1] after 3 f32 denoise steps and a VAE decode (the
# pipeline tests' bound)
IMAGE_TOL = 1e-3
SCALE = 0.7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    """JAX tiny modules and params, the port's, and a JAX LoRA bank of rank
    2 with non-zero ``up`` (a fresh bank is an exact no-op)."""
    jm, params = jax_tiny(seed=7)
    modules, sds = port_tiny(params)
    rng = np.random.default_rng(8)
    bank = jax_lora.init_lora_bank(jax.random.PRNGKey(3), jm.unet.config,
                                   rank=2)
    bank = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(
            np.float32) * 0.1), bank)
    port_bank = lora.lora_from_torch(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in jax_lora.lora_to_torch(bank).items()},
        modules.unet.config)
    return jm, params, modules, sds, bank, port_bank


def test_init_bank_is_a_no_op_with_the_reference_shapes():
    from e4t_diffusion_torch.models.unet import UNetConfig

    ucfg = UNetConfig.tiny()
    bank = lora.init_lora_bank(ucfg, rank=2,
                               generator=torch.Generator().manual_seed(0))
    assert set(bank) == {p for p, _, _ in wo.attention_sites(ucfg)}
    for path, qdim, kvdim in wo.attention_sites(ucfg):
        layers = bank[path]
        assert layers["to_k_lora"]["down"].shape == (2, kvdim)
        assert layers["to_out_lora"]["up"].shape == (qdim, 2)
        assert all(float(layer["up"].abs().max()) == 0.0
                   for layer in layers.values())
    with pytest.raises(ValueError, match="rank"):
        lora.init_lora_layer(4, 8, 5)


def test_fold_matches_jax(world):
    """Offsets folded, then LoRA: every adapted projection (q/k/v/out of
    every attention site) against JAX's kernels."""
    jm, params, modules, sds, bank, port_bank = world
    jax_folded = jax_lora.fold_lora_bank(
        jax_wo.fold_offset_bank(params["unet"], params["offsets"]), bank,
        SCALE)
    want = unet_from_jax(jax.tree_util.tree_map(np.asarray, jax_folded))
    unet = modules.unet
    folded = wo.fold_offset_bank(unet, sds["offsets"])
    got = lora.fold_lora_bank({**dict(unet.named_parameters()), **folded},
                              port_bank, SCALE)
    assert len(got) == 4 * len(bank)
    for name, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[name].numpy(),
                                   atol=TOL, rtol=0, err_msg=name)


def test_attn_procs_files_cross_packages(world, tmp_path):
    """A JAX-written pytorch_lora_weights.bin reads into the port; the
    port's reads back into JAX; a file of another UNet is refused."""
    jm, _, modules, _, bank, port_bank = world
    path = tmp_path / "pytorch_lora_weights.bin"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in jax_lora.lora_to_torch(bank).items()}, path)
    loaded = lora.load_lora_weights(str(path), modules.unet.config)
    sd = lora.lora_to_torch(loaded)
    assert all(k.split(".processor.")[0] in loaded for k in sd)
    back = jax_lora.lora_from_torch({k: v.numpy() for k, v in sd.items()},
                                    jm.unet.config)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(bank),
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(p))
    for site, layers in port_bank.items():
        for k, layer in layers.items():
            for leaf, t in layer.items():
                torch.testing.assert_close(loaded[site][k][leaf], t)
    sd.pop(next(iter(sd)))
    with pytest.raises(ValueError, match="key mismatch"):
        lora.lora_from_torch(sd, modules.unet.config)


def test_sampling_with_lora_matches_jax(world):
    jm, params, modules, sds, bank, port_bank = world
    jax_args, port_args = sampling_args(jm, params, modules, sds)
    ref = np.asarray(jax_sample_fn(jm, JaxDDIM(), 3, 7.5, 0.1,
                                   lora_scale=SCALE)(*jax_args, bank))
    sample = make_sample_fn(modules, DDIMScheduler(), 3, 7.5, 0.1,
                            lora_scale=SCALE)
    out = sample(*port_args, lora_bank=port_bank).numpy()
    assert out.shape == ref.shape == (2, 3, 16, 16)
    assert np.abs(out - ref).max() <= IMAGE_TOL
    plain = make_sample_fn(modules, DDIMScheduler(), 3, 7.5, 0.1)(
        *port_args).numpy()
    assert np.abs(out - plain).max() > 10 * IMAGE_TOL  # the adapters act
    with pytest.raises(ValueError, match="lora_bank"):
        sample(*port_args)
