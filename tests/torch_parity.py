"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Initialises the JAX package's tiny modules from a seed, carries their
parameters into the port with ``state_dicts_from_jax`` and loads them
strictly, so both packages compute the same function on the same weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from e4t_diffusion_tpu.diffusion.pipeline import E4TModules as JaxModules
from e4t_diffusion_tpu.models import weight_offsets as jax_wo

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.utils.convert import state_dicts_from_jax


def _fill(shapes, rng: np.random.Generator):
    """Random values for a tree of parameter shapes: norms near 1, small
    biases, kernels scaled by 1/sqrt(fan_in), embeddings at std 0.02."""

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name in ("bias", "first_linears_bias"):
            v = 0.1 * rng.standard_normal(s.shape)
        elif name in ("kernel", "first_linears_kernel"):
            fan_in = (int(np.prod(s.shape[:-1])) if len(s.shape) != 3
                      else s.shape[1])
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        else:  # token / position / class embeddings
            v = 0.02 * rng.standard_normal(s.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _tiny_shapes():
    """The JAX tiny modules, the shapes of their parameters and those of
    the offset bank; traced once a process and shared by every seed."""
    jm = JaxModules.tiny()
    tcfg = jm.text_encoder.config
    ecfg = jm.e4t_encoder.config
    key = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(
            jm.unet.init, key, jnp.zeros((1, 4, 8, 8)), jnp.array([0]),
            jnp.zeros((1, tcfg.max_position_embeddings, tcfg.hidden_size))),
        "vae": jax.eval_shape(jm.vae.init, key, jnp.zeros((1, 3, 32, 32)),
                              key),
        "text": jax.eval_shape(
            jm.text_encoder.init, key,
            jnp.zeros((1, tcfg.max_position_embeddings), jnp.int32)),
        "e4t": jax.eval_shape(jm.e4t_encoder.init, key,
                              jnp.zeros((1, 3, 32, 32)),
                              jnp.zeros((1, ecfg.unet_feature_dim))),
    }
    bank_shapes = jax.eval_shape(
        functools.partial(jax_wo.init_offset_bank, unet_config=jm.unet.config),
        key)
    return jm, shapes, bank_shapes


def jax_tiny(seed: int = 0):
    """(JAX tiny modules, their params): shapes from the JAX modules,
    values drawn with numpy from ``seed`` (no XLA compile of the inits)."""
    jm, shapes, bank_shapes = _tiny_shapes()
    rng = np.random.default_rng(seed)
    params = {k: _fill(v["params"], rng) for k, v in shapes.items()}
    params["offsets"] = jax.tree_util.tree_map_with_path(
        lambda path, s: _offset_leaf(str(path[-1].key), s.shape, rng),
        bank_shapes)
    return jm, params


def _offset_leaf(name, shape, rng):
    """torch.nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights,
    as the reference initialises the hypernetworks; v stays 1."""
    if name == "v":
        return jnp.ones(shape, jnp.float32)
    fan_in = shape[0] if name == "kernel" else 10
    return jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32)
                       / np.sqrt(fan_in))


def port_tiny(params):
    """The port's tiny modules on the CPU (f32) with ``params`` carried
    across, and the state dicts (incl. the "offsets" bank)."""
    modules = E4TModules.tiny(device="cpu")
    sds = state_dicts_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               modules)
    modules.load_state_dicts({k: sds[k]
                              for k in ("unet", "vae", "text", "e4t")})
    return modules, sds


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def sampling_args(jm, params, modules, sds, batch=2, seed=0):
    """The same inputs, made with numpy from ``seed``, for the JAX
    package's and the port's ``make_sample_fn`` on the tiny modules:
    (JAX positional arguments up to the noise key, the port's up to the
    generator). ``batch`` latents, one prompt with the placeholder at
    position 3, "" ids of zeros, class token 5."""
    import torch

    from e4t_diffusion_tpu.models.clip_text import embed_tokens

    rng = np.random.default_rng(seed)
    length = jm.text_encoder.config.max_position_embeddings
    ids = rng.integers(1, 40, (1, length))
    latents = rng.standard_normal((batch, 4, 8, 8)).astype(np.float32)
    pixel = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    ph_idx = np.full((batch,), 3)
    uncond = np.zeros((1, length), np.int64)
    text = params["text"]
    jax_args = (params["unet"], params["offsets"], params["vae"], text,
                params["e4t"], jnp.asarray(latents), jnp.asarray(pixel),
                embed_tokens(text, jnp.asarray(ids, jnp.int32)),
                jnp.asarray(ph_idx, jnp.int32),
                jnp.asarray(uncond, jnp.int32),
                embed_tokens(text, jnp.asarray([[5]], jnp.int32))[0, 0],
                jax.random.PRNGKey(1))
    te = modules.text_encoder
    with torch.no_grad():
        port_args = (sds["offsets"], torch.from_numpy(latents),
                     torch.from_numpy(pixel),
                     te.embed_tokens(torch.from_numpy(ids)),
                     torch.from_numpy(ph_idx), torch.from_numpy(uncond),
                     te.embed_tokens(torch.tensor([5]))[0])
    return jax_args, port_args
