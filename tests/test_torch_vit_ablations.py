"""The ViT config's ablation fields, ``gelu_approximate``, ``ablate_attn``
and ``ablate_ln``, against the JAX ``ViTConfig``'s on the tiny tower: the
same weights carried across by ``utils/convert`` (an ``ablate_ln`` tower
has no ``ln_1`` / ``ln_2`` on either side), outputs within rel-L2 1e-5; and
``gelu_approximate`` beside the ``E4T_VIT_GELU`` knob (either gives tanh)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4t_diffusion_tpu.models import vit as jax_vit

from e4t_diffusion_torch.models import vit
from e4t_diffusion_torch.utils import convert
from torch_parity import jax_tiny, rel_l2

TOL = 1e-5
ABLATIONS = {
    "base": {},
    "gelu_approximate": {"gelu_approximate": True},
    "ablate_attn": {"ablate_attn": True},
    "ablate_ln": {"ablate_ln": True},
    "ablate_attn_ln_tanh": {"ablate_attn": True, "ablate_ln": True,
                            "gelu_approximate": True},
}


@pytest.fixture(scope="module")
def weights():
    _, params = jax_tiny(seed=9)
    return jax.tree_util.tree_map(np.asarray, params["e4t"]["clip_vision"])


def _towers(weights, fields):
    """(the JAX tower and its params, the port's tower) of the tiny ViT
    with ``fields`` set, on the same weights."""
    jcfg = dataclasses.replace(jax_vit.ViTConfig.tiny(), **fields)
    pcfg = dataclasses.replace(vit.ViTConfig.tiny(), **fields)
    params = dict(weights)
    if jcfg.ablate_ln:
        params = {k: ({n: p for n, p in v.items()
                       if n not in ("ln_1", "ln_2")}
                      if k.startswith("resblocks_") else v)
                  for k, v in params.items()}
    sd = {}
    convert._vit_from_jax(sd, "", params, pcfg.num_layers)
    tower = vit.VisionTransformer(pcfg)
    tower.load_state_dict(sd, strict=True)
    return jax_vit.VisionTransformer(jcfg), params, tower


def _pixels():
    return np.random.default_rng(4).standard_normal(
        (2, 3, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_matches_jax(weights, monkeypatch, name):
    monkeypatch.delenv("E4T_VIT_GELU", raising=False)
    jtower, params, tower = _towers(weights, ABLATIONS[name])
    x = _pixels()
    jpool, jtok = jtower.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        pool, tok = tower(torch.from_numpy(x))
    assert rel_l2(pool, jpool) <= TOL
    assert rel_l2(tok, jtok) <= TOL
    if name != "base":  # each field changes the function
        _, _, base = _towers(weights, {})
        with torch.no_grad():
            assert not torch.allclose(base(torch.from_numpy(x))[1], tok)


def test_ablate_ln_drops_the_block_norms(weights):
    tower = _towers(weights, {"ablate_ln": True})[2]
    keys = set(tower.state_dict())
    assert not [k for k in keys if ".ln_1." in k or ".ln_2." in k]
    assert {"ln_pre.weight", "ln_post.weight"} <= keys


@pytest.mark.parametrize("knob", ["tanh", ""])
@pytest.mark.parametrize("field", [True, False])
def test_gelu_field_beside_the_knob(weights, monkeypatch, knob, field):
    """tanh when either asks, as JAX's ``cfg.gelu_approximate or
    _gelu_tanh_env()``; the knob keeps its behaviour on a default config."""
    monkeypatch.setenv("E4T_VIT_GELU", knob)
    jtower, params, tower = _towers(weights, {"gelu_approximate": field})
    assert tower.transformer.resblocks[0].mlp.gelu_tanh is field
    assert vit.gelu_approximate(field) == (
        "tanh" if field or knob else "none")
    assert vit.gelu_approximate() == (knob or "none")
    x = _pixels()
    _, jtok = jtower.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _, tok = tower(torch.from_numpy(x))
    assert rel_l2(tok, jtok) <= TOL
