"""State-dict helpers: weights carried across from the JAX package, and
``.pt`` / ``.bin`` / safetensors loading.

``state_dicts_from_jax`` maps the JAX package's parameter trees (numpy
arrays, flax layout) onto the port's state dicts, which use the diffusers /
Hugging Face / open_clip / reference-artifact names. It is the port's own
copy of the mapping in the JAX package's ``unet_to_torch``,
``offset_bank_to_torch``, ``vae_to_torch``, ``clip_text_to_torch`` and
``e4t_encoder_to_torch``. Conventions:

- flax Dense kernel (in, out)      -> torch Linear weight (out, in)
- flax Conv kernel (h, w, i, o)    -> torch Conv2d weight (o, i, h, w)
- flax norm scale / bias           -> torch weight / bias
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_INDEXED = ("down_blocks", "up_blocks", "attentions", "resnets",
            "transformer_blocks", "downsamplers", "upsamplers", "to_out",
            "layers")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _t(x) -> torch.Tensor:
    return _tensor(np.asarray(x).T)


def _leaf(out: StateDict, base: str, key: str, value) -> None:
    """One flax leaf -> torch key(s) under ``base``."""
    v = np.asarray(value)
    if key == "kernel":
        out[base + ".weight"] = (_tensor(np.transpose(v, (3, 2, 0, 1)))
                                 if v.ndim == 4 else _t(v))
    elif key == "scale":
        out[base + ".weight"] = _tensor(v)
    else:
        out[base + "." + key] = _tensor(v)


def _walk(node: Mapping, path: list, rename, out: StateDict) -> None:
    for k, v in node.items():
        if isinstance(v, Mapping):
            _walk(v, path + [rename(k)], rename, out)
        else:
            _leaf(out, ".".join(path), k, v)


def unet_component(comp: str) -> str:
    """One JAX UNet module-name component -> its torch form
    ("down_blocks_0" -> "down_blocks.0", "net_0_proj" -> "net.0.proj")."""
    if comp == "net_0_proj":
        return "net.0.proj"
    if comp == "net_2":
        return "net.2"
    m = re.match(r"^(.*)_(\d+)$", comp)
    if m and m.group(1) in _INDEXED:
        return f"{m.group(1)}.{m.group(2)}"
    return comp


def _vae_component(comp: str) -> str:
    comp = re.sub(r"(down_blocks|up_blocks|resnets|attentions|downsamplers|"
                  r"upsamplers)_(\d+)", r"\1.\2", comp)
    # flax joins nested names with "_": "down_blocks.0_resnets.0"
    return re.sub(r"(\d)_([a-z])", r"\1.\2", comp)


def unet_from_jax(params: Mapping) -> StateDict:
    out: StateDict = {}
    _walk(params, [], unet_component, out)
    return out


def vae_from_jax(params: Mapping) -> StateDict:
    out: StateDict = {}
    _walk(params, [], _vae_component, out)
    return out


def offsets_from_jax(bank: Mapping) -> StateDict:
    """JAX offsets bank -> the reference ``weight_offsets.pt`` layout."""
    out: StateDict = {}
    for site, wos in bank.items():
        site_t = re.sub(r"_(\d+)", r".\1", site)
        for wo, p in wos.items():
            out[f"{site_t}.{wo}.v"] = _tensor(p["v"])
            for lin in ("linear1", "linear2", "linear_column", "linear_row"):
                out[f"{site_t}.{wo}.{lin}.weight"] = _t(p[lin]["kernel"])
                out[f"{site_t}.{wo}.{lin}.bias"] = _tensor(p[lin]["bias"])
    return out


def clip_text_from_jax(params: Mapping, num_layers: int) -> StateDict:
    p = "text_model."
    out: StateDict = {
        p + "embeddings.token_embedding.weight":
            _tensor(params["token_embedding"]),
        p + "embeddings.position_embedding.weight":
            _tensor(params["position_embedding"]),
    }
    for i in range(num_layers):
        t = f"{p}encoder.layers.{i}."
        f = params[f"layers_{i}"]
        for name in ("layer_norm1", "layer_norm2"):
            _leaf(out, t + name, "scale", f[name]["scale"])
            _leaf(out, t + name, "bias", f[name]["bias"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _leaf(out, t + "self_attn." + proj, "kernel",
                  f["self_attn"][proj]["kernel"])
            _leaf(out, t + "self_attn." + proj, "bias",
                  f["self_attn"][proj]["bias"])
        for tname, fname in (("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            _leaf(out, t + tname, "kernel", f[fname]["kernel"])
            _leaf(out, t + tname, "bias", f[fname]["bias"])
    _leaf(out, p + "final_layer_norm", "scale",
          params["final_layer_norm"]["scale"])
    _leaf(out, p + "final_layer_norm", "bias",
          params["final_layer_norm"]["bias"])
    return out


def e4t_encoder_from_jax(params: Mapping, num_vit_layers: int) -> StateDict:
    """JAX E4T encoder params -> the reference ``encoder.pt`` layout."""
    out: StateDict = {}
    vit = params["clip_vision"]
    p = "clip_vision."
    _leaf(out, p + "conv1", "kernel", vit["conv1"]["kernel"])
    out[p + "class_embedding"] = _tensor(vit["class_embedding"])
    out[p + "positional_embedding"] = _tensor(vit["positional_embedding"])
    for name in ("ln_pre", "ln_post"):
        _leaf(out, p + name, "scale", vit[name]["scale"])
        _leaf(out, p + name, "bias", vit[name]["bias"])
    for i in range(num_vit_layers):
        t = f"{p}transformer.resblocks.{i}."
        f = vit[f"resblocks_{i}"]
        for name in ("ln_1", "ln_2"):
            _leaf(out, t + name, "scale", f[name]["scale"])
            _leaf(out, t + name, "bias", f[name]["bias"])
        out[t + "attn.in_proj_weight"] = _t(f["attn_in_proj"]["kernel"])
        out[t + "attn.in_proj_bias"] = _tensor(f["attn_in_proj"]["bias"])
        for tname, fname in (("attn.out_proj", "attn_out_proj"),
                             ("mlp.c_fc", "mlp_c_fc"),
                             ("mlp.c_proj", "mlp_c_proj")):
            _leaf(out, t + tname, "kernel", f[fname]["kernel"])
            _leaf(out, t + tname, "bias", f[fname]["bias"])
    for tname, fname in (("unet_feature_embedder.0", "unet_feature_embedder_0"),
                         ("unet_feature_embedder.2", "unet_feature_embedder_2"),
                         ("feature_linear", "feature_linear"),
                         ("final_linear", "final_linear")):
        _leaf(out, tname, "kernel", params[fname]["kernel"])
        _leaf(out, tname, "bias", params[fname]["bias"])
    fk = np.asarray(params["first_linears_kernel"])
    fb = np.asarray(params["first_linears_bias"])
    for i in range(fk.shape[0]):
        out[f"first_linears.{i}.weight"] = _t(fk[i])
        out[f"first_linears.{i}.bias"] = _tensor(fb[i])
    return out


def state_dicts_from_jax(params_np: Mapping[str, Any], modules
                         ) -> Dict[str, StateDict]:
    """{"unet", "offsets", "vae", "text", "e4t"} JAX parameter trees (numpy)
    -> the port's state dicts under the same keys. ``modules`` (an
    ``E4TModules``) supplies the layer counts. Load the result with
    ``modules.load_state_dicts`` (strict); ``"offsets"`` is the bank
    ``StableDiffusionE4TPipeline`` takes."""
    out = {}
    if "unet" in params_np:
        out["unet"] = unet_from_jax(params_np["unet"])
    if "offsets" in params_np:
        out["offsets"] = offsets_from_jax(params_np["offsets"])
    if "vae" in params_np:
        out["vae"] = vae_from_jax(params_np["vae"])
    if "text" in params_np:
        out["text"] = clip_text_from_jax(
            params_np["text"], modules.text_encoder.config.num_layers)
    if "e4t" in params_np:
        out["e4t"] = e4t_encoder_from_jax(
            params_np["e4t"], modules.e4t_encoder.config.vit.num_layers)
    return out


def vit_from_open_clip(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """An open_clip visual tower's state dict -> the port's
    ``VisionTransformer`` state dict (the same names). Keys under
    ``visual.`` are taken when any key has that prefix (a whole CLIP
    model's file), stripped of it; the tower's output projection ``proj``
    is dropped, as the encoder uses the un-projected features. Load the
    result strictly: a missing or extra key is an error there."""
    prefix = "visual." if any(k.startswith("visual.") for k in sd) else ""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and k[len(prefix):] != "proj"}


def load_state_dict_file(path: str) -> StateDict:
    """A state dict from ``.safetensors`` or a torch ``.pt`` / ``.bin``."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)

