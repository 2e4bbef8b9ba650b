"""State-dict helpers: weights carried across from the JAX package, and
``.pt`` / ``.bin`` / safetensors loading.

``state_dicts_from_jax`` (E4T) and ``unclip_state_dicts_from_jax``
(Stable-unCLIP) map the JAX package's parameter trees (numpy arrays, flax
layout) onto the port's state dicts, which use the diffusers / Hugging Face
/ open_clip / reference-artifact names; ``clip_scorer_from_jax`` and
``e4t_encoder_legacy_from_jax`` do the same for the CLIP scorer and the
legacy encoder. They are the port's own copy of the mapping in the JAX
package's ``unet_to_torch``, ``offset_bank_to_torch``, ``vae_to_torch``,
``clip_text_to_torch``, ``e4t_encoder_to_torch`` and the inverses of its
``clip_vision_hf_from_torch``, ``clip_vision_with_projection_from_torch``,
``image_normalizer_from_torch``, ``e4t_encoder_legacy_from_torch`` and
``scorer_from_open_clip``. The SD v2 UNet needs nothing apart: its linear
``proj_in`` / ``proj_out`` are Dense kernels (transposed like any other) and
its ``class_embedding.linear_{1,2}`` are named as in diffusers. Conventions:

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


def _norm(out: StateDict, base: str, params: Mapping) -> None:
    _leaf(out, base, "scale", params["scale"])
    _leaf(out, base, "bias", params["bias"])


def _dense(out: StateDict, base: str, params: Mapping) -> None:
    for k, v in params.items():
        _leaf(out, base, k, v)


def _clip_layers(out: StateDict, prefix: str, params: Mapping,
                 num_layers: int) -> None:
    """The JAX ``CLIPEncoderLayer``s ``layers_{i}`` -> Hugging Face
    ``{prefix}{i}.`` keys (the text and the vision towers alike)."""
    for i in range(num_layers):
        t = f"{prefix}{i}."
        f = params[f"layers_{i}"]
        for name in ("layer_norm1", "layer_norm2"):
            _norm(out, t + name, f[name])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, t + "self_attn." + proj, f["self_attn"][proj])
        for tname, fname in (("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            _dense(out, t + tname, f[fname])


def clip_text_from_jax(params: Mapping, num_layers: int) -> StateDict:
    p = "text_model."
    out: StateDict = {
        p + "embeddings.token_embedding.weight":
            _tensor(params["token_embedding"]),
        p + "embeddings.position_embedding.weight":
            _tensor(params["position_embedding"]),
    }
    _clip_layers(out, p + "encoder.layers.", params, num_layers)
    _norm(out, p + "final_layer_norm", params["final_layer_norm"])
    return out


def _resblocks_from_jax(out: StateDict, p: str, params: Mapping,
                        num_layers: int) -> None:
    """JAX ``ViTBlock``s ``resblocks_{i}`` -> open_clip
    ``{p}transformer.resblocks.{i}.`` keys (vision and text towers)."""
    for i in range(num_layers):
        t = f"{p}transformer.resblocks.{i}."
        f = params[f"resblocks_{i}"]
        for name in ("ln_1", "ln_2"):
            if name in f:  # absent under the ViT's ablate_ln
                _norm(out, t + name, f[name])
        out[t + "attn.in_proj_weight"] = _t(f["attn_in_proj"]["kernel"])
        out[t + "attn.in_proj_bias"] = _tensor(f["attn_in_proj"]["bias"])
        for tname, fname in (("attn.out_proj", "attn_out_proj"),
                             ("mlp.c_fc", "mlp_c_fc"),
                             ("mlp.c_proj", "mlp_c_proj")):
            _dense(out, t + tname, f[fname])


def _vit_from_jax(out: StateDict, p: str, vit: Mapping,
                  num_layers: int) -> None:
    """A JAX ``VisionTransformer`` -> open_clip ``VisionTransformer`` keys
    under ``p``."""
    _leaf(out, p + "conv1", "kernel", vit["conv1"]["kernel"])
    out[p + "class_embedding"] = _tensor(vit["class_embedding"])
    out[p + "positional_embedding"] = _tensor(vit["positional_embedding"])
    for name in ("ln_pre", "ln_post"):
        _norm(out, p + name, vit[name])
    _resblocks_from_jax(out, p, vit, num_layers)


def e4t_encoder_from_jax(params: Mapping, num_vit_layers: int) -> StateDict:
    """JAX E4T encoder params -> the reference ``encoder.pt`` layout."""
    out: StateDict = {}
    _vit_from_jax(out, "clip_vision.", params["clip_vision"], num_vit_layers)
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


def clip_vision_hf_from_jax(params: Mapping, num_layers: int,
                            prefix: str = "vision_model.") -> StateDict:
    """A JAX HF-layout ``CLIPVisionModel`` -> transformers'
    ``CLIPVisionModel`` keys under ``prefix``."""
    p = prefix
    out: StateDict = {
        p + "embeddings.class_embedding": _tensor(params["class_embedding"]),
        p + "embeddings.position_embedding.weight":
            _tensor(params["position_embedding"])}
    _leaf(out, p + "embeddings.patch_embedding", "kernel",
          params["patch_embedding"]["kernel"])
    for name in ("pre_layrnorm", "post_layernorm"):
        _norm(out, p + name, params[name])
    _clip_layers(out, p + "encoder.layers.", params, num_layers)
    return out


def clip_vision_with_projection_from_jax(params: Mapping, num_layers: int
                                         ) -> StateDict:
    """JAX ``CLIPVisionModelWithProjection`` -> transformers' keys."""
    out = clip_vision_hf_from_jax(params["vision_model"], num_layers)
    _leaf(out, "visual_projection", "kernel",
          params["visual_projection"]["kernel"])
    return out


def image_normalizer_from_jax(params: Mapping) -> StateDict:
    """JAX normalizer {mean, std} (D,) -> diffusers' (1, D) tensors."""
    return {k: _tensor(params[k]).reshape(1, -1) for k in ("mean", "std")}


def e4t_encoder_legacy_from_jax(params: Mapping, num_layers: int
                                ) -> StateDict:
    """JAX ``E4TEncoderLegacy`` params -> the reference's legacy encoder
    keys (``clip_vision.vision_model.*``, ``linear``, ``final_linear``)."""
    out = clip_vision_hf_from_jax(params["clip_vision"], num_layers,
                                  prefix="clip_vision.vision_model.")
    for name in ("linear", "final_linear"):
        _dense(out, name, params[name])
    return out


def clip_scorer_from_jax(params: Mapping, config) -> StateDict:
    """JAX ``CLIPScorer`` params -> the port's ``CLIPScorer`` state dict
    (``visual.*``, ``visual_proj``, ``text.*``; a ``CLIPScoreConfig``
    supplies the layer counts)."""
    out: StateDict = {"visual_proj": _tensor(params["visual_proj"])}
    _vit_from_jax(out, "visual.", params["visual"], config.vit.num_layers)
    txt = params["text"]
    _resblocks_from_jax(out, "text.", txt, config.text.num_layers)
    out["text.token_embedding.weight"] = _tensor(txt["token_embedding"])
    out["text.positional_embedding"] = _tensor(txt["positional_embedding"])
    out["text.text_projection"] = _tensor(txt["text_projection"])
    _norm(out, "text.ln_final", txt["ln_final"])
    return out


def unclip_state_dicts_from_jax(params_np: Mapping[str, Any], modules
                                ) -> Dict[str, StateDict]:
    """{"unet", "vae", "text", "image_encoder", "image_normalizer"} JAX
    parameter trees (numpy) -> the port's state dicts under the same keys;
    ``modules`` (an ``UnCLIPModules``) supplies the layer counts. Load the
    result with ``modules.load_state_dicts`` (strict)."""
    out = {}
    if "unet" in params_np:
        out["unet"] = unet_from_jax(params_np["unet"])
    if "vae" in params_np:
        out["vae"] = vae_from_jax(params_np["vae"])
    if "text" in params_np:
        out["text"] = clip_text_from_jax(
            params_np["text"], modules.text_encoder.config.num_layers)
    if "image_encoder" in params_np:
        out["image_encoder"] = clip_vision_with_projection_from_jax(
            params_np["image_encoder"],
            modules.image_encoder.config.vision.num_layers)
    if "image_normalizer" in params_np:
        out["image_normalizer"] = image_normalizer_from_jax(
            params_np["image_normalizer"])
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

