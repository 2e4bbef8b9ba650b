"""Artifacts: local diffusers-format SD checkpoints and the E4T ``.pt``
artifacts, loaded and saved.

Counterpart of ``e4t_diffusion_tpu/utils/artifacts.py``.
An SD base directory holds ``unet/ vae/ text_encoder/ tokenizer/
scheduler/`` subfolders (``.bin`` or ``.safetensors``); a Stable-unCLIP
directory adds ``image_encoder/ image_normalizer/`` and an optional
``image_noising_scheduler/`` (``load_sd_unclip``). An E4T artifact
directory holds ``config.json``, ``encoder.pt`` and either
``weight_offsets.pt`` (pretraining) or ``unet.pt`` (tuning: the whole UNet
with the offsets embedded), plus an optional ``text_encoder.pt`` and
``domain.png``. The state dicts returned here load strictly into the
port's modules, and what ``save_e4t_weights`` writes (either flavour)
loads strictly into the port and into the JAX package.

Resumable training state: ``output_dir/checkpoint-<step>/train_state.pt``,
one ``torch.save`` of the trainable tensors, the optimizer's
``state_dict``, the step, the update count and the ``torch.Generator``'s
state (the JAX package's Orbax checkpoint holds the same). A save writes
into ``checkpoint-<step>.tmp`` and renames it when complete, so a
``checkpoint-<step>`` directory always holds a whole state. With
``async_save`` the state is copied to the host at the call and written by a
background thread; ``wait_for_checkpoints`` joins it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from e4t_diffusion_torch.config import AttributeDict, save_config
from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
from e4t_diffusion_torch.models.clip_text import CLIPTextConfig
from e4t_diffusion_torch.models.e4t_encoder import E4TEncoderConfig
from e4t_diffusion_torch.models.unet import UNetConfig, tap_feature_dim
from e4t_diffusion_torch.models.vae import VAEConfig
from e4t_diffusion_torch.models.vit import ViTConfig
from e4t_diffusion_torch.parallel.mesh import Mesh, consolidated_state_dict
from e4t_diffusion_torch.utils.convert import load_state_dict_file

_VAE_ATTN_RENAME = {"to_q": "query", "to_k": "key", "to_v": "value",
                    "to_out.0": "proj_attn"}


def _read_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def unet_config_from_diffusers(cfg: dict) -> UNetConfig:
    """The keys the JAX package's reader takes; the rest are ignored."""
    heads = cfg.get("attention_head_dim", 8)
    return UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        center_input_sample=cfg.get("center_input_sample", False),
        down_block_types=tuple(cfg["down_block_types"]),
        mid_block_type=cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn"),
        up_block_types=tuple(cfg["up_block_types"]),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        attention_head_dim=(tuple(heads) if isinstance(heads, (list, tuple))
                            else heads),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
        use_linear_projection=cfg.get("use_linear_projection", False),
        class_embed_type=cfg.get("class_embed_type", None),
        projection_class_embeddings_input_dim=cfg.get(
            "projection_class_embeddings_input_dim", None),
    )


def vae_config_from_diffusers(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        sample_size=cfg.get("sample_size", 512),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def text_config_from_hf(cfg: dict) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size", 3072),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
    )


def schedule_config_from_diffusers(cfg: dict) -> NoiseScheduleConfig:
    return NoiseScheduleConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        steps_offset=cfg.get("steps_offset", 1),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
        clip_sample=cfg.get("clip_sample", False),
    )


def _load_weights(subdir: str) -> dict:
    """The weight file of a diffusers / transformers model folder."""
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin", "model.safetensors",
                 "pytorch_model.bin"):
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return load_state_dict_file(path)
    raise FileNotFoundError(f"no weight file in {subdir}")


def _text_state_dict(sd: dict) -> dict:
    # transformers keeps a non-parameter position_ids buffer in the file
    # (the text and the vision towers alike)
    return {k: v for k, v in sd.items() if not k.endswith("position_ids")}


def _vae_state_dict(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        m = re.match(r"^(.*\.attentions\.\d+)\.(to_q|to_k|to_v|to_out\.0)"
                     r"\.(weight|bias)$", k)
        if m:
            k = f"{m.group(1)}.{_VAE_ATTN_RENAME[m.group(2)]}.{m.group(3)}"
        out[k] = v
    return out


def _load_common(path: str) -> Dict[str, Any]:
    """unet/ vae/ text_encoder/ scheduler/ and the tokenizer path."""
    out: Dict[str, Any] = {}
    out["unet_config"] = unet_config_from_diffusers(
        _read_json(os.path.join(path, "unet", "config.json")))
    out["unet"] = _load_weights(os.path.join(path, "unet"))
    out["vae_config"] = vae_config_from_diffusers(
        _read_json(os.path.join(path, "vae", "config.json")))
    out["vae"] = _vae_state_dict(_load_weights(os.path.join(path, "vae")))
    out["text_config"] = text_config_from_hf(
        _read_json(os.path.join(path, "text_encoder", "config.json")))
    out["text"] = _text_state_dict(
        _load_weights(os.path.join(path, "text_encoder")))
    out["schedule_config"] = schedule_config_from_diffusers(
        _read_json(os.path.join(path, "scheduler", "scheduler_config.json")))
    out["tokenizer_dir"] = os.path.join(path, "tokenizer")
    return out


def load_sd_base(path: str) -> Dict[str, Any]:
    """Configs + state dicts + tokenizer path of a local diffusers-format
    SD checkpoint directory, the base of every E4T path (sampling, tuning,
    pretraining): SD v1 or the SD v2 family (per-block head counts, linear
    projections, the 1024-wide OpenCLIP-H text tower, v-prediction), as the
    JAX package's loader takes it. A Stable-unCLIP UNet loads too; it needs
    ``class_labels``, so the E4T paths raise at its first call."""
    return _load_common(path)


def load_sd_unclip(path: str) -> Dict[str, Any]:
    """Configs + state dicts + tokenizer path of a local diffusers-format
    Stable-unCLIP directory (stabilityai/stable-diffusion-2-1-unclip
    layout): ``load_sd_base``'s folders plus ``image_encoder/``,
    ``image_normalizer/`` and, when present, ``image_noising_scheduler/``
    ("noise_aug_schedule"). The state dicts load strictly into
    ``diffusion/unclip_pipeline.UnCLIPModules`` (a stray key raises
    there)."""
    from e4t_diffusion_torch.models.e4t_encoder_legacy import CLIPVisionConfig
    from e4t_diffusion_torch.models.unclip import CLIPVisionProjectionConfig

    out = _load_common(path)
    icfg = _read_json(os.path.join(path, "image_encoder", "config.json"))
    out["image_encoder_config"] = CLIPVisionProjectionConfig(
        vision=CLIPVisionConfig(
            hidden_size=icfg.get("hidden_size", 1280),
            num_layers=icfg.get("num_hidden_layers", 32),
            num_heads=icfg.get("num_attention_heads", 16),
            intermediate_size=icfg.get("intermediate_size", 5120),
            image_size=icfg.get("image_size", 224),
            patch_size=icfg.get("patch_size", 14),
            hidden_act=icfg.get("hidden_act", "gelu")),
        projection_dim=icfg.get("projection_dim", 1024))
    out["image_encoder"] = _text_state_dict(
        _load_weights(os.path.join(path, "image_encoder")))
    out["image_normalizer"] = _load_weights(
        os.path.join(path, "image_normalizer"))
    noise_aug = os.path.join(path, "image_noising_scheduler",
                             "scheduler_config.json")
    if os.path.exists(noise_aug):
        out["noise_aug_schedule"] = schedule_config_from_diffusers(
            _read_json(noise_aug))
    return out


def e4t_encoder_config_from_args(args: AttributeDict,
                                 word_embedding_dim: int = 768,
                                 unet_config: Optional[UNetConfig] = None,
                                 unet_feature_dim: Optional[int] = None
                                 ) -> E4TEncoderConfig:
    """The encoder config of a saved run. Only ViT-H-14 geometry is
    bundled (the reference's tuning/inference paths always use it);
    ``vit_config: "tiny"`` selects the test geometry."""
    if unet_feature_dim is None:
        unet_feature_dim = tap_feature_dim(unet_config) if unet_config else 10880
    if getattr(args, "vit_config", None) == "tiny":
        vit = ViTConfig.tiny()
    else:
        vit = ViTConfig.vit_h_14()
        arch = None
        if args.clip_model_name_or_path:
            arch = str(args.clip_model_name_or_path).split("::")[0]
        if arch not in (None, "ViT-H-14") and args.n_odd_layers is None:
            raise ValueError("You must specify `n_odd_layers`!")
    return E4TEncoderConfig(word_embedding_dim=word_embedding_dim,
                            unet_feature_dim=unet_feature_dim, vit=vit)


def _save_state_dict(sd: Dict[str, torch.Tensor], path: str) -> None:
    """f32 CPU tensors, as the reference's artifacts hold."""
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in sd.items()}, path)


def save_e4t_weights(save_dir: str, step: int, config: Dict[str, Any],
                     e4t_state: Dict[str, torch.Tensor],
                     unet_state: Optional[Dict[str, torch.Tensor]],
                     offsets: Dict[str, torch.Tensor],
                     text_state: Optional[Dict[str, torch.Tensor]] = None,
                     domain_image=None) -> str:
    """Write ``save_dir/<step>/`` in the reference layout: ``config.json``,
    ``encoder.pt`` (the encoder's state dict, ``first_linears.{i}`` keys)
    and, for a pretraining run (``unet_state`` None), ``weight_offsets.pt``
    (the bank), for a tuning run ``unet.pt`` (the whole UNet with the
    bank's keys added), optionally ``text_encoder.pt`` and ``domain.png``
    (a PIL image). Returns the directory."""
    out = os.path.join(save_dir, str(step))
    os.makedirs(out, exist_ok=True)
    save_config(config, out)
    if unet_state is None:
        _save_state_dict(offsets, os.path.join(out, "weight_offsets.pt"))
    else:
        _save_state_dict({**unet_state, **offsets},
                         os.path.join(out, "unet.pt"))
    _save_state_dict(e4t_state, os.path.join(out, "encoder.pt"))
    if text_state is not None:
        _save_state_dict(text_state, os.path.join(out, "text_encoder.pt"))
    if domain_image is not None:
        domain_image.save(os.path.join(out, "domain.png"))
    return out


def load_e4t_weights(artifact_dir: str, base: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """Overlay an E4T artifact directory onto the SD base: returns ``base``
    with "unet" (from ``unet.pt`` when present), "offsets" (the bank),
    "e4t", and "text" when the artifact carries a text encoder."""
    out = dict(base)
    unet_path = os.path.join(artifact_dir, "unet.pt")
    wo_path = os.path.join(artifact_dir, "weight_offsets.pt")
    if os.path.exists(unet_path):
        sd = load_state_dict_file(unet_path)
        out["unet"] = {k: v for k, v in sd.items() if ".wo_" not in k}
        out["offsets"] = {k: v for k, v in sd.items() if ".wo_" in k}
    elif os.path.exists(wo_path):
        out["offsets"] = load_state_dict_file(wo_path)
    else:
        raise FileNotFoundError(
            f"neither unet.pt nor weight_offsets.pt in {artifact_dir}")
    out["e4t"] = encoder_state_from_artifact(
        os.path.join(artifact_dir, "encoder.pt"))
    te_path = os.path.join(artifact_dir, "text_encoder.pt")
    if os.path.exists(te_path):
        out["text"] = _text_state_dict(load_state_dict_file(te_path))
    return out


def encoder_state_from_artifact(path: str) -> Dict[str, torch.Tensor]:
    """An ``encoder.pt`` as a state dict for the port's E4T encoder: the
    reference's CLIP normalization buffers and the unused open_clip
    projection are dropped."""
    enc = load_state_dict_file(path)
    return {k: v for k, v in enc.items()
            if not re.match(r"^(mean|std|clip_vision\.proj)$", k)}


# ---------------------------------------------------------------------------
# resumable training state
# ---------------------------------------------------------------------------

TRAIN_STATE_FILE = "train_state.pt"
_PENDING: Dict[str, Any] = {"thread": None, "error": None}


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor detached, cloned and on the CPU
    (taken now, so later steps do not change what is written)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def wait_for_checkpoints() -> None:
    """Block until an in-flight async save has been written, and raise its
    error if it failed. Call before exiting, before restoring and before a
    final save."""
    thread = _PENDING["thread"]
    if thread is not None:
        thread.join()
        _PENDING["thread"] = None
    error, _PENDING["error"] = _PENDING["error"], None
    if error is not None:
        raise RuntimeError("an async checkpoint save failed") from error


def _write_train_state(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, TRAIN_STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_train_state(output_dir: str, step: int,
                     trainable: Dict[str, Dict[str, torch.Tensor]],
                     optimizer: torch.optim.Optimizer, updates: int,
                     generator: torch.Generator,
                     async_save: bool = False,
                     mesh: Optional[Mesh] = None) -> str:
    """Checkpoint the train state as ``output_dir/checkpoint-<step>``.
    ``trainable``: {group: {name: tensor}}; ``updates``: the optimizer
    updates made (the schedule's count). The state is copied to the host
    here, at the step boundary; ``async_save`` writes it on a background
    thread (one save in flight: a new one waits for the last).

    Several ranks (``mesh``): every rank calls it; the file keeps every
    rank's generator state (``"generators"``, in rank order) and the
    optimizer state in the unsharded layout (gathered under ZeRO-1), and
    rank 0 alone writes it (the trainables are the same on every rank)."""
    mesh = mesh or Mesh()
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    wait_for_checkpoints()
    generators = mesh.all_gather_object(generator.get_state())
    optimizer_state = consolidated_state_dict(optimizer)
    if not mesh.is_main:
        return path
    payload = {"step": int(step), "updates": int(updates),
               "trainable": _to_host(trainable),
               "optimizer": _to_host(optimizer_state),
               "generators": generators}
    os.makedirs(output_dir, exist_ok=True)
    if not async_save:
        _write_train_state(path, payload)
        return path

    def write():
        try:
            _write_train_state(path, payload)
        except BaseException as e:  # raised by wait_for_checkpoints
            _PENDING["error"] = e

    thread = threading.Thread(target=write, name=f"checkpoint-{step}")
    _PENDING["thread"] = thread
    thread.start()
    return path


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """The ``checkpoint-<step>`` directory of ``output_dir`` with the
    largest step (numeric order: 10 after 9), or None."""
    if not os.path.isdir(output_dir):
        return None
    dirs = [d for d in os.listdir(output_dir)
            if re.match(r"^checkpoint-\d+$", d)]
    if not dirs:
        return None
    dirs.sort(key=lambda d: int(d.split("-")[1]))
    return os.path.join(output_dir, dirs[-1])


def resolve_checkpoint(output_dir: str,
                       resume_from_checkpoint: Optional[str]
                       ) -> Optional[str]:
    """``--resume_from_checkpoint``: "latest" is the newest checkpoint of
    ``output_dir``; a path is taken as given; None, or a path that does not
    exist, means a new run."""
    if not resume_from_checkpoint:
        return None
    if resume_from_checkpoint == "latest":
        return find_latest_checkpoint(output_dir)
    return (resume_from_checkpoint if os.path.isdir(resume_from_checkpoint)
            else None)


def restore_train_state(path: str,
                        trainable: Dict[str, Dict[str, torch.Tensor]],
                        optimizer: torch.optim.Optimizer,
                        generator: torch.Generator,
                        rank: int = 0) -> Dict[str, int]:
    """Load a ``save_train_state`` checkpoint in place: the trainable
    tensors (every group and name must match), the optimizer's state (a
    ZeRO-1 optimizer keeps its share) and the generator's: rank ``rank``'s
    saved state; a rank the checkpoint holds none for (it was saved by
    fewer ranks) keeps its own seeding. Returns {"step", "updates"}."""
    wait_for_checkpoints()
    payload = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                         map_location="cpu", weights_only=True)
    saved = payload["trainable"]
    want = {g: sorted(group) for g, group in trainable.items()}
    if {g: sorted(group) for g, group in saved.items()} != want:
        raise KeyError(f"{path} holds other trainable tensors than this run")
    with torch.no_grad():
        for g, group in trainable.items():
            for name, t in group.items():
                t.copy_(saved[g][name])
    optimizer.load_state_dict(payload["optimizer"])
    # a checkpoint written by one process before the list held its state
    # under "generator"
    generators = payload.get("generators") or [payload["generator"]]
    if rank < len(generators):
        generator.set_state(generators[rank])
    return {"step": int(payload["step"]), "updates": int(payload["updates"])}
