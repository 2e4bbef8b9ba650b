"""The registry of published E4T artifacts and their resolution.

Counterpart of ``e4t_diffusion_tpu/utils/hub.py``: ``MODELS`` (registry
name -> Hugging Face repo), ``FILES`` (what an artifact holds) and
``resolve_model_dir``, which the inference and tuning CLIs call on
``--pretrained_model_name_or_path``. A registry name resolves against a
local mirror, ``$E4T_MODELS_DIR/<name>``, before any download; without
``huggingface_hub`` the download raises with staging instructions.
"""
from __future__ import annotations

import os
from typing import Optional

MODELS = {
    "e4t-diffusion-ffhq-celebahq-v1": {
        "repo": "mshing/e4t-diffusion-ffhq-celebahq-v1",
        "subfolder": None,
    }
}
FILES = ["weight_offsets.pt", "encoder.pt", "config.json"]
MIRROR_ENV = "E4T_MODELS_DIR"


def download_from_huggingface(repo: str, filename: str, **kwargs) -> str:
    """One file from the Hub, retried after a login on 401 and after the
    license click-through on 403, as the reference does."""
    try:
        import huggingface_hub
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is unavailable; stage the checkpoint locally "
            f"and point {MIRROR_ENV} at it") from e
    while True:
        try:
            return huggingface_hub.hf_hub_download(repo, filename=filename,
                                                   **kwargs)
        except Exception as e:
            status = getattr(getattr(e, "response", None), "status_code",
                             None)
            if status == 401:
                huggingface_hub.interpreter_login()
                continue
            if status == 403:
                print(f"Go here and agree to the click through license on "
                      f"your account: https://huggingface.co/{repo}")
                input("Hit enter when ready:")
                continue
            raise


def resolve_model_dir(name_or_path: str) -> str:
    """A registry name or a path -> a local artifact directory, in this
    order: an existing local path; ``$E4T_MODELS_DIR/<name>``; a download
    of the registry's ``FILES`` (``unet.pt`` where ``weight_offsets.pt`` is
    missing: a tuned artifact)."""
    if os.path.exists(name_or_path):
        return name_or_path
    assert name_or_path in MODELS, (
        f"{name_or_path!r} is neither a local path nor one of "
        f"{list(MODELS.keys())}")
    mirror = os.environ.get(MIRROR_ENV)
    if mirror:
        local = os.path.join(mirror, name_or_path)
        if os.path.isdir(local):
            return local
    entry = MODELS[name_or_path]
    last: Optional[str] = None
    for filename in FILES:
        try:
            last = download_from_huggingface(
                entry["repo"], filename, subfolder=entry["subfolder"])
        except Exception:
            if filename == "weight_offsets.pt":
                last = download_from_huggingface(
                    entry["repo"], "unet.pt", subfolder=entry["subfolder"])
            else:
                raise
    return os.path.dirname(last)
