"""Prompt template sets (training-time captions).

The port's own copy of ``e4t_diffusion_tpu/templates.py``: the reference's
template strings, which are behavioural configuration (a tuned model was
trained on them).
"""
from typing import List

templates = [
    "a photo of {placeholder_token}",
    "the photo of {placeholder_token}",
    "a photo of a {placeholder_token}",
    "a photo of the {placeholder_token}",
    "a photo of one {placeholder_token}",
    "a close-up photo of the {placeholder_token}",
    "a bright photo of the {placeholder_token}",
    "a photo of a nice {placeholder_token}",
    "a good photo of {placeholder_token}",
    "a photo of a cool {placeholder_token}",
]

face_templates = templates + [
    "a portrait of {placeholder_token}",
    "the portrait of {placeholder_token}",
    "a portrait photo of {placeholder_token}",
    "portrait of {placeholder_token}",
    "portrait of the {placeholder_token}",
    "photo realistic portrait of {placeholder_token}",
]

art_templates = templates + [
    "art of {placeholder_token}",
    "art by {placeholder_token}",
]

TEMPLATE_SETS = {"normal": templates, "face": face_templates,
                 "art": art_templates}


def resolve_templates(prompt_template: str) -> List[str]:
    """'normal' | 'face' | 'art', or one custom template that names
    '{placeholder_token}'."""
    if prompt_template in TEMPLATE_SETS:
        return TEMPLATE_SETS[prompt_template]
    if "{placeholder_token}" not in prompt_template:
        raise ValueError("You must specify the location of placeholder token "
                         "by '{placeholder_token}'")
    return [prompt_template]
