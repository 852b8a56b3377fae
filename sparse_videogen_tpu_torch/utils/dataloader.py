"""Prompt and image sources for batch generation (counterpart of
sparse_videogen_tpu/utils/dataloader.py): a literal prompt, a .txt of
prompts (one per line), or a directory of per-example subdirs
N/{prompt.txt, image.jpg}."""

from __future__ import annotations

import json
import os


def load_prompts(source: str):
    """source -> [(prompt, image path or None)]."""
    if os.path.isdir(source):
        out = []
        for name in sorted(os.listdir(source), key=lambda s: (len(s), s)):
            sub = os.path.join(source, name)
            pf = os.path.join(sub, "prompt.txt")
            if os.path.isdir(sub) and os.path.exists(pf):
                with open(pf) as f:
                    prompt = f.read().strip()
                img = next((c for c in (os.path.join(sub, f"image.{e}") for e in ("jpg", "jpeg", "png"))
                            if os.path.exists(c)), None)
                out.append((prompt, img))
        return out
    if source.endswith(".txt") and os.path.exists(source):
        with open(source) as f:
            return [(line.strip(), None) for line in f if line.strip()]
    return [(source, None)]


def load_prompt_or_image(prompt_source: str, prompt_idx: int, prompt, image_path):
    """The reference dataloader's sources:
    - "prompt": pass-through (prompt_idx must be 0);
    - "I2V_VBench": prompt = a json of {idx: {original, improved}}, the image
      dir holds "<original>.jpg";
    - "I2V_Wan_Web": per-example dirs NNN/{prompt.txt, image.jpg};
    - "T2V_*_VBench", "T2V_*_Web", "T2V_Xingyang_*": prompt = a .txt, one
      prompt a line, prompt_idx picks the line."""
    if prompt_source == "prompt":
        if prompt_idx != 0:
            raise ValueError("--prompt_idx must be 0 with --prompt_source prompt: the prompt is given")
        return prompt, image_path
    if prompt_source == "I2V_VBench":
        if not prompt.endswith(".json"):
            raise ValueError("I2V_VBench: --prompt must be a .json file")
        with open(prompt) as f:
            entry = json.load(f)[str(prompt_idx)]
        image = os.path.join(image_path, f"{entry['original']}.jpg")
        if not os.path.exists(image):
            raise FileNotFoundError(f"I2V_VBench: no image {image}")
        return entry["improved"], image
    if prompt_source == "I2V_Wan_Web":
        if prompt != image_path:
            raise ValueError("I2V_Wan_Web: the prompt and image paths must be the same dir")
        sub = str(prompt_idx).zfill(3)
        with open(os.path.join(prompt, sub, "prompt.txt")) as f:
            text = f.read()
        return text, os.path.join(image_path, sub, "image.jpg")
    if prompt_source in ("T2V_Wan_VBench", "T2V_Hyv_VBench", "T2V_Hyv_Web", "T2V_Xingyang_Motion",
                         "T2V_Xingyang_VBench"):
        if not prompt.endswith(".txt"):
            raise ValueError(f"{prompt_source}: --prompt must be a .txt file")
        with open(prompt) as f:
            lines = f.readlines()
        return lines[prompt_idx], None
    raise ValueError(f"Invalid prompt source: {prompt_source}")
