"""Flax param tree -> torch state-dict keys and layouts.

The port's own copy of the mapping in vexpress_tpu/io/torch_export.py (module
list indices re-expanded, HWIO -> OIHW, conv1d (K, I/g, O) -> (O, I/g, K),
Dense transposed, norm `scale` -> `weight`), plus the rename of the wav2vec2
tree to the transformers checkpoint keys that the port's Wav2Vec2Model uses,
and the per-module `.pth` writers of training (train.py:734-753 of the
reference: `save_torch_checkpoint`, `filter_motion_module`).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np


def _flax_path_to_torch_key(parts) -> str:
    key = ".".join(parts)
    key = re.sub(
        r"\b(down_blocks|up_blocks|resnets|attentions|motion_modules|transformer_blocks"
        r"|downsamplers|upsamplers|norms|attention_blocks|blocks|conv_layers|layers)_(\d+)",
        r"\1.\2",
        key,
    )
    key = key.replace("to_out_0", "to_out.0")
    key = key.replace("net_0_proj", "net.0.proj")
    key = key.replace("net_2", "net.2")
    # audio projection composites
    key = re.sub(r"layers\.(\d+)_attn\.", r"layers.\1.0.", key)
    key = re.sub(r"layers\.(\d+)_ff\.norm\.", r"layers.\1.1.0.", key)
    key = re.sub(r"layers\.(\d+)_ff\.fc1\.", r"layers.\1.1.1.", key)
    key = re.sub(r"layers\.(\d+)_ff\.fc2\.", r"layers.\1.1.3.", key)
    return key


def export_to_torch_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """Nested flax params (with or without the outer {"params": ...}) -> flat
    torch-style state dict of float32 numpy arrays."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(node, parts):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, parts + [k])
            return
        arr = np.asarray(node, dtype=np.float32)
        leaf, prefix = parts[-1], parts[:-1]
        if leaf == "kernel":
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:  # conv1d (K, I/g, O) -> (O, I/g, K)
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
            key = _flax_path_to_torch_key(prefix + ["weight"])
        elif leaf == "scale":
            key = _flax_path_to_torch_key(prefix + ["weight"])
        elif leaf == "bias":
            key = _flax_path_to_torch_key(prefix + ["bias"])
        else:  # passthrough params (latents, pos_emb, ...)
            key = _flax_path_to_torch_key(parts)
            if leaf == "pos_emb":
                key = key + ".weight"  # nn.Embedding
        out[key] = np.ascontiguousarray(arr)

    walk(params, [])
    return out


_WAV2VEC2_RENAMES = (
    (r"^feature_extractor\.conv_layers\.(\d+)_conv\.", r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.(\d+)_layer_norm\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^feature_projection_layer_norm\.", "feature_projection.layer_norm."),
    (r"^feature_projection_projection\.", "feature_projection.projection."),
    (r"^pos_conv_embed_conv\.", "encoder.pos_conv_embed.conv."),
    (r"^encoder_layer_norm\.", "encoder.layer_norm."),
    (r"^layers\.(\d+)\.attention_(q|k|v|out)_proj\.", r"encoder.layers.\1.attention.\2_proj."),
    (r"^layers\.(\d+)\.feed_forward_(intermediate|output)_dense\.",
     r"encoder.layers.\1.feed_forward.\2_dense."),
    (r"^layers\.(\d+)\.", r"encoder.layers.\1."),
)


def wav2vec2_torch_key(key: str) -> str:
    """Exported wav2vec2 key -> transformers Wav2Vec2Model key."""
    for pat, rep in _WAV2VEC2_RENAMES:
        new = re.sub(pat, rep, key)
        if new != key:
            return new
    return key


def filter_motion_module(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """train.py:744-753: the motion-module-only checkpoint."""
    return {k: v for k, v in state_dict.items() if "motion_module" in k}


def save_torch_checkpoint(state_dict: Dict[str, Any], path: str) -> None:
    """torch.save of a flat state dict; numpy arrays become tensors."""
    import torch

    torch.save({k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                for k, v in state_dict.items()}, path)
