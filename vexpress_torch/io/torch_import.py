"""Released torch checkpoints -> the port's modules, by their native keys.
Counterpart of vexpress_tpu/io/torch_import.py.

The released V-Express weights are five torch state dicts
(denoising_unet.bin, reference_net.bin, motion_module.bin, v_kps_guider.bin,
audio_projection.bin; reference: inference.py:77-129) plus the HF VAE and
wav2vec2 directories. The port's modules carry the diffusers key names and
torch layouts, so a checkpoint loads tensor by tensor with no conversion;
what is checked is that every tensor finds its place, with the right shape.
Also the reference's checkpoint-lineage remaps (train.py:122-161: old_attn,
moore_pretrained, new_attn).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

# checkpoint tensors with no place in the modules, by design
_SKIP_PATTERNS: Tuple[str, ...] = (
    r"pos_encoder\.pe$",  # sinusoidal buffer, recomputed
    r"num_batches_tracked$",
)
# unconsumed keys that are not errors: frozen-model buffers by leaf name, and
# the lineage-remap sources that remap_lineage leaves behind (any segment)
_IGNORABLE_LEAF_NAMES = ("masked_spec_embed", "position_ids")
_IGNORABLE_SEGMENTS = ("processor",)


def is_ignorable_unconsumed(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] in _IGNORABLE_LEAF_NAMES or any(s in parts for s in _IGNORABLE_SEGMENTS)


def is_ignorable_audio_unconsumed(key: str) -> bool:
    """`is_ignorable_unconsumed` for the audio encoder's checkpoint, which may
    also carry a CTC head (`lm_head.*`: the CLI's default wav2vec2-base-960h
    is a Wav2Vec2ForCTC checkpoint). The encoder ends before that head, as
    the reference's Wav2Vec2Model.from_pretrained drops it."""
    return key.startswith("lm_head.") or is_ignorable_unconsumed(key)


@torch.no_grad()
def load_native_state_dict(module: torch.nn.Module,
                           state_dict: Mapping[str, torch.Tensor]) -> Tuple[int, List[str]]:
    """Copy each checkpoint tensor into the module's tensor of the same key,
    cast to its dtype and device; module tensors the checkpoint lacks keep
    their values (partial checkpoints overlay, as the motion module does).
    Returns (tensors loaded, checkpoint keys with no destination); a shape
    mismatch raises."""
    dest = module.state_dict(keep_vars=True)
    n, unconsumed = 0, []
    for key, value in state_dict.items():
        if any(re.search(p, key) for p in _SKIP_PATTERNS):
            continue
        if key not in dest:
            unconsumed.append(key)
            continue
        value = torch.as_tensor(value)
        if tuple(dest[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(dest[key].shape)} vs "
                             f"{tuple(value.shape)}")
        dest[key].copy_(value)
        n += 1
    return n, unconsumed


def remap_lineage(state_dict: Mapping, state_dict_type: str) -> Dict:
    """Reference train.py:122-161: derive attn1_5/norm1_5 weights and audio
    attn2 weights for older checkpoint lineages."""
    out = dict(state_dict)
    if state_dict_type == "new_attn":
        return out
    if state_dict_type not in ("old_attn", "moore_pretrained"):
        raise ValueError(f"unsupported state_dict_type {state_dict_type}")
    for name in list(state_dict.keys()):
        if "norm1" in name and "norm1_5" not in name:
            out[name.replace("norm1", "norm1_5")] = state_dict[name]
        if "attn1" in name and "attn1_5" not in name:
            out[name.replace("attn1", "attn1_5")] = state_dict[name]
        if state_dict_type == "old_attn":
            for part in ("to_q", "to_k", "to_v", "to_out"):
                tgt = f"attn2.{part}"
                if tgt in name:
                    # the reference indexes unconditionally: a malformed
                    # old_attn checkpoint fails here rather than keeping the
                    # SD text-attention weights in attn2
                    src = name.replace(tgt, f"attn2.processor.{part}_aud")
                    if src not in state_dict:
                        raise KeyError(f"old_attn checkpoint has {name} but no {src}; "
                                       "is this really an old_attn-lineage state dict?")
                    out[name] = state_dict[src]
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .bin/.pth/.safetensors torch checkpoint as CPU tensors."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(str(path)))
    return dict(torch.load(path, map_location="cpu", weights_only=True))
