"""Parameter helpers. Counterpart of vexpress_tpu/utils/misc.py."""

from __future__ import annotations

from typing import List

import torch


@torch.no_grad()
def zero_params_matching(module: torch.nn.Module, *substrings: str) -> List[str]:
    """Zero, in place, every parameter whose name contains one of
    `substrings`; returns their names. `--test_stage stage_1` uses it to
    silence the audio cross-attention output and the motion modules
    (reference inference.py:203-214): "attn2.to_out.0" and
    "temporal_transformer.proj_out"."""
    names = [n for n, _ in module.named_parameters() if any(s in n for s in substrings)]
    params = dict(module.named_parameters())
    for n in names:
        params[n].zero_()
    return names
