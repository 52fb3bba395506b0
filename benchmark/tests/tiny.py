"""A tiny cell on the CPU: the cell's configuration with a few-channel
geometry of every module (vexpress_torch/tools/common.py's TINY_OVERRIDES),
64x64 frames, short clips, for the tests."""

from __future__ import annotations

import copy
import json

from benchmark import spec

TINY = {
    "unet": {"block_out_channels": [8, 16, 16, 16], "attention_head_dim": 2,
             "cross_attention_dim": 12, "norm_num_groups": 4,
             "motion_num_attention_heads": 2, "motion_max_len": 8},
    # the VAE at its published widths, one layer a block: the decoded frames
    # then have the contrast of the full model's (a Y standard deviation of
    # 13-16 levels), so a fault shows at the committed limits
    "vae": {"layers_per_block": 1},
    "wav2vec2": {"hidden_size": 16, "num_hidden_layers": 1, "num_attention_heads": 2,
                 "intermediate_size": 32, "conv_dim": [8, 8], "conv_kernel": [10, 3],
                 "conv_stride": [5, 2], "num_conv_pos_embeddings": 16,
                 "num_conv_pos_embedding_groups": 4},
    "audio_projection": {"dim": 16, "depth": 1, "dim_head": 4, "heads": 2, "num_queries": 5,
                         "embedding_dim": 16, "output_dim": 12, "max_seq_len": 10},
    "guider": {"conditioning_embedding_channels": 8, "block_out_channels": [4, 4, 8, 8]},
}


def tiny_cell(name: str = "infer.ddim25.f44", frames: int = 6, steps: int = 2,
              dtype: str = "float32") -> spec.Cell:
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cell = spec.load(name, bench)
    cfg = copy.deepcopy(cell.config)
    for k, v in TINY.items():
        cfg[k] = {**cfg[k], **v} if k != "audio_projection" else dict(v, ff_mult=4)
    cfg.update(height=64, width=64, dtype=dtype)
    cfg.update(context_frames=4, context_overlap=1)
    traffic = dict(cell.traffic, frames=frames, steps=steps, pool=2)
    return spec.Cell(cell.name, cell.entry, dict(cell.cell), cfg, traffic, cell.end_to_end,
                     cell.per_layer)
