"""The FLOPs reckoned from the configuration against FlopCounterMode over a
whole clip of the frozen reference, at a tiny size on the CPU."""

import pytest
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, traffic, weights
from benchmark.reference.pipeline import build_models, generate_clip
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("steps,sampler", [(2, "ddim"), (3, "dpmpp_2m")])
def test_clip_flops_match_the_counted_clip(steps, sampler):
    cell = tiny_cell(frames=7, steps=steps)
    cfg, tr = cell.config, dict(cell.traffic, sampler=sampler)
    mods = build_models(cfg, "cpu")
    weights.fill(mods, weights.table(mods), 1)
    inputs = traffic.clip_inputs(tr, cfg, 1, 0)
    with FlopCounterMode(display=False) as fc:
        generate_clip(mods, cfg, traffic.clip_settings(tr, cfg), inputs)
    assert flops.clip_flops(cfg, tr["frames"], steps) == fc.get_total_flops()


def test_flash_ops_count_the_eligible_levels():
    cell = tiny_cell()
    cfg = dict(cell.config, height=512, width=512)
    # 512x512 at SD1.5 widths: 64^2 and 32^2 tokens are eligible, 16^2 and 8^2 not
    cfg["unet"] = dict(cfg["unet"], block_out_channels=[320, 640, 1280, 1280],
                       attention_head_dim=8, layers_per_block=2)
    cfg.update(context_frames=24, context_overlap=4, guidance_scale=3.5)
    per_level = {4096: 40, 1024: 80}
    unet = sum(5 * (2 * 24 + 24) * 4 * 8 * n * n * d for n, d in per_level.items())
    ref = sum(5 * 4 * 8 * n * n * d for n, d in per_level.items())
    assert flops.flash_attention_ops(cfg, 44, 25) == 25 * 2 * unet + ref
