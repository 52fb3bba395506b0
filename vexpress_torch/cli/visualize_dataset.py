"""Render training-dataset samples to mp4 for visual inspection: the port of
cli/visualize_dataset.py.

For each sampled clip it writes a side-by-side strip, target frames | kps
image | face mask | lip mask, led by the reference image as a freeze-frame of
max(1, int(fps)) frames, so that augmentation (crop, flip, the R-G swap),
mask placement and audio-window alignment can be checked before a training
run. Host work only: no device is touched. cv2 is imported by the functions
that use it.

    python -m vexpress_torch.cli.visualize_dataset --data_meta_paths data/meta.json \\
        --output_dir dataset_debug --num_samples 4 --num_frames 12 --image_size 512
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..pipelines import media
from ..train.dataset import TalkingFaceVideoDataset


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_meta_paths", nargs="+", required=True)
    p.add_argument("--output_dir", type=str, default="./dataset_debug")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--num_frames", type=int, default=12)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--sample_rate", type=int, default=1)
    p.add_argument("--fps", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def to_u8(x) -> np.ndarray:
    """An image in [-1, 1] or [0, 1] -> uint8 RGB."""
    x = np.asarray(x, np.float32)
    if x.min() < -0.01:
        x = (x + 1.0) / 2.0
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def mask_to_rgb(masks, h: int, w: int) -> np.ndarray:
    """(F, h', w') {0, 1} masks -> (F, h, w, 3) uint8, nearest-neighbour."""
    import cv2

    out = np.zeros((len(masks), h, w, 3), np.uint8)
    for i, m in enumerate(masks):
        mi = (np.asarray(m, np.float32) * 255).astype(np.uint8)
        out[i] = cv2.resize(mi, (w, h), interpolation=cv2.INTER_NEAREST)[..., None]
    return out


def sample_video(sample: dict, fps: float) -> np.ndarray:
    """The strip of one sample, led by its reference image's freeze-frame."""
    tgt = to_u8(sample["target_images"])  # (F, H, W, 3)
    kps = to_u8(sample["kps_images"])
    _, h, w, _ = tgt.shape
    strip = np.concatenate([tgt, kps, mask_to_rgb(sample["face_masks"], h, w),
                            mask_to_rgb(sample["lip_masks"], h, w)], axis=2)
    ref = to_u8(sample["reference_image"])
    ref_row = np.concatenate([ref] * 4, axis=1)[None].repeat(max(1, int(fps)), axis=0)
    return np.concatenate([ref_row, strip], axis=0)


def main(argv=None) -> int:
    """Writes sample_<k>.mp4 for up to --num_samples usable clips, trying
    at most 10 times as many indices; returns the number written."""
    args = parse_args(argv)
    ds = TalkingFaceVideoDataset(meta_paths=args.data_meta_paths,
                                 image_size=(args.image_size, args.image_size),
                                 num_frames=args.num_frames, sample_rate=args.sample_rate,
                                 seed=args.seed)
    print(f"[vexpress] dataset: {len(ds)} clips")
    os.makedirs(args.output_dir, exist_ok=True)
    made = 0
    for idx in range(10 * args.num_samples):
        if made >= args.num_samples:
            break
        sample = ds.get_sample(idx)
        if sample is None:
            continue
        out_path = os.path.join(args.output_dir, f"sample_{made}.mp4")
        media.save_video(sample_video(sample, args.fps), None, out_path, fps=args.fps,
                         apply_median_filter=False)
        print(f"[vexpress] {out_path}: {len(sample['target_images'])} frames, audio windows "
              f"{sample['audio_frame_embeddings'].shape}", flush=True)
        made += 1
    if made == 0:
        print("[vexpress] no usable samples (all clips shorter than num_frames?)")
    return made


if __name__ == "__main__":
    main()
