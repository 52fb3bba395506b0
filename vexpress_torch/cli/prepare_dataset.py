"""Dataset preparation tools of the PyTorch port. Counterpart of
cli/prepare_dataset.py (reference: scripts/prepare_dataset/*):

    python -m vexpress_torch.cli.prepare_dataset audio-embeddings \\
        --input clip.mp4 --output clip_audio.pt --weights wav2vec2/pytorch_model.bin

Subcommands:
  audio-embeddings  the wav2vec2 feature dump of an audio or video file,
                    {'global_embeds': (T, 1, 768)} (extract_audio_embeddings.py:40-43),
                    on the CUDA device unless --device cpu
  golden-check      numeric diff of re-extracted features against committed
                    goldens (test_read.py semantics)

`face-info` and `kps-sequence` need insightface and are not ported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def cmd_audio_embeddings(args) -> None:
    from ..io.loaders import init_random_, load_wav2vec2_weights
    from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from ..utils.media_native import load_audio

    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available (pass "
                           "--device cpu to run on the CPU)")
    device = torch.device("cpu" if args.device == "cpu" else "cuda")
    model = Wav2Vec2Model(Wav2Vec2Config())
    if args.weights:
        load_wav2vec2_weights(model, args.weights)
    else:
        print("WARNING: no --weights given; using random init (features are meaningless)")
        init_random_(model)
    model = model.to(device).eval()
    wav = load_audio(args.input, 16000)
    with torch.no_grad():
        emb = model(torch.from_numpy(wav)[None].to(device))[0]  # (T, 768)
    out = {"global_embeds": emb.float().cpu()[:, None, :]}
    torch.save(out, args.output)
    print(f"saved {tuple(out['global_embeds'].shape)} embeddings to {args.output}")


def cmd_golden_check(args) -> None:
    a = torch.load(args.extracted, map_location="cpu", weights_only=False)
    b = torch.load(args.golden, map_location="cpu", weights_only=False)
    if isinstance(a, dict) and "global_embeds" in a:
        a, b = a["global_embeds"], b["global_embeds"]
        diff = (a - b).abs()
        print(f"audio embeds: shape {tuple(a.shape)} vs {tuple(b.shape)}; "
              f"mean |diff| {diff.mean():.6f} max {diff.max():.6f}")
        ok = diff.mean() < args.tol
    else:
        kps_a = np.stack([np.asarray(f[0]["kps"]) for f in a])
        kps_b = np.stack([np.asarray(f[0]["kps"]) for f in b])
        diff = np.abs(kps_a - kps_b)
        print(f"face kps: mean |diff| {diff.mean():.4f}px max {diff.max():.4f}px")
        ok = diff.mean() < args.tol
    print("GOLDEN CHECK:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("audio-embeddings")
    a.add_argument("--input", required=True, help="audio or video file")
    a.add_argument("--output", required=True, help="output .pt path")
    a.add_argument("--weights", default="", help="wav2vec2 torch weights (.bin/.safetensors)")
    a.add_argument("--device", default="auto", choices=["auto", "cpu", "cuda"],
                   help="auto and cuda: the CUDA device (raises without one); cpu: the CPU")
    a.set_defaults(fn=cmd_audio_embeddings)

    g = sub.add_parser("golden-check")
    g.add_argument("--extracted", required=True)
    g.add_argument("--golden", required=True)
    g.add_argument("--tol", type=float, default=1e-2)
    g.set_defaults(fn=cmd_golden_check)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
