"""The port's chunked decode tail (`pipeline.decode_packed`: decode, 3x3x3
median filter with a one-frame halo, uint8/YUV420 packing, download, one
chunk at a time) on the CPU, with an identity decode as
tests/test_media.py stubs it for the JAX package: bitwise equal to the
whole-clip route and to JAX's `decode_latents` for every tail length from 1
to chunk + 1 at chunk 4, with and without the filter; the YUV420 planes
bitwise equal to `to_yuv420` of the whole-clip filter; the chunked float
filter bitwise equal to JAX's; and no tensor of more than chunk + 2 frames
filtered or packed. Seconds in all."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vexpress_tpu.pipelines import media as j_media
from vexpress_tpu.pipelines.pipeline import VExpressPipeline as JPipeline
from vexpress_torch.pipelines import media as t_media
from vexpress_torch.pipelines import pipeline as t_pipe

CHUNK = 4
LENGTHS = (1, 2, 3, 4, 5, 8, 9, 12, 13)  # one or several chunks, every tail 1..chunk + 1
PORT = types.SimpleNamespace(device=torch.device("cpu"), _decode_chunk=lambda frames: frames)
JAX = types.SimpleNamespace(
    params={"vae": None}, _decode_chunk=lambda p_vae, frames: frames,
    _to_uint8=jax.jit(lambda v: (jnp.clip(v.astype(jnp.float32), 0, 1) * 255).astype(jnp.uint8)))


def _video(f: int) -> np.ndarray:
    return np.random.default_rng(f).uniform(0, 1, (f, 16, 24, 3)).astype(np.float32)


def _tail(video, median_filter, **out):
    return t_pipe.VExpressPipeline.decode_latents(PORT, torch.from_numpy(video), chunk=CHUNK,
                                                  median_filter=median_filter, **out)


@pytest.mark.parametrize("f", LENGTHS)
def test_uint8_tail_matches_whole_clip_and_jax(f):
    video = _video(f)
    v = torch.from_numpy(video)
    for median_filter in (True, False):
        got = _tail(video, median_filter, as_uint8=True)
        whole = t_media.to_uint8(t_media.median_filter_3d(v) if median_filter else v).numpy()
        want = JPipeline.decode_latents(JAX, jnp.asarray(video), chunk=CHUNK,
                                        median_filter=median_filter, as_uint8=True)
        assert got.dtype == np.uint8 and got.shape == (f, 16, 24, 3)
        np.testing.assert_array_equal(got, whole, err_msg=f"filter {median_filter}")
        np.testing.assert_array_equal(got, want, err_msg=f"filter {median_filter}")


@pytest.mark.parametrize("f", LENGTHS)
def test_yuv420_tail_matches_whole_clip(f):
    video = _video(f)
    v = torch.from_numpy(video)
    for median_filter in (True, False):
        got = _tail(video, median_filter, as_yuv420=True)
        whole = t_media.to_yuv420(t_media.median_filter_3d(v) if median_filter else v)
        assert [p.shape for p in got] == [(f, 16, 24), (f, 8, 12), (f, 8, 12)]
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"filter {median_filter}")


@pytest.mark.parametrize("f", LENGTHS)
def test_chunked_filter_matches_jax(f):
    video = _video(f)
    got = t_media.median_filter_3d_chunked(torch.from_numpy(video), chunk=CHUNK).numpy()
    want = np.asarray(j_media.median_filter_3d_chunked(jnp.asarray(video), chunk=CHUNK))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_media.median_filter_3d(torch.from_numpy(video)).numpy())


@pytest.mark.parametrize("as_yuv420", [False, True])
def test_chunked_route_holds_at_most_chunk_plus_two_frames(monkeypatch, as_yuv420):
    """What reaches the decode, `_median_core` and the pack on the chunked
    route: a chunk at most, with its halo at most chunk + 2 frames."""
    seen = {"decode": [], "median": [], "pack": []}

    def spy(name, fn):
        def wrapped(x, *args, **kwargs):
            seen[name].append(x.shape[0])
            return fn(x, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(t_pipe, "_median_core", spy("median", t_media._median_core))
    monkeypatch.setattr(t_pipe, "to_uint8", spy("pack", t_media.to_uint8))
    monkeypatch.setattr(t_pipe, "to_yuv420", spy("pack", t_media.to_yuv420))
    stub = types.SimpleNamespace(device=torch.device("cpu"),
                                 _decode_chunk=spy("decode", lambda frames: frames))
    f = 13
    got = t_pipe.VExpressPipeline.decode_latents(stub, torch.from_numpy(_video(f)), chunk=CHUNK,
                                                 median_filter=True, as_uint8=not as_yuv420,
                                                 as_yuv420=as_yuv420)
    assert (got[0] if as_yuv420 else got).shape[0] == f
    assert seen["decode"] == [4, 4, 4, 1]
    assert seen["median"] == [CHUNK + 2] * 3 + [3]
    assert seen["pack"] == [4, 4, 4, 1]
