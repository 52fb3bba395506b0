"""ctypes bindings for the native C++ media runtime (native/vexpress_media.cpp,
shared with vexpress_tpu). The port's own copy of
vexpress_tpu/utils/media_native.py.

Replaces the reference's torchaudio.load/resample (inference.py:245-253) and
ffmpeg-subprocess audio muxing (pipelines/utils.py:84-86). Reads WAV files
with the standard library when the shared library is not built.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import wave
from typing import Optional

import numpy as np

_LIB_NAME = "libvexpress_media.so"
_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _native_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "native"


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    path = _native_dir() / _LIB_NAME
    if not path.exists():
        # try to build it (g++ + ffmpeg dev headers are baked into the image)
        try:
            subprocess.run(["make", "-C", str(_native_dir())], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.vx_decode_audio.restype = ctypes.c_long
    lib.vx_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.vx_mux_av.restype = ctypes.c_int
    lib.vx_mux_av.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_int]
    lib.vx_free.restype = None
    lib.vx_free.argtypes = [ctypes.c_void_p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vx_venc_open.restype = ctypes.c_void_p
    lib.vx_venc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_char_p, ctypes.c_int]
    lib.vx_venc_write.restype = ctypes.c_int
    lib.vx_venc_write.argtypes = [ctypes.c_void_p, u8p, u8p, u8p,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.vx_venc_close.restype = ctypes.c_int
    lib.vx_venc_close.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return _lib


def load_audio(path: str, target_rate: int = 16000) -> np.ndarray:
    """Decode any audio file to mono float32 PCM at target_rate."""
    lib = _load_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        err = ctypes.create_string_buffer(512)
        n = lib.vx_decode_audio(str(path).encode(), int(target_rate),
                                ctypes.byref(out), err, len(err))
        if n > 0:
            arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
            lib.vx_free(out)
            return arr
        raise RuntimeError(f"native audio decode failed for {path}: {err.value.decode()}")
    # fallback: stdlib WAV only
    if str(path).lower().endswith(".wav"):
        return _load_wav(path, target_rate)
    raise RuntimeError(
        f"cannot decode {path}: native media library unavailable and only .wav "
        f"is supported by the fallback (build native/ with `make`)"
    )


def _load_wav(path: str, target_rate: int) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    data = data.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        data = resample_linear(data, int(round(len(data) * target_rate / rate)))
    return data


def resample_linear(x: np.ndarray, out_len: int) -> np.ndarray:
    """Linear resampling (sufficient for the WAV fallback path)."""
    if out_len == len(x):
        return x
    pos = np.linspace(0, len(x) - 1, out_len)
    return np.interp(pos, np.arange(len(x)), x).astype(np.float32)


def mux_audio_video(video_path: str, audio_path: str, out_path: str) -> None:
    """Remux video file + audio file into out_path (stream copy, shortest)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native media library unavailable; cannot mux audio")
    err = ctypes.create_string_buffer(512)
    ret = lib.vx_mux_av(str(video_path).encode(), str(audio_path).encode(),
                        str(out_path).encode(), err, len(err))
    if ret != 0:
        raise RuntimeError(f"mux failed: {err.value.decode()}")


class NativeVideoEncoder:
    """Streaming YUV420P mp4 encoder (native vx_venc_*).

    Consumes Y/U/V uint8 planes directly — the pipeline converts RGB->YUV420
    on DEVICE, so the host link carries half the bytes and the host never
    does a colorspace conversion (the cv2.VideoWriter path converted
    RGB->BGR in numpy, then BGR->YUV420 again inside ffmpeg)."""

    def __init__(self, path: str, width: int, height: int, fps: float):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native media library unavailable (build native/ with make)")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._h = lib.vx_venc_open(str(path).encode(), int(width), int(height),
                                   float(fps), err, len(err))
        if not self._h:
            raise RuntimeError(f"native video encoder open failed: {err.value.decode()}")
        self.width, self.height = width, height

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        assert y.shape == (self.height, self.width), y.shape
        assert u.shape == (self.height // 2, self.width // 2), u.shape
        assert v.shape == u.shape, (v.shape, u.shape)
        y = np.ascontiguousarray(y, np.uint8)
        u = np.ascontiguousarray(u, np.uint8)
        v = np.ascontiguousarray(v, np.uint8)
        err = ctypes.create_string_buffer(512)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ret = self._lib.vx_venc_write(
            self._h, y.ctypes.data_as(u8p), u.ctypes.data_as(u8p),
            v.ctypes.data_as(u8p), err, len(err))
        if ret != 0:
            raise RuntimeError(f"native video encode failed: {err.value.decode()}")

    def close(self) -> None:
        if self._h:
            err = ctypes.create_string_buffer(512)
            ret = self._lib.vx_venc_close(self._h, err, len(err))
            self._h = None
            if ret != 0:
                raise RuntimeError(f"native video finalize failed: {err.value.decode()}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_available() -> bool:
    return _load_lib() is not None
