"""Audio pipeline: WAV -> 16 kHz -> HuBERT hidden states -> 25 fps features.

Copy of ``dawn_tpu/pipeline/audio.py`` (host numpy/scipy code; the port
imports nothing of the JAX package). The reference's bookkeeping is kept
exactly: kernel 400, stride 320, 1000-frame clips with stride overlap, the
expected-length check and pad, and linear interpolation to the 25 fps frame
count. The resample is scipy's polyphase filter; the forward is the caller's,
in the generator the port's ``HubertModel`` on the card.

Full clips are a constant 320 080 samples; the tail chunk's length varies
per WAV, and each distinct length is simply a new shape to the eager model.
Padding the tail to a bucket would not be exact: the position conv (kernel
128 over frames) lets padded frames bleed into the last ~64 real frames, and
the zero-mean/unit-var normalization is over the whole chunk.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

KERNEL = 400
STRIDE = 320
CLIP_FRAMES = 1000               # frames per processed clip (stride units)
FPS = 25
SR = 16000


def read_wav_16k(path: str) -> np.ndarray:
    """Read any-rate PCM WAV and resample to mono 16 kHz float32."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data[:, 0]                  # [T, C] -> first channel (:466)
    if sr != SR:
        from math import gcd
        g = gcd(int(sr), SR)
        data = resample_poly(data, SR // g, sr // g).astype(np.float32)
    return data


def zero_mean_unit_var(speech: np.ndarray) -> np.ndarray:
    """Wav2Vec2Processor normalization (do_normalize=True for hubert-large)."""
    return ((speech - speech.mean()) / np.sqrt(speech.var() + 1e-7)).astype(np.float32)


def hubert_clip_bounds(total: int) -> Tuple[list, int]:
    """The reference's clip windows + expected output length (:457-499)."""
    clip_length = STRIDE * CLIP_FRAMES
    num_iter = total // clip_length
    expected_t = (total - (KERNEL - STRIDE)) // STRIDE
    bounds = []
    for i in range(num_iter):
        if i == 0:
            bounds.append((0, clip_length - STRIDE + KERNEL))
        else:
            s = clip_length * i
            bounds.append((s, s + clip_length - STRIDE + KERNEL))
    tail_start = clip_length * num_iter if num_iter > 0 else 0
    if total - tail_start >= KERNEL:
        bounds.append((tail_start, total))
    return bounds, expected_t


def hubert_features(speech_16k: np.ndarray,
                    hubert_forward: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Chunked HuBERT hidden states with the reference's exact bookkeeping.

    hubert_forward: (1, S) float32 normalized -> (1, T, 1024) np array.
    """
    speech = zero_mean_unit_var(speech_16k)[None]      # (1, S)
    bounds, expected_t = hubert_clip_bounds(speech.shape[1])
    chunks = [np.asarray(hubert_forward(speech[:, s:e]))[0] for s, e in bounds]
    ret = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 1024), np.float32)
    assert abs(ret.shape[0] - expected_t) <= 1, (ret.shape, expected_t)
    if ret.shape[0] < expected_t:
        ret = np.pad(ret, ((0, expected_t - ret.shape[0]), (0, 0)))
    else:
        ret = ret[:expected_t]
    return ret


def interp_to_fps(features: np.ndarray, num_frames: int) -> np.ndarray:
    """Linear interpolation to the 25 fps frame count (:236-242)."""
    from scipy.interpolate import interp1d
    f = interp1d(np.arange(features.shape[0]), features, kind="linear", axis=0)
    return f(np.linspace(0, features.shape[0] - 1, num_frames)).astype(np.float32)


def process_audio(path: str,
                  hubert_forward: Callable[[np.ndarray], np.ndarray],
                  max_frames: Optional[int] = None) -> np.ndarray:
    """WAV path -> (num_frames, 1024) 25 fps features (process_audio, :202-250)."""
    speech = read_wav_16k(path)
    num_frames = int(speech.shape[0] / SR * FPS)
    feats = hubert_features(speech, hubert_forward)
    out = interp_to_fps(feats, num_frames)
    if max_frames is not None:
        out = out[:max_frames]
    return out
