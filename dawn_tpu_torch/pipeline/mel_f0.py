"""Mel-spectrogram + F0 extraction — the alternative audio features.

A copy of ``dawn_tpu/pipeline/mel_f0.py`` (host numpy, as there; the port
imports nothing of the JAX package): the same WAV gives the same mel, F0
and coarse F0, bit for bit.

Capability parity with hubert_extract/data_gen/process_lrs3/
process_audio_mel_f0.py: 16 kHz wav -> log10-mel with the reference's EXACT
parameters (fft 512, hop 320, win 512 hann, center=False, 80 Slaney-scale mel
bins, fmin 80, fmax 7600, eps 1e-6 — :23-56) and F0 (80-750 Hz, hop 320,
:58-75) with NATSpeech's f0_to_coarse bucketing. Parity is tested by driving
the reference extract_mel_from_fname through a numpy librosa shim
(tests/test_audio_features.py).

Pure numpy: the reference's librosa/parselmouth are not dependencies. The
mel path reproduces librosa.stft(center=False) + librosa.filters.mel (Slaney
scale + slaney norm) exactly; F0 implements Boersma (1993) — the algorithm
inside Praat's to_pitch_ac — with the reference's exact call parameters
(time_step=hop/sr, voicing_threshold 0.6, floor 80 / ceiling 750) and
Praat's documented defaults for the rest (silence 0.03, octave cost 0.01,
octave-jump 0.35, voiced/unvoiced 0.14, 15 candidates, 3-period Hanning
window, Viterbi path). Praat bit-parity is unverified (DEVIATIONS.md
#6); the coarse buckets match since f0_to_coarse only sees Hz values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ------------------------------------------------------------------ mel

def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    lin = f / 200.0 * 3.0
    log_region = f >= 1000.0
    return np.where(log_region,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
                    lin)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    lin = m * 200.0 / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    lin)


def mel_filterbank(sr: int = 16000, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 80.0, fmax: float = 7600.0) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters
    (librosa.filters.mel defaults). Returns (n_mels, n_fft//2+1)."""
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney norm: scale by 2 / bandwidth
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def stft_mag(wav: np.ndarray, n_fft: int = 512, hop: int = 320,
             win_length: int = 512, center: bool = False) -> np.ndarray:
    """|STFT| with a periodic hann window (librosa.stft semantics). The
    reference calls librosa.stft(center=False) (process_audio_mel_f0.py:39-41)
    so no padding by default. Returns (frames, n_fft//2+1)."""
    x = wav.astype(np.float64)
    if center:
        x = np.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    win = np.hanning(win_length + 1)[:-1]          # periodic hann
    if win_length < n_fft:
        win = np.pad(win, ((n_fft - win_length) // 2,) * 2)
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * win[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=1)).astype(np.float32)


def extract_mel(wav: np.ndarray, sr: int = 16000, n_fft: int = 512,
                hop: int = 320, win_length: int = 512, n_mels: int = 80,
                fmin: float = 80.0, fmax: float = 7600.0,
                eps: float = 1e-6) -> np.ndarray:
    """16 kHz wav -> (T, n_mels) log10 mel (process_audio_mel_f0.py:23-56)."""
    spc = stft_mag(wav, n_fft, hop, win_length, center=False)  # (T, bins)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)     # (mels, bins)
    mel = spc @ fb.T
    return np.log10(np.maximum(eps, mel)).astype(np.float32)


# ------------------------------------------------------------------- f0
#
# Boersma (1993) "Accurate short-term analysis of the fundamental
# frequency..." — the algorithm behind Praat's Sound.to_pitch_ac, which the
# reference calls with time_step=hop/sr, voicing_threshold=0.6,
# floor 80 / ceiling 750 (process_audio_mel_f0.py:58-67) and Praat defaults
# for everything else. Re-implemented from the paper in numpy: window-ac-
# normalized frame autocorrelation, multiple interpolated lag candidates per
# frame with octave cost, an explicit unvoiced candidate from the local/
# global peak ratio, and a Viterbi path over octave-jump and voiced/unvoiced
# transition costs. Bit parity with Praat is unverified (parselmouth is
# not a dependency); deviations are the peak interpolation (parabolic, Praat uses
# sinc) and the output frame grid (aligned to i*hop like the mel frames
# instead of Praat's sound-centered grid) — DEVIATIONS.md #6.


def _frame_candidates(r, lag_lo, lag_hi, sr, f0_min, f0_max,
                      octave_cost, n_keep):
    """Voiced candidates of one frame from its normalized autocorrelation:
    local maxima of r on [lag_lo, lag_hi], parabolic-refined, scored
    R = r - octave_cost*log2(ceiling/freq) (Boersma eq. 23 as applied in
    Praat's path finder). Returns (freqs, strengths) of the top n_keep."""
    seg = r[lag_lo - 1: lag_hi + 2]
    mid = seg[1:-1]
    is_max = (mid > seg[:-2]) & (mid >= seg[2:]) & (mid > 0.0)
    lags = np.nonzero(is_max)[0] + lag_lo
    if len(lags) == 0:
        return np.empty(0), np.empty(0)
    # parabolic interpolation of the lag and the peak value
    rm1, r0, rp1 = r[lags - 1], r[lags], r[lags + 1]
    denom = np.maximum(2.0 * r0 - rm1 - rp1, 1e-12)
    delta = np.clip(0.5 * (rp1 - rm1) / denom, -0.5, 0.5)
    lag = lags + delta
    val = r0 + 0.25 * (rp1 - rm1) * delta
    freq = sr / lag
    keep = (freq > f0_min) & (freq < f0_max)
    freq, val = freq[keep], val[keep]
    if len(freq) == 0:
        return np.empty(0), np.empty(0)
    # r slightly >1 happens near lag 0 via the window-ac normalization;
    # Praat folds it back (Sound_to_Pitch: strength = 1/strength)
    val = np.where(val > 1.0, 1.0 / val, val)
    strength = val - octave_cost * np.log2(f0_max / freq)
    order = np.argsort(strength)[::-1][:n_keep]
    return freq[order], strength[order]


def extract_f0(wav: np.ndarray, sr: int = 16000, hop: int = 320,
               f0_min: float = 80.0, f0_max: float = 750.0,
               voicing_threshold: float = 0.6,
               silence_threshold: float = 0.03,
               octave_cost: float = 0.01,
               octave_jump_cost: float = 0.35,
               voiced_unvoiced_cost: float = 0.14,
               max_candidates: int = 15) -> np.ndarray:
    """Praat-style F0 track, one value per hop; unvoiced frames -> 0.

    Defaults are Praat's to_pitch_ac defaults except voicing_threshold,
    which the reference passes explicitly as 0.6
    (process_audio_mel_f0.py:64-67)."""
    x = np.asarray(wav, np.float64)
    n_out = max(1, int(np.ceil(len(x) / hop)))
    out = np.zeros(n_out, np.float32)
    global_peak = np.max(np.abs(x - x.mean())) if len(x) else 0.0
    if global_peak == 0.0:
        return out

    # --- analysis grid (Boersma §2: window = 3 periods of the floor)
    dt = hop / sr
    nsw = int(np.floor(3.0 / f0_min * sr))
    nsw = 2 * (nsw // 2 - 1)                     # Praat evenization
    if len(x) < nsw:
        return out
    n_frames = int(np.floor((len(x) - nsw) / hop)) + 1
    t1 = (len(x) / sr - (n_frames - 1) * dt) / 2.0   # Praat-centered grid

    starts = np.round((t1 + dt * np.arange(n_frames)) * sr
                      - nsw / 2.0).astype(int)
    starts = np.clip(starts, 0, len(x) - nsw)
    frames = x[starts[:, None] + np.arange(nsw)[None, :]]
    frames = frames - frames.mean(axis=1, keepdims=True)

    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(1, nsw + 1) / (nsw + 1))
    fw = frames * win
    # local peak over the central half of the windowed frame (Praat)
    local_peak = np.abs(fw[:, nsw // 4: 3 * nsw // 4]).max(axis=1)
    intensity = np.minimum(1.0, local_peak / global_peak)

    # --- window-normalized autocorrelation r(tau) per frame (paper eq. 9)
    lag_lo = max(2, int(np.floor(sr / f0_max)))
    lag_hi = min(int(np.ceil(sr / f0_min)), nsw // 2)
    nfft = int(2 ** np.ceil(np.log2(1.5 * nsw)))
    ac = np.fft.irfft(np.abs(np.fft.rfft(fw, nfft, axis=1)) ** 2, nfft,
                      axis=1)[:, : lag_hi + 2]
    wac = np.fft.irfft(np.abs(np.fft.rfft(win, nfft)) ** 2,
                       nfft)[: lag_hi + 2]
    r0 = np.maximum(ac[:, :1], 1e-30)
    r = (ac / r0) / np.maximum(wac[None, :] / wac[0], 1e-10)

    # --- per-frame candidate lists: slot 0 = unvoiced (paper eq. 23)
    unvoiced_strength = voicing_threshold + np.maximum(
        0.0, 2.0 - intensity / (silence_threshold / (1.0 + voicing_threshold)))
    freqs = np.zeros((n_frames, max_candidates))
    strengths = np.full((n_frames, max_candidates), -1e30)
    strengths[:, 0] = unvoiced_strength
    silent = ac[:, 0] <= 1e-30
    for i in range(n_frames):
        if silent[i]:
            continue
        f, s = _frame_candidates(r[i], lag_lo, lag_hi, sr, f0_min, f0_max,
                                 octave_cost, max_candidates - 1)
        freqs[i, 1: 1 + len(f)] = f
        strengths[i, 1: 1 + len(s)] = s

    # --- Viterbi path (paper eq. 25; Praat Pitch_pathFinder). Praat scales
    # the transition costs by 0.01/dt so they are per-10 ms regardless of
    # the chosen time step.
    tsc = 0.01 / dt
    jump = octave_jump_cost * tsc
    vuv = voiced_unvoiced_cost * tsc
    delta = strengths[0].copy()
    psi = np.zeros((n_frames, max_candidates), np.int64)
    for i in range(1, n_frames):
        fp, fc = freqs[i - 1], freqs[i]
        voiced_p, voiced_c = fp > 0, fc > 0
        trans = np.where(
            voiced_p[:, None] & voiced_c[None, :],
            jump * np.abs(np.log2(np.maximum(fp, 1.0)[:, None]
                                  / np.maximum(fc, 1.0)[None, :])),
            np.where(voiced_p[:, None] == voiced_c[None, :], 0.0, vuv))
        score = delta[:, None] - trans
        psi[i] = np.argmax(score, axis=0)
        delta = score[psi[i], np.arange(max_candidates)] + strengths[i]
    path = np.zeros(n_frames, np.int64)
    path[-1] = int(np.argmax(delta))
    for i in range(n_frames - 2, -1, -1):
        path[i] = psi[i + 1][path[i + 1]]
    f0 = freqs[np.arange(n_frames), path]

    # --- resample Praat's centered grid onto the mel grid (frame i at i*hop)
    k = np.clip(np.round((np.arange(n_out) * hop / sr - t1) / dt
                         ).astype(int), 0, n_frames - 1)
    return f0[k].astype(np.float32)


def f0_to_coarse(f0: np.ndarray, f0_bin: int = 256, f0_min: float = 80.0,
                 f0_max: float = 750.0) -> np.ndarray:
    """NATSpeech pitch bucketing (utils/commons/pitch_utils.py): mel-scale
    quantization into [1, f0_bin-1]; 0 Hz (unvoiced) -> bucket 1."""
    f0_mel = 1127.0 * np.log(1.0 + np.asarray(f0, np.float64) / 700.0)
    mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    f0_mel = np.where(f0_mel > 0,
                      (f0_mel - mel_min) * (f0_bin - 2) / (mel_max - mel_min) + 1,
                      f0_mel)
    f0_mel = np.clip(f0_mel, 1, f0_bin - 1)
    return np.rint(f0_mel).astype(np.int64)


def extract_mel_f0(wav: np.ndarray, sr: int = 16000
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mel (T,80), f0 (T,), f0_coarse (T,)) with f0 length-matched to mel
    (process_audio_mel_f0.py:58-75). Like the reference, F0 runs on the wav
    zero-padded to the next hop multiple (librosa_pad_lr, :12-21,53-54)."""
    mel = extract_mel(wav, sr)
    hop = 320
    pad = (len(wav) // hop + 1) * hop - len(wav)
    f0 = extract_f0(np.pad(np.asarray(wav), (0, pad)), sr)
    if len(f0) < len(mel):
        f0 = np.concatenate([f0, np.full(len(mel) - len(f0), f0[-1])])
    f0 = f0[: len(mel)].astype(np.float32)
    return mel, f0, f0_to_coarse(f0)
