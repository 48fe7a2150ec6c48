"""The port's mel + F0 features (a host numpy copy of the JAX package's
``pipeline/mel_f0.py``) against the JAX package's, bit for bit, on a seeded
1 s 16 kHz signal: a voiced, vibrato square-ish tone with noise and a
silent tail, so that the F0 track has voiced frames, octave candidates and
unvoiced ones. Also the filterbank and the STFT magnitude with
``center=True``.
"""

import numpy as np
import pytest

from dawn_tpu.pipeline import mel_f0 as jax_mel_f0
from dawn_tpu_torch.pipeline import mel_f0

SR = 16000


@pytest.fixture(scope="module")
def wav():
    rng = np.random.RandomState(7)
    t = np.arange(SR) / SR
    f0 = 140 + 25 * np.sin(2 * np.pi * 3 * t)
    voice = np.tanh(3 * np.sin(2 * np.pi * np.cumsum(f0) / SR))
    x = 0.4 * voice + 0.02 * rng.randn(SR)
    x[int(0.8 * SR):] = 0.001 * rng.randn(SR - int(0.8 * SR))
    return x.astype(np.float32)


def test_mel_f0_matches_jax(wav):
    mel, f0, coarse = mel_f0.extract_mel_f0(wav)
    want = jax_mel_f0.extract_mel_f0(wav)
    assert mel.shape == (49, 80) and f0.shape == coarse.shape == (49,)
    assert (f0 > 0).sum() > 20 and (f0 == 0).sum() > 3        # voiced and unvoiced frames
    for got, ref, name in zip((mel, f0, coarse), want, ("mel", "f0", "f0_coarse")):
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_filterbank_and_stft_match_jax(wav):
    np.testing.assert_array_equal(mel_f0.mel_filterbank(), jax_mel_f0.mel_filterbank())
    np.testing.assert_array_equal(mel_f0.stft_mag(wav, center=True),
                                  jax_mel_f0.stft_mag(wav, center=True))
    np.testing.assert_array_equal(mel_f0.f0_to_coarse(np.array([0.0, 80.0, 300.0, 900.0])),
                                  jax_mel_f0.f0_to_coarse(np.array([0.0, 80.0, 300.0, 900.0])))
