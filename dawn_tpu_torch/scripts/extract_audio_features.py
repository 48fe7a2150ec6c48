"""Batch audio feature extraction — HuBERT and/or mel+F0 over a wav folder.

    python -m dawn_tpu_torch.scripts.extract_audio_features --wav-dir D --out-dir O \\
        [--features hubert|mel_f0|both] [--hubert-dir .../hubert-large-ls960-ft]

Port of ``scripts/extract_audio_features.py`` (hubert_extract/data_gen/
process_lrs3/ process_audio_hubert*.py and process_audio_mel_f0.py), with
its flags plus ``--device`` ('cpu' to run on the CPU; the card is the
default). For every ``*.wav`` of ``--wav-dir`` it writes ``<name>.npy``
(HuBERT-large's features interpolated to 25 fps, (T, 1024), computed on the
device) and/or ``<name>_mel_f0.npz`` (``mel`` (T, 80), ``f0`` (T,),
``f0_coarse`` (T,): :mod:`dawn_tpu_torch.pipeline.mel_f0`, host numpy) into
``--out-dir``, skipping outputs that exist, so a cut run resumes.
"""

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the extraction; returns the names of the wavs read."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--features", default="hubert", choices=["hubert", "mel_f0", "both"])
    ap.add_argument("--hubert-dir", default=None, help="HF hubert-large-ls960-ft directory")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.features in ("hubert", "both") and not args.hubert_dir:
        ap.error("--hubert-dir is required for --features hubert/both (no random-weight "
                 "fallback here: extracted features feed training/eval and must come from "
                 "the real checkpoint)")

    import numpy as np

    from dawn_tpu_torch.pipeline.audio import process_audio, read_wav_16k

    wavs = sorted(f for f in os.listdir(args.wav_dir) if f.endswith(".wav"))
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"{len(wavs)} wavs")

    hubert_fwd = None
    if args.features in ("hubert", "both"):
        import torch
        from dawn_tpu_torch import resolve_device
        from dawn_tpu_torch.weights.checkpoints import load_hubert_dir
        model, _ = load_hubert_dir(args.hubert_dir, resolve_device(args.device))
        hubert_fwd = lambda w: model(torch.from_numpy(w)).cpu().numpy()  # noqa: E731

    read = []
    for i, name in enumerate(wavs):
        base = os.path.splitext(name)[0]
        wav_path = os.path.join(args.wav_dir, name)
        try:
            wav = read_wav_16k(wav_path)
        except (OSError, ValueError) as e:
            print(f"skip {name}: {e}")
            continue
        read.append(name)
        if hubert_fwd is not None:
            out = os.path.join(args.out_dir, base + ".npy")
            if not os.path.exists(out):
                np.save(out, process_audio(wav_path, hubert_fwd))
        if args.features in ("mel_f0", "both"):
            out = os.path.join(args.out_dir, base + "_mel_f0.npz")
            if not os.path.exists(out):
                from dawn_tpu_torch.pipeline.mel_f0 import extract_mel_f0
                mel, f0, f0c = extract_mel_f0(wav)
                np.savez(out, mel=mel, f0=f0, f0_coarse=f0c)
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(wavs)}")
    print("done")
    return read


if __name__ == "__main__":
    main()
