"""The training datasets: chunked-npy HDTF clips, read with numpy.

Port of ``dawn_tpu/train/data.py:23-224, 339-399, 542-569`` on its
``np.load`` path: one subdirectory per video and modality (frames, hubert,
pose, eye, optional lmk) full of 25-frame ``chunk_%04d.npy`` blocks, and
``length_dict.pkl`` mapping each video to its frame count; the reference's
held-out test split and bad videos are left out of training.

- :class:`HDTFVideoDataset`: the DM's clips;
- :class:`PBnetPoseDataset`: the PBnet's (hubert, normalised pose, eye)
  sequences, held in memory; :func:`collate_padded` and
  :func:`lengths_to_mask` for ragged batches;
- :func:`frame_pair_batches`: the LFG's (source, driving) frame pairs of
  ``scripts/train_lfg.py:20-50``, augmented by
  :func:`dawn_tpu_torch.train.augment.augment_frame_pair`.

Clips, pairs and batches are drawn from a ``np.random.RandomState``, the
same stream as the JAX package's, so one seed gives the same batches in
both. The threaded C++ chunk reader, the prefetching batch iterator and the
teacher cache are not ported yet.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

BLOCK = 25

# held-out HDTF evaluation split and bad videos of the reference datasets
HDTF_TEST_SPLIT = [
    "RD_Radio14_000", "RD_Radio30_000", "RD_Radio47_000", "RD_Radio56_000",
    "WDA_AmyKlobuchar1_001", "WDA_BarbaraLee0_000", "WDA_BobCasey0_000",
    "WDA_CatherineCortezMasto_000", "WDA_DebbieDingell1_000",
    "WDA_DonaldMcEachin_000", "WDA_EricSwalwell_000", "WDA_HenryWaxman_000",
    "WDA_JanSchakowsky1_000", "WDA_JoeDonnelly_000", "WDA_JohnSarbanes1_000",
    "WDA_JoeNeguse_001", "WDA_KatieHill_000", "WDA_LucyMcBath_000",
    "WDA_MazieHirono0_000", "WDA_NancyPelosi1_000", "WDA_PattyMurray0_000",
    "WDA_RaulRuiz_000", "WDA_SeanPatrickMaloney_000", "WDA_TammyBaldwin0_000",
    "WDA_TerriSewell0_000", "WDA_TomCarper_000", "WDA_WhipJimClyburn_000",
    "WRA_AdamKinzinger0_000", "WRA_AnnWagner_000", "WRA_BobCorker_000",
    "WRA_CandiceMiller0_000", "WRA_CathyMcMorrisRodgers2_000",
    "WRA_CoryGardner1_000", "WRA_DebFischer1_000", "WRA_DianeBlack1_000",
    "WRA_ErikPaulsen_000", "WRA_GeorgeLeMieux_000", "WRA_JebHensarling0_001",
    "WRA_JoeHeck1_000", "WRA_JohnKasich1_001", "WRA_MarcoRubio_000",
]
HDTF_BAD_VIDEOS = ["WDA_DanKildee_000", "WDA_PatrickLeahy1_000",
                   "WRA_KristiNoem2_000", "RD_Radio39_000"]


def read_block_range(video_dir: str, start: int, end: int) -> np.ndarray:
    """Frames [start, end) across the chunk_%04d.npy blocks of one video.
    The last block index comes from end - 1, so a range ending on a block
    boundary does not touch the next chunk, which may not exist."""
    if end <= start:
        raise ValueError(f"empty frame range [{start}, {end})")
    b0, b1 = start // BLOCK, (end - 1) // BLOCK
    p0, p1 = start - b0 * BLOCK, end - b1 * BLOCK
    arrs = [np.load(os.path.join(video_dir, f"chunk_{i:04d}.npy"))
            for i in range(b0, b1 + 1)]
    if len(arrs) == 1:
        return arrs[0][p0:p1]
    return np.concatenate([arrs[0][p0:]] + arrs[1:-1] + [arrs[-1][:p1]])


def _pad_frames(a: np.ndarray, n: int) -> np.ndarray:
    """Edge-pad the leading (time) axis of ``a`` up to n frames."""
    if a.shape[0] >= n:
        return a
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1), mode="edge")


class HDTFVideoDataset:
    """DM training clips over per-modality chunk directories."""

    def __init__(self, frames_dir: str, hubert_dir: str, pose_dir: str, eye_dir: str,
                 length_dict_path: str, lmk_dir: Optional[str] = None,
                 num_frames: int = 20, seed: int = 0):
        with open(length_dict_path, "rb") as f:
            self.len_dict = pickle.load(f)
        self.dirs = dict(frames=frames_dir, hubert=hubert_dir, pose=pose_dir,
                         eye=eye_dir, lmk=lmk_dir)
        self.num_frames = num_frames
        self.rng = np.random.RandomState(seed)
        self.videos = [v for v in sorted(os.listdir(frames_dir))
                       if v not in HDTF_TEST_SPLIT and v not in HDTF_BAD_VIDEOS]

    def __len__(self) -> int:
        return len(self.videos)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        """One clip of video ``idx``: 'video' (T, H, W, 3) in its stored dtype
        (0-255), 'hubert' (T, 1024), 'pose' (T, 7), 'blink' (T, 2), 'bbox'
        (6,), with lmk 'mouth_lmk' (T, 19, 2)."""
        name = self.videos[idx]
        total = self.len_dict[name]
        nf = min(self.num_frames, total)
        start = 0 if total <= nf else int(self.rng.randint(total - nf))

        def block(kind):
            return read_block_range(os.path.join(self.dirs[kind], name), start, start + nf)

        out = {"video": block("frames"),
               "hubert": block("hubert").astype(np.float32),
               "pose": block("pose").astype(np.float32),
               "blink": block("eye").astype(np.float32)[:, :2]}
        if self.dirs["lmk"]:
            lmk = block("lmk").astype(np.float32)                 # (T, 68, 2)
            out["mouth_lmk"] = lmk[:, 48:67]                      # the mouth ring
            # the frame-0 face bbox of the location mask
            out["bbox"] = np.array([lmk[0, :, 0].min(), lmk[0, :, 0].max(),
                                    lmk[0, :, 1].min(), lmk[0, :, 1].max(),
                                    out["video"].shape[1], out["video"].shape[2]],
                                   np.float32)
        else:
            h, w = out["video"].shape[1:3]
            out["bbox"] = np.array([0, w - 1, 0, h - 1, h, w], np.float32)
        return out

    def batches(self, batch_size: int, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` batches of clips of random videos, fixed shapes: clips
        shorter than num_frames are edge-padded."""
        for _ in range(steps):
            idxs = self.rng.randint(len(self.videos), size=batch_size)
            samples = [self.sample(int(i)) for i in idxs]
            yield {k: np.stack([s[k] if k == "bbox" else _pad_frames(s[k], self.num_frames)
                                for s in samples])
                   for k in samples[0]}


# ------------------------------------------------------------------- PBnet

# PBnet pose normalization constants (datasets_..._eye_fast.py:62-65)
PBNET_POSE_MAX = np.array([90, 90, 90, 1, 720, 1080], np.float32)
PBNET_POSE_MIN = np.array([-90, -90, -90, 0, 0, 0], np.float32)


def _concat_chunks(directory: str) -> np.ndarray:
    return np.concatenate([np.load(os.path.join(directory, f))
                           for f in sorted(os.listdir(directory))])


class PBnetPoseDataset:
    """The PBnet training set (datasets_hdtf_pos_chunk_norm_eye_fast.py:100-115,
    240-263): every video's hubert, pose and eye chunks concatenated and held
    in memory; a video whose chunks do not load is left out."""

    def __init__(self, hubert_dir: str, pose_dir: str, eye_dir: str, length_dict_path: str,
                 mode: str = "train", num_frames: int = 100, seed: int = 0):
        with open(length_dict_path, "rb") as f:
            self.len_dict = pickle.load(f)
        self.num_frames = num_frames
        self.rng = np.random.RandomState(seed)
        names = (sorted(set(os.listdir(pose_dir)) - set(HDTF_TEST_SPLIT) - set(HDTF_BAD_VIDEOS))
                 if mode == "train" else list(HDTF_TEST_SPLIT))
        self.cache = {}
        for name in names:
            try:
                self.cache[name] = {kind: _concat_chunks(os.path.join(d, name)) for kind, d in
                                    (("hubert", hubert_dir), ("pose", pose_dir),
                                     ("eye", eye_dir))}
            except (OSError, ValueError):
                continue
        self.names = list(self.cache)

    @staticmethod
    def normalize_pose(pose: np.ndarray) -> np.ndarray:
        return (pose[..., :6] - PBNET_POSE_MIN) / (PBNET_POSE_MAX - PBNET_POSE_MIN)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        """A random window of up to num_frames frames of video ``idx``:
        'hubert' (T, 1024), 'pose' (T, 6) normalised, 'eye' (T, 2), 'name'."""
        name = self.names[idx]
        d = self.cache[name]
        total = min(len(d["hubert"]), len(d["pose"]), len(d["eye"]))
        nf = min(self.num_frames, total)
        start = 0 if total <= nf else int(self.rng.randint(total - nf))
        sl = slice(start, start + nf)
        return {"hubert": d["hubert"][sl].astype(np.float32),
                "pose": self.normalize_pose(d["pose"][sl].astype(np.float32)),
                "eye": d["eye"][sl, :2].astype(np.float32),
                "name": name}

    def batches(self, batch_size: int, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` batches of random videos' windows, edge-padded to
        num_frames."""
        for _ in range(steps):
            idxs = self.rng.randint(len(self.names), size=batch_size)
            samples = [self.sample(int(i)) for i in idxs]
            yield {k: np.stack([_pad_frames(s[k], self.num_frames) for s in samples])
                   for k in samples[0] if k != "name"}


def lengths_to_mask(lengths: Sequence[int], max_len: Optional[int] = None) -> np.ndarray:
    """(B,) lengths -> (B, T) bool mask (tensors_eye.py:4-8)."""
    lengths = np.asarray(lengths)
    t = int(max_len if max_len is not None else lengths.max())
    return np.arange(t)[None, :] < lengths[:, None]


def collate_padded(samples: List[Dict[str, np.ndarray]], keys=("x", "hubert")
                   ) -> Dict[str, np.ndarray]:
    """Zero-pad (T_i, D) sequences under ``keys`` to the batch's longest and
    add 'mask' (B, T), 'lengths' (B,) and, when the samples are named,
    'videoname' (tensors_eye.py:10-44)."""
    lengths = np.asarray([len(s[keys[0]]) for s in samples])
    t = int(lengths.max())
    out = {}
    for k in keys:
        canvas = np.zeros((len(samples), t, samples[0][k].shape[-1]), samples[0][k].dtype)
        for i, s in enumerate(samples):
            canvas[i, : len(s[k])] = s[k]
        out[k] = canvas
    out["mask"] = lengths_to_mask(lengths, t)
    out["lengths"] = lengths
    if "name" in samples[0]:
        out["videoname"] = [s["name"] for s in samples]
    return out


# --------------------------------------------------------------------- LFG

def frame_pair_batches(frames_dir: str, batch_size: int, steps: int,
                       rng: np.random.RandomState) -> Iterator[Dict[str, np.ndarray]]:
    """``steps`` batches of random (source, driving) frame pairs, each pair
    two random frames of one random training video, augmented
    (frames_dataset.py:135-167 over the chunked-npy layout): 'source' and
    'driving' (B, H, W, 3) f32 in [0, 1]."""
    from dawn_tpu_torch.train.augment import augment_frame_pair

    videos = [v for v in sorted(os.listdir(frames_dir))
              if v not in HDTF_TEST_SPLIT and v not in HDTF_BAD_VIDEOS]
    lengths: Dict[str, int] = {}
    for _ in range(steps):
        srcs, drvs = [], []
        while len(srcs) < batch_size:
            name = videos[rng.randint(len(videos))]
            vd = os.path.join(frames_dir, name)
            if name not in lengths:
                chunks = sorted(glob.glob(os.path.join(vd, "chunk_*.npy")))
                if not chunks:
                    continue
                lengths[name] = (len(chunks) - 1) * BLOCK + len(np.load(chunks[-1]))
            n = lengths[name]
            i, j = rng.randint(n), rng.randint(n)
            srcs.append(read_block_range(vd, i, i + 1)[0])
            drvs.append(read_block_range(vd, j, j + 1)[0])
        pairs = [augment_frame_pair(rng, s.astype(np.float32) / 255.0,
                                    d.astype(np.float32) / 255.0)
                 for s, d in zip(srcs, drvs)]
        yield {"source": np.stack([p[0] for p in pairs]),
               "driving": np.stack([p[1] for p in pairs])}
