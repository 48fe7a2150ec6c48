"""The training datasets: chunked-npy HDTF clips.

Port of ``dawn_tpu/train/data.py``: one subdirectory per
video and modality (frames, hubert, pose, eye, optional lmk) full of
25-frame ``chunk_%04d.npy`` blocks, and ``length_dict.pkl`` mapping each
video to its frame count; the reference's held-out test split and bad
videos are left out of training.

- :class:`HDTFVideoDataset`: the DM's clips, read by ``np.load`` or by the
  threaded C++ reader (:class:`NativeChunkReader`); clip starts optionally
  on a grid (``start_stride``) so that clips recur across epochs;
  :meth:`HDTFVideoDataset.batches_prefetched` assembles batches on a
  worker thread, ahead of the step, and copies them to the card there;
- :class:`TeacherCache`: the frozen teacher's tensors per (video, start)
  clip on disk, in the JAX package's ``.npz`` layout and file names;
- :class:`PBnetPoseDataset`: the PBnet's (hubert, normalised pose, eye)
  sequences, held in memory; :func:`collate_padded` and
  :func:`lengths_to_mask` for ragged batches;
- :func:`frame_pair_batches`: the LFG's (source, driving) frame pairs of
  ``scripts/train_lfg.py:20-50``, augmented by
  :func:`dawn_tpu_torch.train.augment.augment_frame_pair`;
- :class:`FramesDataset` (``dawn_tpu/train/data.py:402-490`` in test mode):
  a folder of videos (frame images, chunked npy, mp4 or npy) read whole, as
  the LFG evaluation reads them.

Clips, pairs and batches are drawn from a ``np.random.RandomState``, the
same stream as the JAX package's, so one seed gives the same batches in
both, whichever reader reads them.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

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


def read_block_range(video_dir: str, start: int, end: int,
                     reader: Optional["NativeChunkReader"] = None) -> np.ndarray:
    """Frames [start, end) across the chunk_%04d.npy blocks of one video,
    read by ``reader`` (all blocks at once, in parallel) or by ``np.load``.
    The last block index comes from end - 1, so a range ending on a block
    boundary does not touch the next chunk, which may not exist."""
    if end <= start:
        raise ValueError(f"empty frame range [{start}, {end})")
    b0, b1 = start // BLOCK, (end - 1) // BLOCK
    p0, p1 = start - b0 * BLOCK, end - b1 * BLOCK
    paths = [os.path.join(video_dir, f"chunk_{i:04d}.npy") for i in range(b0, b1 + 1)]
    arrs = reader.read_many(paths) if reader is not None else [np.load(p) for p in paths]
    if len(arrs) == 1:
        return arrs[0][p0:p1]
    return np.concatenate([arrs[0][p0:]] + arrs[1:-1] + [arrs[-1][:p1]])


class NativeChunkReader:
    """Parallel .npy reads through the C++ reader
    (:class:`dawn_tpu_torch.runtime.native.NpyPrefetcher`): ``read_many``
    submits every path at once, so the reader threads overlap the file
    reads, and returns the arrays in order. The small headers are parsed
    here; the threads read the payloads. Raises when the library cannot be
    built."""

    def __init__(self, n_threads: int = 4, queue_cap: int = 32):
        from dawn_tpu_torch.runtime.native import NpyPrefetcher
        self._pf = NpyPrefetcher(n_threads, queue_cap)

    @staticmethod
    def _header(path: str):
        """(shape, fortran_order, dtype) of a .npy file."""
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                return np.lib.format.read_array_header_1_0(f)
            return np.lib.format.read_array_header_2_0(f)

    def read_many(self, paths: Sequence[str]) -> List[np.ndarray]:
        metas = [self._header(p) for p in paths]
        for i, p in enumerate(paths):
            self._pf.submit(p, i)
        cap = max(os.path.getsize(p) for p in paths)
        out: List[Optional[np.ndarray]] = [None] * len(paths)
        for _ in paths:
            buf, tag = self._pf.next(cap)
            shape, fortran, dtype = metas[tag]
            out[tag] = buf.view(dtype).reshape(shape, order="F" if fortran else "C")
        return out  # type: ignore[return-value]

    def close(self) -> None:
        self._pf.close()


def _pad_frames(a: np.ndarray, n: int) -> np.ndarray:
    """Edge-pad the leading (time) axis of ``a`` up to n frames."""
    if a.shape[0] >= n:
        return a
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1), mode="edge")


class HDTFVideoDataset:
    """DM training clips over per-modality chunk directories. With
    ``start_stride`` a clip starts on a multiple of it, so that the same
    (video, start) clips recur across epochs (the teacher cache's keys);
    without, anywhere (the reference's uniform start)."""

    def __init__(self, frames_dir: str, hubert_dir: str, pose_dir: str, eye_dir: str,
                 length_dict_path: str, lmk_dir: Optional[str] = None,
                 num_frames: int = 20, seed: int = 0, start_stride: Optional[int] = None):
        with open(length_dict_path, "rb") as f:
            self.len_dict = pickle.load(f)
        self.dirs = dict(frames=frames_dir, hubert=hubert_dir, pose=pose_dir,
                         eye=eye_dir, lmk=lmk_dir)
        self.num_frames = num_frames
        self.start_stride = start_stride
        self.rng = np.random.RandomState(seed)
        self.videos = [v for v in sorted(os.listdir(frames_dir))
                       if v not in HDTF_TEST_SPLIT and v not in HDTF_BAD_VIDEOS]

    def __len__(self) -> int:
        return len(self.videos)

    def sample(self, idx: int, reader: Optional[NativeChunkReader] = None
               ) -> Dict[str, np.ndarray]:
        """One clip of video ``idx``: 'video' (T, H, W, 3) in its stored dtype
        (0-255), 'hubert' (T, 1024), 'pose' (T, 7), 'blink' (T, 2), 'bbox'
        (6,), with lmk 'mouth_lmk' (T, 19, 2); and the clip's 'name' and
        'start'."""
        name = self.videos[idx]
        total = self.len_dict[name]
        nf = min(self.num_frames, total)
        if total <= nf:
            start = 0
        elif self.start_stride:
            start = int(self.rng.randint((total - nf) // self.start_stride + 1)) \
                * self.start_stride
        else:
            start = int(self.rng.randint(total - nf))

        def block(kind):
            return read_block_range(os.path.join(self.dirs[kind], name), start, start + nf,
                                    reader)

        out = {"video": block("frames"),
               "hubert": block("hubert").astype(np.float32),
               "pose": block("pose").astype(np.float32),
               "blink": block("eye").astype(np.float32)[:, :2],
               "name": name, "start": start}
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

    def batches(self, batch_size: int, steps: int, reader: Optional[NativeChunkReader] = None,
                with_meta: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` batches of clips of random videos, fixed shapes: clips
        shorter than num_frames are edge-padded. With ``with_meta`` each item
        is (batch, [(name, start), ...]), the clips' teacher-cache keys."""
        for _ in range(steps):
            idxs = self.rng.randint(len(self.videos), size=batch_size)
            samples = [self.sample(int(i), reader) for i in idxs]
            batch = {k: np.stack([s[k] if k == "bbox" else _pad_frames(s[k], self.num_frames)
                                  for s in samples])
                     for k in samples[0] if k not in ("name", "start")}
            yield (batch, [(s["name"], s["start"]) for s in samples]) if with_meta else batch

    def batches_prefetched(self, batch_size: int, steps: int, n_threads: int = 4,
                           depth: int = 2, with_meta: bool = False,
                           device=None) -> Iterator[Dict[str, Any]]:
        """:meth:`batches` assembled ahead on a worker thread, its chunk files
        read in parallel by :class:`NativeChunkReader`, into a queue of
        ``depth`` batches, while the caller runs its step: the same batches
        (the same ``self.rng`` stream, the same assembly). With a CUDA
        ``device`` the worker also copies each batch there (the JAX
        package's worker-side ``transform``), from pinned memory on a stream
        of its own, and records an event; the consumer's stream waits on
        that event and the tensors are marked as used by it
        (``record_stream``) before the batch is handed over, so the caching
        allocator cannot hand their memory out early. A worker's exception
        is raised here, on the consumer's side. Raises when the reader
        cannot be built."""
        import queue
        import threading

        reader = NativeChunkReader(n_threads)
        copy = _CudaCopy(device) if device is not None and \
            torch.device(device).type == "cuda" else None
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def offer(item) -> bool:
            """Queue ``item`` unless the consumer has gone; False if it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self.batches(batch_size, steps, reader, with_meta):
                    batch, meta = item if with_meta else (item, None)
                    if copy is not None:
                        batch = copy.put(batch)
                    if not offer((batch, meta)):
                        return
                offer(None)
            except BaseException as e:          # raised on the consumer's side
                offer(e)
            finally:
                reader.close()

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, meta = item
                if copy is not None:
                    batch = copy.take(batch)
                yield (batch, meta) if with_meta else batch
        finally:
            stop.set()
            thread.join()


class _CudaCopy:
    """Host-to-card copies of batches on a side stream: ``put`` runs on the
    producing thread, ``take`` on the consuming one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def put(self, batch: Dict[str, Any]):
        with torch.cuda.stream(self.stream):
            out = {k: (v if isinstance(v, torch.Tensor) else
                       torch.from_numpy(np.ascontiguousarray(v))).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def take(self, item) -> Dict[str, torch.Tensor]:
        out, event = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for v in out.values():
            v.record_stream(stream)
        return out


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class TeacherCache:
    """Disk cache of the frozen teacher's tensors ('real_vid_grid',
    'real_vid_conf', 'ref_img_fea'), keyed (video id, clip start), one
    ``<name>__<start:06d>.npz`` per clip: the JAX package's layout and file
    names, so either package reads the other's cache. The DM loss reads the
    video only through the teacher, so a recurring clip
    (``HDTFVideoDataset(start_stride=...)``) skips the teacher pass. Entries
    are stored in ``dtype`` (float16 halves the disk at about 5e-4 on [-1,
    1] tensors) and read back as float32; writes go to a temporary file
    first and are renamed into place (``os.replace``), so a reader never
    sees a torn entry."""

    def __init__(self, root: str, dtype=np.float32):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.dtype = dtype
        self.hits = 0
        self.misses = 0

    def _path(self, name: str, start: int) -> str:
        return os.path.join(self.root, f"{name}__{start:06d}.npz")

    def get(self, name: str, start: int) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(name, start)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k].astype(np.float32) for k in z.files}

    def put(self, name: str, start: int, entry: Dict[str, Any]) -> None:
        path = self._path(name, start)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _numpy(v).astype(self.dtype) for k, v in entry.items()})
        os.replace(tmp, path)

    @property
    def hit_rate(self) -> Optional[float]:
        seen = self.hits + self.misses
        return self.hits / seen if seen else None

    def convert_batch(self, batch: Dict[str, Any], meta, compute_fn) -> Dict[str, Any]:
        """The cached-teacher batch of a raw one: 'video' replaced by the
        teacher tensors. ``compute_fn(video_255) -> {key: (B, ...)}`` runs the
        teacher for a batch with any miss, and every miss is stored, so a
        later epoch hits."""
        entries = [self.get(n, s) for n, s in meta]
        if any(e is None for e in entries):
            teacher = {k: _numpy(v) for k, v in compute_fn(batch["video"]).items()}
            for i, (n, s) in enumerate(meta):
                if entries[i] is None:
                    self.misses += 1
                    self.put(n, s, {k: v[i] for k, v in teacher.items()})
                else:
                    self.hits += 1
        else:
            self.hits += len(entries)
            teacher = {k: np.stack([e[k] for e in entries]) for k in entries[0]}
        out = {k: v for k, v in batch.items() if k != "video"}
        out.update(teacher)
        return out

    def convert_batch_shared(self, batch: Dict[str, Any], meta, compute_fn, rank: int,
                             world: int, barrier) -> Dict[str, Any]:
        """:meth:`convert_batch` for ``world`` processes of one machine that
        read the same global batch and share the cache's directory.
        ``barrier()`` blocks until every process has reached it. Each process
        runs the teacher only on its share of the misses (every ``world``-th,
        from its ``rank``) and stores them. Then every process reads the
        whole batch back from disk, in the cache's dtype, so the ranks of one
        clip train on the same values whether it hit or missed. Every
        process counts the same hits and misses."""
        missing = [i for i, (n, s) in enumerate(meta) if not os.path.exists(self._path(n, s))]
        barrier()                      # no process stores before all have looked
        self.misses += len(missing)
        self.hits += len(meta) - len(missing)
        mine = missing[rank::world]
        if mine:
            teacher = {k: _numpy(v) for k, v in compute_fn(batch["video"][mine]).items()}
            for j, i in enumerate(mine):
                self.put(*meta[i], {k: v[j] for k, v in teacher.items()})
        barrier()                      # every miss is stored
        entries = [self.get(n, s) for n, s in meta]
        out = {k: v for k, v in batch.items() if k != "video"}
        out.update({k: np.stack([e[k] for e in entries]) for k in entries[0]})
        return out


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

class FramesDataset:
    """A folder of videos read whole, as the LFG evaluation reads them
    (LFG/frames_dataset.py in test mode): root holds one entry per video, a
    directory of frame images (png/jpg), a chunked-npy directory
    (chunk_*.npy of 25 frames), an .mp4 (read via cv2) or an .npy; each frame
    is resized to ``image_size``^2 with cv2's INTER_AREA where it differs.
    """

    def __init__(self, root_dir: str, image_size: int = 256):
        self.root = root_dir
        self.image_size = image_size
        self.videos = sorted(os.listdir(root_dir))

    def __len__(self):
        return len(self.videos)

    def held_out(self) -> List[int]:
        """Indices of the HDTF test split's videos where the tree has any,
        else of every video, in name order."""
        return ([i for i, v in enumerate(self.videos) if v in HDTF_TEST_SPLIT]
                or list(range(len(self.videos))))

    def _read_video(self, name: str) -> np.ndarray:
        """(T, H, W, 3) float32 [0,1]."""
        path = os.path.join(self.root, name)
        if os.path.isdir(path):
            chunks = sorted(glob.glob(os.path.join(path, "chunk_*.npy")))
            if chunks:
                vid = np.concatenate([np.load(c) for c in chunks])
                return vid.astype(np.float32) / 255.0
            import cv2
            frames = []
            for f in sorted(os.listdir(path)):
                if f.lower().endswith((".png", ".jpg", ".jpeg")):
                    img = cv2.cvtColor(cv2.imread(os.path.join(path, f)),
                                       cv2.COLOR_BGR2RGB)
                    frames.append(img)
            return np.stack(frames).astype(np.float32) / 255.0
        if path.endswith((".mp4", ".gif", ".avi")):
            import cv2
            cap = cv2.VideoCapture(path)
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            cap.release()
            return np.stack(frames).astype(np.float32) / 255.0
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32) / 255.0
        raise ValueError(f"unsupported video entry {path}")

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        s = self.image_size
        if frame.shape[0] == s and frame.shape[1] == s:
            return frame
        import cv2
        return cv2.resize(frame, (s, s), interpolation=cv2.INTER_AREA)

    def sample(self, idx: int):
        """{'video': (T, S, S, 3) f32 in [0, 1], 'name'}."""
        name = self.videos[idx]
        return {"video": np.stack([self._resize(f) for f in self._read_video(name)]),
                "name": name}


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
