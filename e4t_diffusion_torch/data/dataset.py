"""Training input pipeline: folder, tar-shard and HF ``datasets`` sources
and the image transform.

The port's own copy of ``e4t_diffusion_tpu/data/dataset.py``:

- sources: image folders (``::``-joined directories, listed recursively and
  sorted), tar shards (brace patterns, stdlib ``tarfile``, shards dealt out
  by process, undecodable members skipped), and an HF ``datasets`` name
  (imported only when used);
- the transform: SmallestMaxSize with area resampling (the reference's
  interpolation=3), center or random crop, a p=0.5 horizontal flip and
  x / 127.5 - 1, HWC uint8 -> CHW float32. The draws come from numpy's
  ``default_rng(seed)`` in the same order, so a seed gives the JAX
  package's crops and flips;
- ``E4TDataLoader``: batches of ``{"pixel_values": (B, 3, S, S)}`` from a
  background thread, or from N decode workers.

The loader takes the transform the JAX loader takes: the native C++ one
(``data/native_ops``, the port's copy of ``native/e4t_image.cc``, built at
first use) unless ``E4T_DISABLE_NATIVE=1``, then the numpy/cv2 one
(``make_transform``, cv2.INTER_AREA). The two differ by up to 2/127.5 a
pixel; each gives the JAX loader's arrays bit for bit under the same
setting. A native build that fails raises. The process index and count
come from ``torch.distributed`` when it is initialised, else 0 and 1. cv2
is imported only when a resize is needed.
"""
from __future__ import annotations

import io
import json
import os
import queue
import re
import tarfile
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from e4t_diffusion_torch.data import native_ops

_IMAGE_EXTS = ("jpg", "jpeg", "png", "gif")


def smallest_max_size(image: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side == size (albumentations SmallestMaxSize),
    cv2.INTER_AREA interpolation."""
    h, w = image.shape[:2]
    scale = size / min(h, w)
    if scale == 1.0:
        return image
    import cv2

    new_w, new_h = round(w * scale), round(h * scale)
    return cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_AREA)


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top:top + size, left:left + size]


def random_crop(image: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    h, w = image.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return image[top:top + size, left:left + size]


def make_transform(size: int, random_crop_flag: bool = False,
                   hflip: bool = True, seed: int = 0):
    """HWC uint8 -> CHW float32 in [-1, 1] at ``size`` x ``size``."""
    rng = np.random.default_rng(seed)

    def apply(image: np.ndarray) -> np.ndarray:
        image = smallest_max_size(image, size)
        if random_crop_flag:
            image = random_crop(image, size, rng)
        else:
            image = center_crop(image, size)
        if hflip and rng.random() < 0.5:
            image = image[:, ::-1]
        image = image.astype(np.float32) / 127.5 - 1.0
        return np.ascontiguousarray(image.transpose(2, 0, 1))

    return apply


def load_image_rgb(path_or_file) -> np.ndarray:
    """A local image as an RGB uint8 HWC array."""
    from PIL import Image

    with Image.open(path_or_file) as img:
        return np.asarray(img.convert("RGB"))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def list_image_files_recursively(data_dir: str) -> List[str]:
    """Every image under ``data_dir``, in sorted order, recursively."""
    results: List[str] = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1].lower()
        if "." in entry and ext in _IMAGE_EXTS:
            results.append(full)
        elif os.path.isdir(full):
            results.extend(list_image_files_recursively(full))
    return results


def braceexpand(pattern: str) -> List[str]:
    """Minimal {000..099} / {a,b,c} expansion for shard specs."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        out = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(braceexpand(pattern[:m.start()] + str(i).zfill(len(lo))
                                   + pattern[m.end():]))
        return out
    m = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m:
        out = []
        for alt in m.group(1).split(","):
            out.extend(braceexpand(pattern[:m.start()] + alt
                                   + pattern[m.end():]))
        return out
    return [pattern]


def expand_shards(spec: str) -> List[str]:
    """'::'-joined brace patterns -> the shard list."""
    shards: List[str] = []
    for s in spec.split("::"):
        shards.extend(braceexpand(s))
    return shards


def get_dataset_size(spec: str):
    """(samples, shards) of a shard spec: from ``sizes.json`` beside the
    shards, else from each shard's ``*_stats.json`` (samples None when
    neither exists)."""
    shards = expand_shards(spec)
    sizes_file = os.path.join(os.path.dirname(spec), "sizes.json")
    if os.path.exists(sizes_file):
        with open(sizes_file) as f:
            sizes = json.load(f)
        return sum(int(sizes[os.path.basename(s)]) for s in shards), \
            len(shards)
    total, found = 0, False
    for shard in shards:
        stats = shard.replace(".tar", "_stats.json")
        if os.path.exists(stats):
            with open(stats) as f:
                s = json.load(f)
            total += int(s.get("n_data", s.get("successes", 0)))
            found = True
    return (total if found else None), len(shards)


def iter_tar_shards(shards: Sequence[str], process_index: int = 0,
                    process_count: int = 1, seed: int = 0,
                    resample: bool = True) -> Iterator[np.ndarray]:
    """Decoded RGB arrays from the shards dealt to this process (every
    ``process_count``-th from ``process_index``; all of them when there are
    fewer shards than processes), in a fresh random shard order each pass
    when ``resample``. Undecodable members and unreadable shards are
    skipped with a message."""
    rng = np.random.default_rng(seed + process_index)
    my_shards = list(shards[process_index::process_count]) or list(shards)
    while True:
        order = (rng.permutation(len(my_shards)) if resample
                 else np.arange(len(my_shards)))
        for si in order:
            shard = my_shards[int(si)]
            try:
                with tarfile.open(shard, "r") as tf:
                    for member in tf:
                        if member.name.lower().split(".")[-1] \
                                not in _IMAGE_EXTS:
                            continue
                        try:
                            data = tf.extractfile(member).read()
                            yield load_image_rgb(io.BytesIO(data))
                        except Exception as e:
                            print(f"[data] skipping {member.name}: {e}")
            except Exception as e:
                print(f"[data] skipping shard {shard}: {e}")
        if not resample:
            return


def _shuffled(it: Iterator, buffer_size: int, seed: int) -> Iterator:
    """A shuffle buffer of ``buffer_size`` items (webdataset's shuffle)."""
    rng = np.random.default_rng(seed)
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) >= buffer_size:
            i = int(rng.integers(0, len(buf)))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def process_index_and_count():
    """(rank, world size) from ``torch.distributed`` when it is
    initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class E4TDataLoader:
    """Batches from any of the reference's dataset flavours.

    ``source``: directories joined by '::' (recursive folder dataset); a
    '*.tar' shard spec or ``use_tar`` (tar-shard stream); anything else an
    HF ``datasets`` name (``streaming`` for its iterable form). Yields
    ``{"pixel_values": (B, 3, resolution, resolution) float32 in [-1, 1]}``
    forever; a partial last batch of a finite source is dropped.
    Several processes (``process_index`` / ``process_count``, by default
    the rank and world size of ``torch.distributed``; under tensor
    parallelism the caller passes the dp rank and dp): each reads its own
    samples, the tar source by shards, a folder or HF dataset (streamed or
    not) by its blocks of the one seeded order (``_mine``).
    ``num_workers`` > 1 decodes and transforms on that many threads, each
    with its own transform seeded ``seed + 1000 * (worker + 1)``; the
    sample order is then the order of completion. ``transform_kind``:
    "native" or "cv2", chosen at construction (``E4T_DISABLE_NATIVE``) for
    the loader and every decode worker."""

    def __init__(self, source: str, batch_size: int, resolution: int = 512,
                 random_crop: bool = True, seed: int = 42,
                 use_tar: bool = False, streaming: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 shuffle_buffer: int = 1000, prefetch: int = 2,
                 num_workers: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.resolution = resolution
        self.random_crop = random_crop
        self.num_workers = num_workers
        self.seed = seed
        self.use_tar = use_tar or ".tar" in source
        self.streaming = streaming
        rank, world = process_index_and_count()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        self.transform_kind = ("native" if native_ops.native_enabled()
                               else "cv2")
        if self.transform_kind == "native":
            native_ops.load()  # a failed build raises here, not per image
        self.transform = self._transform(seed)
        self.shuffle_buffer = shuffle_buffer
        self.prefetch = prefetch
        self.num_samples = None
        if self.use_tar:
            self.num_samples, self.num_shards = get_dataset_size(source)

    def _transform(self, seed: int):
        if self.transform_kind == "native":
            return native_ops.make_native_transform(
                self.resolution, self.random_crop, seed=seed)
        return make_transform(self.resolution, self.random_crop, seed=seed)

    def _raw_iter(self):
        """``(source id, thunk)`` pairs: a name for messages and a
        zero-argument decode (-> HWC uint8 RGB), so that the decode can run
        on a worker thread."""
        if self.use_tar:
            it = iter_tar_shards(expand_shards(self.source),
                                 self.process_index, self.process_count,
                                 self.seed)
            for n, img in enumerate(_shuffled(it, self.shuffle_buffer,
                                              self.seed)):
                yield f"tar sample #{n}", (lambda img=img: img)
        elif os.path.isdir(self.source.split("::")[0]):
            files: List[str] = []
            for name in self.source.split("::"):
                files.extend(list_image_files_recursively(name))
            if not files:
                raise FileNotFoundError(f"no images under {self.source}")
            self.num_samples = len(files)
            for i in self._my_indices(len(files)):
                p = files[i]
                yield p, (lambda p=p: load_image_rgb(p))
        else:
            from datasets import load_dataset

            ds = load_dataset(self.source, split="train",
                              streaming=self.streaming)
            if self.streaming:
                ds = ds.shuffle(seed=self.seed, buffer_size=10000)
                pos = 0
                while True:
                    for n, ex in enumerate(ds):
                        if self._mine(pos):
                            yield (f"{self.source}[stream #{n}]",
                                   lambda ex=ex: np.asarray(
                                       ex["image"].convert("RGB")))
                        pos += 1
            else:
                self.num_samples = len(ds)
                for i in self._my_indices(len(ds)):
                    yield (f"{self.source}[{i}]",
                           lambda i=i: np.asarray(
                               ds[i]["image"].convert("RGB")))

    def _my_indices(self, n: int) -> Iterator[int]:
        """This process's sample indices of a finite source: the seeded
        permutations, one after another, dealt out in blocks of
        ``batch_size``, block k to process k mod ``process_count``. At step
        s the processes' batches, in process order, are then the batch a
        single process reads at step s with ``batch_size`` times as many
        samples."""
        rng = np.random.default_rng(self.seed)
        pos = 0
        while True:
            for i in rng.permutation(n):
                if self._mine(pos):
                    yield int(i)
                pos += 1

    def _mine(self, pos: int) -> bool:
        """Whether position ``pos`` of the one ordered stream is this
        process's: its block of ``batch_size`` in each group of
        ``process_count`` blocks."""
        return (pos // self.batch_size) % self.process_count \
            == self.process_index

    def _batch_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        batch = []
        for src, thunk in self._raw_iter():
            try:
                img = thunk()
            except Exception as e:
                print(f"[data] skipping {src}: {e}")
                continue
            batch.append(self.transform(img))
            if len(batch) == self.batch_size:
                yield {"pixel_values": np.stack(batch)}
                batch = []

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers and self.num_workers > 1:
            return self._iter_threaded()
        return self._iter_prefetch()

    def _iter_prefetch(self) -> Iterator[Dict[str, np.ndarray]]:
        """One background thread decodes and batches ``prefetch`` batches
        ahead of the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batch_iter():
                    if not put(b):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
            finally:
                put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, Exception):
                    raise b
                yield b
        finally:
            stop.set()

    def _iter_threaded(self) -> Iterator[Dict[str, np.ndarray]]:
        """A feeder thread hands decode thunks to ``num_workers`` threads
        that decode and transform; the consumer batches what they finish.
        A finite source drains: each worker ends on its sentinel."""
        n = self.num_workers
        thunk_q: "queue.Queue" = queue.Queue(maxsize=4 * n)
        out_q: "queue.Queue" = queue.Queue(
            maxsize=max(2 * self.batch_size, self.prefetch * self.batch_size,
                        n + 1))
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for src_thunk in self._raw_iter():
                    if not put(thunk_q, src_thunk):
                        return
            finally:
                for _ in range(n):
                    put(thunk_q, None)

        def worker(widx: int):
            transform = self._transform(self.seed + 1000 * (widx + 1))
            try:
                while not stop.is_set():
                    try:
                        src_thunk = thunk_q.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if src_thunk is None:
                        return
                    src, thunk = src_thunk
                    try:
                        item = transform(thunk())
                    except Exception as e:
                        print(f"[data] skipping {src}: {e}")
                        continue
                    if not put(out_q, item):
                        return
            finally:
                put(out_q, None)

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, args=(i,), daemon=True)
                    for i in range(n)]
        for t in threads:
            t.start()
        done, batch = 0, []
        try:
            while done < n:
                item = out_q.get()
                if item is None:
                    done += 1
                    continue
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield {"pixel_values": np.stack(batch)}
                    batch = []
        finally:
            stop.set()
