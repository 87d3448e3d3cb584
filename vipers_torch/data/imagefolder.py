"""ImageFolder dataset and its threaded batch loader (the port's own copy
of ``vipers/data/imagefolder.py``).

A thread pool decodes each sample with a numpy generator keyed on (seed,
stream position, index); batches come out as uint8 numpy (N, H, W, C) and
are normalized on the device (``data.preprocess.make_device_normalize``),
so the host sends one byte a pixel. For the same seed the batches equal the
JAX loader's bit for bit.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import os
import pickle
from typing import Callable, List, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


class ImageFolder:
    """``root/<class>/<image>``, classes in sorted order. ``cache_dir``
    keeps the listing in ``imagefolder_<sha1(abspath(root))>.pkl`` there
    (the JAX package's file, so either package reads the other's)."""

    def __init__(self, root: str, cache_dir: str = ""):
        self.root = root
        cache_path = None
        if cache_dir:
            h = hashlib.sha1(os.path.abspath(root).encode()).hexdigest()
            cache_path = os.path.join(cache_dir, f"imagefolder_{h}.pkl")
            if os.path.exists(cache_path):
                with open(cache_path, "rb") as f:
                    self.classes, self.class_to_idx, self.samples = pickle.load(f)
                return
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        if cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            with open(cache_path, "wb") as f:
                pickle.dump((self.classes, self.class_to_idx, self.samples), f)

    def __len__(self):
        return len(self.samples)


class ImageFolderLoader:
    """Batches over an index stream, decoded on ``num_workers`` threads with
    two batches in flight. ``decode_fn(path, rng) -> uint8 (H, W, C)`` of a
    fixed size. Yields (uint8 (B, H, W, C), int32 (B,)) numpy pairs; the
    last partial batch is dropped with ``drop_last`` (train) and kept
    otherwise (eval). A sample's generator is keyed on (seed, its position
    in the global stream, its index): with ``rank`` / ``world`` (a
    data-parallel run's batch-interleaved share, ``data.sampler``) the b-th
    batch's j-th sample sits at ``b * B * world + rank * B + j``, so the
    ranks decode what one process decodes at the global batch. Index -1 is
    a sentinel row: a zero image labelled -1."""

    def __init__(self, dataset: ImageFolder, indices: Sequence[int], batch_size: int,
                 decode_fn: Callable, num_workers: int = 8, drop_last: bool = False,
                 seed: int = 0, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.decode_fn = decode_fn
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = rank, world
        self._pad_row = None  # the sentinel's zero image, shaped by one decode

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        bs = self.batch_size
        idxs = self.indices
        batches = [idxs[i: i + bs] for i in range(0, len(idxs), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()

        def decode_one(args):
            pos, idx = args
            if idx < 0:
                if self._pad_row is None:
                    probe = self.decode_fn(self.dataset.samples[0][0], np.random.default_rng(0))
                    self._pad_row = np.zeros_like(probe)
                return self._pad_row, -1
            path, label = self.dataset.samples[idx]
            rng = np.random.default_rng((self.seed, pos, idx))
            return self.decode_fn(path, rng), label

        with cf.ThreadPoolExecutor(max_workers=max(self.num_workers, 1)) as pool:
            pending = []
            it = iter(enumerate(batches))

            def submit_next():
                try:
                    bpos, batch = next(it)
                except StopIteration:
                    return
                base = bpos * bs * self.world + self.rank * bs
                pending.append([pool.submit(decode_one, (base + j, i))
                                for j, i in enumerate(batch)])

            submit_next()
            submit_next()
            while pending:
                results = [f.result() for f in pending.pop(0)]
                submit_next()
                images = np.stack([r[0] for r in results])
                labels = np.asarray([r[1] for r in results], dtype=np.int32)
                yield images, labels
