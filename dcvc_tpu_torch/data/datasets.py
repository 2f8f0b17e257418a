"""Training datasets (counterpart of dcvc_tpu/data/datasets.py; reference
src/datasets/image_dataset.py, video_dataset.py): description.json-driven
folders, random crop / flip / pad, RGB -> YCbCr - 0.5 (or raw uint8 RGB),
a random QP with its lambda per sample; and a prefetching batch loader.

The samples are the JAX package's, draw for draw: the numpy bodies are
its own, with PNG files read by utils/png.py (the GPU machine has no
PIL) and the horizontal flip taken on the array.  _to_ycbcr_centered,
_frame_indexes, the two datasets' __len__ / set_* methods and
BatchLoader._collate are verbatim copies, pinned by
tests/test_torch_datasets.py, which also holds the samples and batches
to the JAX loaders'.

BatchLoader yields the JAX loader's batches as CPU tensors (pinned when
asked, for a non_blocking copy to the card); a sample that fails to load
raises in the consumer, where the JAX loader ends the epoch early.
"""

import json
import os
import queue
import threading

import numpy as np
import torch

from ..core.color import rgb2ycbcr_np
from ..utils.png import load_rgb


def _to_ycbcr_centered(img_u8):
    img = img_u8.astype(np.float32) / 255.0
    return (rgb2ycbcr_np(img) - 0.5).astype(np.float32)


class ImageFolder:
    """description.json = list of image paths relative to the root.

    raw_rgb=True returns uint8 RGB patches, which the train step converts
    on the device (train.step.to_model_domain): a quarter of float32's
    host-to-device bytes."""

    def __init__(self, root, patch_h, patch_w, qp_num, lambdas, seed=0,
                 raw_rgb=False):
        self.root = root
        with open(os.path.join(root, "description.json")) as f:
            self.items = json.load(f)
        self.patch_h = patch_h
        self.patch_w = patch_w
        self.qp_num = qp_num
        self.lambdas = np.asarray(lambdas, np.float32)
        self.rng = np.random.default_rng(seed)
        self.raw_rgb = raw_rgb
        self._rng_lock = threading.Lock()

    def __len__(self):
        return len(self.items)

    def set_patch_size(self, patch_w, patch_h):
        self.patch_w, self.patch_h = patch_w, patch_h

    def __getitem__(self, index):
        with self._rng_lock:
            flip = self.rng.random() < 0.5
            fy = self.rng.integers(0, 1 << 30)
            fx = self.rng.integers(0, 1 << 30)
            qp = int(self.rng.integers(0, self.qp_num))
        img = load_rgb(os.path.join(self.root, self.items[index]))
        if flip:
            img = img[:, ::-1]
        h, w = img.shape[:2]
        pad_h = max(0, self.patch_h - h)
        pad_w = max(0, self.patch_w - w)
        if pad_h or pad_w:
            img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                               (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
                         mode="constant")
        y = int(fy % (img.shape[0] - self.patch_h + 1))
        x = int(fx % (img.shape[1] - self.patch_w + 1))
        img = img[y:y + self.patch_h, x:x + self.patch_w]
        x_out = img if self.raw_rgb else _to_ycbcr_centered(img)
        qp = int(qp)
        return {"x": x_out, "qp": np.int32(qp),
                "lambda": np.float32(self.lambdas[qp])}


class VideoFolder:
    """description.json = {seqs: [{path, height, width, seq_length}],
    frames: [frame file names]}.  Returns the first frame plus
    (frame_num-1)/gop groups of gop frames concatenated on channels
    (reference video_dataset.py:33-105)."""

    def __init__(self, root, patch_h, patch_w, qp_num, lambdas,
                 frame_num=5, group_of_pictures=1, seed=0, raw_rgb=False,
                 cache=False):
        self.root = root
        with open(os.path.join(root, "description.json")) as f:
            desc = json.load(f)
        self.seqs = desc["seqs"]
        self.frames = desc["frames"]
        self.patch_h = patch_h
        self.patch_w = patch_w
        self.qp_num = qp_num
        self.lambdas = np.asarray(lambdas, np.float32)
        self.frame_num = frame_num
        self.gop = group_of_pictures
        self.rng = np.random.default_rng(seed)
        self.raw_rgb = raw_rgb
        # in-memory decoded-frame cache: PNG decode dominates step time
        # for long-rollout video training (frame_num x batch reads per
        # step); the reference instead pays this in its DataLoader
        # worker pool (video_dataset.py).  uint8 full frames, so a
        # 48x65-frame 384px corpus is ~1.4 GB.
        self._cache = {} if cache else None
        self._rng_lock = threading.Lock()

    def __len__(self):
        return len(self.seqs)

    def set_frame_num(self, frame_num):
        self.frame_num = frame_num

    def set_patch_size(self, patch_w, patch_h):
        self.patch_w, self.patch_h = patch_w, patch_h

    def _frame_indexes(self, seq_length):
        if self.frame_num < seq_length:
            start = int(self.rng.integers(0, seq_length - self.frame_num))
            return list(range(start, start + self.frame_num))
        # ping-pong padding for short sequences
        idx, i, inc = [], 0, True
        while len(idx) < self.frame_num:
            idx.append(i)
            if inc:
                if i == seq_length - 1:
                    i, inc = i - 1, False
                else:
                    i += 1
            else:
                if i == 0:
                    i, inc = 1, True
                else:
                    i -= 1
        return idx

    def __getitem__(self, index):
        seq = self.seqs[index]
        h, w = seq["height"], seq["width"]
        pad_h, pad_w = max(0, self.patch_h - h), max(0, self.patch_w - w)
        # all randomness drawn up front under a lock so BatchLoader's
        # worker threads can load/crop in parallel safely
        with self._rng_lock:
            idxs = self._frame_indexes(seq["seq_length"])
            flip = self.rng.random() < 0.5
            y = int(self.rng.integers(0, h + pad_h - self.patch_h + 1))
            x = int(self.rng.integers(0, w + pad_w - self.patch_w + 1))
            qp = int(self.rng.integers(0, self.qp_num))

        def load_frame(i):
            if self._cache is not None:
                key = (seq["path"], i)
                img = self._cache.get(key)
                if img is None:
                    img = load_rgb(os.path.join(
                        self.root, seq["path"], self.frames[i]))
                    self._cache[key] = img
                if flip:
                    img = img[:, ::-1]
            else:
                img = load_rgb(os.path.join(self.root, seq["path"],
                                            self.frames[i]))
                if flip:
                    img = img[:, ::-1]
            if pad_h or pad_w:
                img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                                   (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
                             mode="constant")
            img = img[y:y + self.patch_h, x:x + self.patch_w]
            return img if self.raw_rgb else _to_ycbcr_centered(img)

        frames = [load_frame(i) for i in idxs]
        # first frame alone (the intra seed), then GOP-of-gop groups
        # concatenated along channels
        data = [frames[0]]
        group = []
        for f in frames[1:]:
            group.append(f)
            if len(group) == self.gop:
                data.append(np.concatenate(group, axis=-1))
                group = []

        return {"frames": data, "qp": np.int32(qp),
                "lambda": np.float32(self.lambdas[qp])}


class BatchLoader:
    """Background-threaded batcher: stacks dataset samples into NHWC
    batches with prefetch, as CPU tensors (pin_memory: in page-locked
    memory)."""

    def __init__(self, dataset, batch_size, shuffle=True, prefetch=2, seed=0,
                 drop_last=True, repeats=1, workers=4, pin_memory=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        # passes over the data per epoch: each pass re-crops and
        # re-flips, so small corpora still yield fresh samples
        self.repeats = repeats
        self.workers = max(1, int(workers))   # sample-loading threads
        self.pin_memory = pin_memory

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n * self.repeats

    def __iter__(self):
        order = np.concatenate([
            self.rng.permutation(len(self.dataset)) if self.shuffle
            else np.arange(len(self.dataset))
            for _ in range(self.repeats)])
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                _produce()
            except Exception as e:  # handed to the consumer, raised there
                put(e)
            put(sentinel)

        def _produce():
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            batch = []
            with ThreadPoolExecutor(self.workers) as ex:
                # windowed submission: ~2 batches of samples in flight
                idx_iter = iter(order)
                futs = deque()

                def submit():
                    for i in idx_iter:
                        futs.append(ex.submit(self.dataset.__getitem__,
                                              int(i)))
                        return
                for _ in range(max(self.workers, self.batch_size) * 2):
                    submit()
                while futs and not stop.is_set():
                    batch.append(futs.popleft().result())
                    submit()
                    if len(batch) == self.batch_size:
                        put(self._tensors(self._collate(batch)))
                        batch = []
            if batch and not self.drop_last:
                put(self._tensors(self._collate(batch)))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _tensors(self, batch):
        """A collated numpy batch as CPU tensors (pinned if asked)."""
        def conv(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if self.pin_memory else t
        return {k: [conv(a) for a in v] if isinstance(v, list) else conv(v)
                for k, v in batch.items()}

    @staticmethod
    def _collate(samples):
        out = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], list):  # list of frame groups
                out[key] = [np.stack([v[i] for v in vals])
                            for i in range(len(vals[0]))]
            else:
                out[key] = np.stack(vals)
        return out
