"""The port's training datasets (dcvc_tpu_torch/data/datasets.py) against
the JAX package's on synthetic folders this test writes (PNG files and
description.json, the layout ImageFolder / VideoFolder read): for the
same seed, the same crops, flips, pads, QPs and lambdas, sample for
sample and batch for batch; and the pins on the bodies the port copies.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect
import json
import os

import numpy as np
import pytest
import torch

from dcvc_tpu.data import datasets as jds
from dcvc_tpu_torch.data import datasets as tds
from dcvc_tpu_torch.utils.png import write_png

LAMBDAS = np.exp(np.linspace(np.log(8.0), np.log(256.0), 8))


def image_folder(root, sizes=((40, 52), (24, 30), (64, 64), (33, 71))):
    """PNG images of the given (h, w), one smaller than the patch."""
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"img_{i}.png"
        write_png(os.path.join(root, name),
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        names.append(name)
    with open(os.path.join(root, "description.json"), "w") as f:
        json.dump(names, f)
    return root


def video_folder(root, seqs=((4, 40, 48), (11, 36, 52), (6, 32, 32))):
    """Sequences of (frames, h, w) PNG frames im1.png ... ."""
    rng = np.random.default_rng(1)
    n_max = max(n for n, _, _ in seqs)
    frames = [f"im{i + 1}.png" for i in range(n_max)]
    desc = {"seqs": [], "frames": frames}
    for s, (n, h, w) in enumerate(seqs):
        path = f"seq_{s}"
        os.makedirs(os.path.join(root, path))
        for i in range(n):
            write_png(os.path.join(root, path, frames[i]),
                      rng.integers(0, 256, (h, w, 3), np.uint8))
        desc["seqs"].append({"path": path, "height": h, "width": w,
                             "seq_length": n})
    with open(os.path.join(root, "description.json"), "w") as f:
        json.dump(desc, f)
    return root


def same_sample(got, want):
    """Equal keys, and equal arrays (dtype, shape, bytes) under each; the
    port's batches hold tensors."""
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if not isinstance(w, list):
            g, w = [g], [w]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("raw_rgb", [True, False])
@pytest.mark.parametrize("patch", [(32, 32), (48, 40)])
def test_image_folder_matches_jax(tmp_path, raw_rgb, patch):
    root = image_folder(str(tmp_path))
    args = (root, patch[0], patch[1], 8, LAMBDAS)
    got = tds.ImageFolder(*args, seed=3, raw_rgb=raw_rgb)
    want = jds.ImageFolder(*args, seed=3, raw_rgb=raw_rgb)
    for _ in range(3):
        for i in range(len(want)):
            same_sample(got[i], want[i])


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("gop,frame_num", [(1, 3), (2, 5), (8, 9)])
def test_video_folder_matches_jax(tmp_path, gop, frame_num, cache):
    """frame_num below and above the sequence lengths (ping-pong)."""
    root = video_folder(str(tmp_path))
    args = (root, 32, 32, 8, LAMBDAS)
    kw = {"frame_num": frame_num, "group_of_pictures": gop, "seed": 5,
          "raw_rgb": True, "cache": cache}
    got, want = tds.VideoFolder(*args, **kw), jds.VideoFolder(*args, **kw)
    for _ in range(3):
        for i in range(len(want)):
            same_sample(got[i], want[i])
    assert len(want[0]["frames"]) == 1 + (frame_num - 1) // gop


@pytest.mark.parametrize("kind", ["image", "video"])
def test_batch_loader_matches_jax(tmp_path, kind):
    """One worker (the samples' draws then come in index order in both),
    batches of 2, two passes, the last short batch kept."""
    if kind == "image":
        root = image_folder(str(tmp_path))
        make = lambda m: m.ImageFolder(root, 32, 32, 8, LAMBDAS, seed=2,
                                       raw_rgb=True)
    else:
        root = video_folder(str(tmp_path))
        make = lambda m: m.VideoFolder(root, 32, 32, 8, LAMBDAS, frame_num=5,
                                       group_of_pictures=2, seed=2,
                                       raw_rgb=True)
    kw = {"seed": 7, "repeats": 2, "workers": 1, "drop_last": False}
    got = list(tds.BatchLoader(make(tds), 2, **kw))
    want = list(jds.BatchLoader(make(jds), 2, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        same_sample(g, w)
        for v in g.values():
            for t in (v if isinstance(v, list) else [v]):
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


def test_batch_loader_raises_a_failed_sample(tmp_path):
    """A file that cannot be read raises in the consumer (the JAX loader
    ends the epoch there instead)."""
    root = image_folder(str(tmp_path))
    os.remove(os.path.join(root, "img_2.png"))
    loader = tds.BatchLoader(tds.ImageFolder(root, 16, 16, 8, LAMBDAS),
                             2, shuffle=False, workers=2)
    with pytest.raises(FileNotFoundError):
        list(loader)


@pytest.mark.parametrize("copy,original", [
    (tds._to_ycbcr_centered, jds._to_ycbcr_centered),
    (tds.VideoFolder._frame_indexes, jds.VideoFolder._frame_indexes),
    (tds.ImageFolder.__len__, jds.ImageFolder.__len__),
    (tds.ImageFolder.set_patch_size, jds.ImageFolder.set_patch_size),
    (tds.VideoFolder.__len__, jds.VideoFolder.__len__),
    (tds.VideoFolder.set_frame_num, jds.VideoFolder.set_frame_num),
    (tds.VideoFolder.set_patch_size, jds.VideoFolder.set_patch_size),
    (tds.BatchLoader.__len__, jds.BatchLoader.__len__),
    (tds.BatchLoader._collate, jds.BatchLoader._collate),
])
def test_copied_bodies_source_equal(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)
