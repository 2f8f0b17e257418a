"""Port parity, the data scripts: dcvc_tpu_torch.data.yuv_to_png against
test_data_to_png.py and dcvc_tpu_torch.data.make_synth against
scripts/make_synth_data.py (PIL writes the JAX scripts' PNGs here; the
port writes its own through utils/png.py): the same pixels, read back by
utils/png.py (exact, uint8), the same file names and description.json
files.  yuv_to_png's `_ycbcr2rgb_np` is a verbatim copy of the script's
(pinned by source); make_synth runs at --images 2 --seqs 1 --frames 3
--size 64.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import inspect
import json
import os
import sys

import numpy as np

from dcvc_tpu_torch.data import make_synth, yuv_to_png
from dcvc_tpu_torch.utils.png import load_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(path):
    spec = importlib.util.spec_from_file_location(
        "_jax_" + os.path.basename(path)[:-3], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_tree(a, b):
    """Equal file names under a and b, every PNG's pixels and every other
    file's bytes equal."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            same_tree(pa, pb)
        elif n.endswith(".png"):
            assert np.array_equal(load_rgb(pa), load_rgb(pb)), pa
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa


def test_ycbcr2rgb_copy_pinned():
    script = load_script("test_data_to_png.py")
    assert inspect.getsource(yuv_to_png._ycbcr2rgb_np) == \
        inspect.getsource(script._ycbcr2rgb_np)


def test_yuv_to_png_matches_the_jax_script(tmp_path):
    h, w, frames = 48, 80, 3
    src = tmp_path / "seq.yuv"
    rng = np.random.default_rng(0)
    src.write_bytes(rng.integers(0, 256, frames * h * w * 3 // 2,
                                 np.uint8).tobytes())
    script = load_script("test_data_to_png.py")
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(want)
    assert script.convert_one_seq_to_png(str(src), w, h, want) == frames
    assert yuv_to_png.main(["--src", str(src), "--width", str(w),
                            "--height", str(h), "--dst", got]) == frames
    same_tree(want, got)
    assert sorted(os.listdir(got)) == [f"im{i:05d}.png" for i in (1, 2, 3)]
    # --frames stops early
    assert yuv_to_png.main(["--src", str(src), "--width", str(w),
                            "--height", str(h), "--dst",
                            str(tmp_path / "two"), "--frames", "2"]) == 2


def test_make_synth_matches_the_jax_script(tmp_path, monkeypatch):
    flags = ["--images", "2", "--seqs", "1", "--frames", "3", "--size", "64"]
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    script = load_script(os.path.join("scripts", "make_synth_data.py"))
    monkeypatch.setattr(sys, "argv", ["make_synth_data.py", "--root", want]
                        + flags)
    script.main()
    make_synth.main(["--root", got] + flags)
    same_tree(want, got)
    with open(os.path.join(got, "videos", "description.json")) as f:
        desc = json.load(f)
    assert desc["frames"] == ["im1.png", "im2.png", "im3.png"]
    assert load_rgb(os.path.join(got, "images", "im0001.png")).shape == \
        (64, 64, 3)
