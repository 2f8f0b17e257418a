"""Port parity, the rest of the evaluation surface, on the CPU in float32
at the TINY configs:

- Workers: video_main.main with --worker 2 (a spawn pool, each worker
  with its own codecs) writes the same .bin files and the same JSON
  numbers (time fields aside) as --worker 1, as tests/test_harness.py
  holds the JAX CLI.
- Checkpoints in the CLI: the random codecs' models written as
  dcvc_tpu.params.v1 files and passed as --model_path_i / --model_path_p
  without --tiny_model (the headers' TINY configs win) give the random
  run's .bin files.
- Image CLI: image_main.main and the JAX package's test_image.main on
  the same params.v1 file (float32, skip 0) and two seeded PNGs (64x96
  and the odd 69x91) write byte-identical .bin files with equal bpp,
  PSNRs within 1e-6 and every image bit-exact; --device_ec (K2's plain
  version here) gives the same JSON numbers.  A CompressAI
  --i_frame_model (not ported yet) and --device cuda without a card
  raise.
- Symbols: DMCICodec.collect_symbols of the port's encode, host decode
  and device_ec decode equal the JAX codec's, array for array (values
  and dtypes), skip 0.15; with collect_symbols None nothing is kept.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY_I
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxDMCI
from dcvc_tpu_torch.eval import image_main, video_main
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_to_jax, save_native
from dcvc_tpu_torch.utils.png import write_png
from test_torch_eval import _config, _write_yuv

QP = 3


def _argv(cfg, out, *extra):
    return ["--test_config", cfg, "--output_path", str(out / "result.json"),
            "--stream_path", str(out / "bin"), "--rate_num", "2",
            "--qp_i", "1", "5", "--qp_p", "1", "5", "--device", "cpu",
            *extra]


def _run(cfg, out, *extra):
    """(result JSON as written, {name: .bin bytes}) of one CLI run."""
    video_main.main(_argv(cfg, out, *extra))
    with open(out / "result.json") as f:
        result = json.load(f)
    folder = out / "bin" / "TestClass"
    bins = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(".bin"):
            with open(folder / name, "rb") as f:
                bins[name] = f.read()
    return result, bins


def _untimed(result):
    return {ds: {seq: {rate: {k: v for k, v in point.items()
                              if "time" not in k}
                       for rate, point in rates.items()}
                 for seq, rates in seqs.items()}
            for ds, seqs in result.items()}


@pytest.fixture(scope="module")
def yuv(tmp_path_factory):
    root = tmp_path_factory.mktemp("yuv")
    _write_yuv(str(root / "data" / "TestClass"))
    return _config(root / "data", root)


def test_worker_pool_matches_serial(yuv, tmp_path):
    serial, serial_bins = _run(yuv, tmp_path / "w1", "--tiny_model", "1",
                               "--worker", "1")
    pool, pool_bins = _run(yuv, tmp_path / "w2", "--tiny_model", "1",
                           "--worker", "2")
    assert len(serial_bins) == 2 and all(len(b) > 100
                                         for b in serial_bins.values())
    assert pool_bins == serial_bins
    assert _untimed(pool) == _untimed(serial)


def test_cli_takes_params_v1_files(yuv, tmp_path):
    args = video_main.parse_args(_argv(yuv, tmp_path, "--tiny_model", "1"))
    i_codec, p_codec, _ = video_main.build_codecs(args)
    save_native(i_codec.model, str(tmp_path / "i.bin"))
    save_native(p_codec.model, str(tmp_path / "p.bin"))
    _, want = _run(yuv, tmp_path / "random", "--tiny_model", "1")
    _, got = _run(yuv, tmp_path / "files",
                  "--model_path_i", str(tmp_path / "i.bin"),
                  "--model_path_p", str(tmp_path / "p.bin"))
    assert got == want


# ------------------------------------------------------------- image CLI

@pytest.fixture(scope="module")
def image_inputs(tmp_path_factory):
    """Two seeded PNGs (one of odd size) and a params.v1 file of the
    port's seeded TINY DMCI."""
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp("images")
    os.makedirs(root / "png")
    rng = np.random.default_rng(5)
    for name, (h, w) in (("a.png", (64, 96)), ("b.png", (69, 91))):
        img = gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (2, 2, 0))
        write_png(str(root / "png" / name), np.clip(img, 0, 255).astype(
            np.uint8))
    model = DMCI(TINY_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(3))
    save_native(model, str(root / "dmci.bin"))
    return root


def _image_run(main, root, out, *extra):
    argv = ["--image_path", str(root / "png"), "--model_path",
            str(root / "dmci.bin"), "--qp", str(QP), "--stream_path",
            str(out), "--output_path", str(out) + ".json", *extra]
    rc = main(argv)
    with open(str(out) + ".json") as f:
        result = json.load(f)
    bins = {}
    for name in sorted(os.listdir(out)):
        with open(out / name, "rb") as f:
            bins[name] = f.read()
    return rc, result, bins


def _jax_test_image(argv):
    import test_image
    old = sys.argv
    sys.argv = ["test_image.py"] + argv
    try:
        return test_image.main()
    finally:
        sys.argv = old


def test_image_cli_matches_jax(image_inputs, tmp_path):
    rc, got, got_bins = _image_run(image_main.main, image_inputs,
                                   tmp_path / "port", "--device", "cpu")
    jrc, want, want_bins = _image_run(_jax_test_image, image_inputs,
                                      tmp_path / "jax")
    assert rc == jrc == 0
    assert sorted(got_bins) == ["a.bin", "b.bin"]
    assert got_bins == want_bins
    assert got["model"] == want["model"] == "dmci"
    for name, w in want["per_image"].items():
        g = got["per_image"][name]
        assert g["bpp"] == w["bpp"] and g["bitexact"] and w["bitexact"]
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0, atol=1e-6)
    assert got["summary"]["avg_bpp"] == want["summary"]["avg_bpp"]
    assert got["summary"]["images"] == 2

    rc, dev, dev_bins = _image_run(image_main.main, image_inputs,
                                   tmp_path / "dev", "--device", "cpu",
                                   "--device_ec", "1")
    assert rc == 0 and dev_bins == got_bins
    for name, g in got["per_image"].items():
        d = dev["per_image"][name]
        assert (d["bpp"], d["psnr"], d["bitexact"]) == \
            (g["bpp"], g["psnr"], True)


def test_image_cli_refuses_legacy_models_and_a_missing_card(image_inputs,
                                                            tmp_path):
    base = ["--image_path", str(image_inputs / "png"), "--stream_path",
            str(tmp_path / "bin"), "--output_path", str(tmp_path / "o.json"),
            "--tiny"]
    with pytest.raises(ValueError, match="device entropy decode"):
        image_main.main(base + ["--i_frame_model", "cheng2020", "--device",
                                "cpu", "--device_ec", "1"])
    if not torch.cuda.is_available():
        assert image_main.parse_args(base).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            image_main.main(base)
    assert not os.path.exists(tmp_path / "o.json")


# --------------------------------------------------------------- symbols

def _capture(codec, x, device_ec_attr):
    """collect_symbols of an encode, a host decode and a device_ec
    decode of x."""
    codec.collect_symbols = []
    res = codec.compress(x, QP)
    h, w = x.shape[1:3]
    codec.decompress(res["bit_stream"], QP, h, w, res["ec_parallel"])
    setattr(codec, device_ec_attr, True)
    codec.decompress(res["bit_stream"], QP, h, w, res["ec_parallel"])
    setattr(codec, device_ec_attr, False)
    return codec.collect_symbols


def test_collect_symbols_match_jax():
    model = DMCI(TINY_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(3))
    tree = jax.tree.map(lambda t: t.numpy(),
                        dmci_params_to_jax(model.state_dict()))
    port = DMCICodec(model.state_dict(), cfg=TINY_CONFIG, skip_thres=0.15,
                     dtype=torch.float32, device="cpu")
    ref = JaxDMCI(tree, cfg=JAX_TINY_I, skip_thres=0.15, dtype=jnp.float32)
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (1, 64, 96, 3)).astype(
        np.float32)
    got = _capture(port, x, "device_ec")
    want = _capture(ref, x, "device_ec")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["z"].dtype == w["z"].dtype
        np.testing.assert_array_equal(g["z"], w["z"])
        assert len(g["y"]) == len(g["idx"]) == 4
        for part in ("y", "idx"):
            for a, b in zip(g[part], w[part]):
                assert a.dtype == np.asarray(b).dtype, part
                np.testing.assert_array_equal(a, np.asarray(b))
    assert sum(len(y) for y in got[0]["y"]) > 0
    # the encoder's symbols are the decoders'
    for dec in got[1:]:
        for part in ("y", "idx"):
            for a, b in zip(dec[part], got[0][part]):
                np.testing.assert_array_equal(a, b)

    port.collect_symbols = None
    port.compress(x, QP)
    assert port.collect_symbols is None
