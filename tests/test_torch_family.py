"""The legacy-family evaluation of the port (eval/family.py,
eval/family_main.py) against dcvc_tpu's (eval/family.py,
test_video_family.py), DCVC-RT at its TINY configs, float32 on the CPU.

The two runners load the same weights: dcvc_tpu.params.v1 files that the
JAX package writes (its seeded TINY codecs, kernels damped by 0.7 and the
scale parts of the prior outputs' biases lifted by 2, so that y symbols
are coded), which the JAX runner reads with its own loader and the port's
with utils/jax_bridge.py.  On a 5-frame 64x64 PNG sequence at gop 4 (I P
P P I: the DPB reseeded by the second intra frame, the P frames on the
shifted banks of INDEX_MAP) the port's stream file is byte-identical to
the JAX runner's, and its result numbers (bpp, frame types, q index, the
bit-exact flag) equal them, the PSNRs per frame and their averages within
1e-5 dB (each framework rounds its own float reconstruction to 8 bits, and
the two agree within the 1e-4 frame tolerance, so a few pixels may round
apart); the times are not compared.  The CLI gives the same stream file and numbers, and
its YUV420 reader the JAX CLI's RGB frames.  Models the port does not run
yet raise, and so does --fast for rt, as the JAX runner does (DCVC-FM's
runner and its --fast mode: tests/test_torch_family_fm.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcvc_tpu.eval import family as jfamily
from dcvc_tpu.legacy.dcvc_rt import DMCRTCodec as JaxP
from dcvc_tpu.legacy.dcvc_rt import TINY_RT_CONFIG as JAX_P_TINY
from dcvc_tpu.legacy.rt_intra import TINY_RT_INTRA_CONFIG as JAX_I_TINY
from dcvc_tpu.runtime.rt_image_codec import RTIntraCodec as JaxI
from dcvc_tpu.utils.checkpoint import save_params
from dcvc_tpu_torch.eval import family, family_main
from dcvc_tpu_torch.utils.png import write_png

# the two frameworks' reconstructions agree within the 1e-4 frame
# tolerance, so a pixel may round to the next 8-bit level in one and not
# the other: ~1.4e-6 dB each at these 64x64 frames' PSNRs
PSNR_ATOL = 1e-5
NUMBERS = ("frame_bpp", "frame_psnr", "frame_type", "bitexact", "avg_bpp",
           "avg_psnr", "avg_psnr_i", "avg_psnr_p", "q_index")


def _damped(params, cy, fusion, fusion_scales, spatial):
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.array(leaf) * (0.7 if p[-1].key == "kernel"
                                          else 1.0), params)
    params["y_prior_fusion"][fusion]["conv"]["bias"][fusion_scales] += 2.0
    params["y_spatial_prior"][spatial]["conv"]["bias"][:cy] += 2.0
    return params


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    i = JaxI.init_random(jax.random.PRNGKey(0), cfg=JAX_I_TINY,
                         dtype=jnp.float32)
    p = JaxP.init_random(jax.random.PRNGKey(1), cfg=JAX_P_TINY,
                         dtype=jnp.float32)
    cy_i, cy_p = JAX_I_TINY.ch_y, JAX_P_TINY.ch_y
    paths = (str(d / "rt_i.bin"), str(d / "rt_p.bin"))
    save_params(paths[0], _damped(i.params, cy_i, "conv_3",
                                  slice(2, 2 + cy_i), "conv_3"), JAX_I_TINY)
    save_params(paths[1], _damped(p.params, cy_p, "layers_3",
                                  slice(cy_p, 2 * cy_p), "layers_2"),
                JAX_P_TINY)
    return paths


@pytest.fixture(scope="module")
def png_seq(tmp_path_factory):
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp("seq")
    d = root / "cls" / "seq1"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = gaussian_filter(rng.uniform(0, 255, (64, 64, 3)), 4.0)
    frames = []
    for i in range(5):
        img = np.clip(np.roll(base, i * 2, 1)
                      + rng.normal(0, 3, (64, 64, 3)), 0, 255).astype(
            np.uint8)
        write_png(str(d / f"im{i + 1}.png"), img)
        frames.append(img.transpose(2, 0, 1))
    cfg = {"root_path": str(root), "test_classes": {"cls": {
        "test": 1, "base_path": "cls", "src_type": "png",
        "sequences": {"seq1": {"width": 64, "height": 64, "frames": 5,
                               "intra_period": 4}}}}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    return str(root / "cfg.json"), frames


@pytest.fixture(scope="module")
def jax_run(model_files, png_seq, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bin")
    runner = jfamily.FamilyRunner("rt", str(out), rate_num=1, tiny=True,
                                  model_path_i=model_files[0],
                                  model_path_p=model_files[1])
    res = runner.run(png_seq[1], [0], 4, seq_name="cls_seq1")
    return res, {f: (out / f).read_bytes() for f in os.listdir(out)}


def _same_numbers(got, want, psnr_atol=PSNR_ATOL):
    """Every number of the results equal, the PSNRs within psnr_atol:
    each framework rounds its own float reconstruction to 8 bits."""
    assert set(got) == set(want)
    for r in want:
        for k in NUMBERS:
            if "psnr" in k:
                np.testing.assert_allclose(got[r][k], want[r][k], rtol=0,
                                           atol=psnr_atol, err_msg=k)
            else:
                assert got[r][k] == want[r][k], k


def test_interpolate_log_matches_jax():
    for args in ((0.3, 3.0), (0.5, 2.0), (0.5, 2.0, 16, False)):
        np.testing.assert_array_equal(family.interpolate_log(*args),
                                      jfamily.interpolate_log(*args))


def test_runner_matches_jax(model_files, png_seq, jax_run, tmp_path):
    jres, jbins = jax_run
    runner = family.FamilyRunner("rt", str(tmp_path), rate_num=1, tiny=True,
                                 model_path_i=model_files[0],
                                 model_path_p=model_files[1], device="cpu")
    assert runner.i_codec.force_ec is None
    res = runner.run(png_seq[1], [0], 4, seq_name="cls_seq1")
    bins = {f: (tmp_path / f).read_bytes() for f in os.listdir(tmp_path)}
    assert list(bins) == list(jbins) == ["cls_seq1_r0_rt_q1.bin"]
    assert bins == jbins
    _same_numbers(res, jres)
    r = res["rate_0"]
    assert r["bitexact"] and r["frame_type"] == [0, 1, 1, 1, 0]
    assert all(np.isfinite(p) for p in r["frame_psnr"])
    # one lane below 1280x720, pinned for the sequence
    assert runner.i_codec.force_ec == runner.p_codec.force_ec == 1
    assert len(jbins["cls_seq1_r0_rt_q1.bin"]) > 200


def test_cli_matches_jax(model_files, png_seq, jax_run, tmp_path):
    jres, jbins = jax_run
    out = tmp_path / "out.json"
    code = family_main.main([
        "--model", "rt", "--test_config", png_seq[0], "--rate_num", "1",
        "--gop", "4", "--tiny", "--stream_path", str(tmp_path / "bin"),
        "--output_path", str(out), "--model_path_i", model_files[0],
        "--model_path_p", model_files[1], "--device", "cpu"])
    assert code == 0
    data = json.loads(out.read_text())
    assert data["model"] == "rt"
    _same_numbers(data["results"]["cls"]["seq1"], jres)
    assert (tmp_path / "bin" / "cls_seq1_r0_rt_q1.bin").read_bytes() == \
        jbins["cls_seq1_r0_rt_q1.bin"]


def test_yuv_reader_matches_jax_cli(tmp_path):
    import test_video_family
    rng = np.random.default_rng(3)
    w, h, n = 48, 32, 2
    raw = rng.integers(0, 256, n * w * h * 3 // 2, dtype=np.uint8)
    path = tmp_path / "seq.yuv"
    path.write_bytes(raw.tobytes())
    got = family_main.read_sequence_rgb(str(path), "yuv420", w, h, 3)
    want = test_video_family.read_sequence_rgb(str(path), "yuv420", w, h, 3)
    assert len(got) == len(want) == n
    for g, wt in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (3, h, w)
        np.testing.assert_array_equal(g, wt)


@pytest.mark.parametrize("model", ["dc", "hem", "tcm", "dcvc"])
def test_models_not_ported_raise(model, tmp_path):
    """HEM, DC, DCVC and TCM, once on this list, build their codecs; a
    model still in NOT_PORTED (none now) raises."""
    if model in family.NOT_PORTED:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            family.FamilyRunner(model, str(tmp_path), tiny=True,
                                device="cpu")
        return
    runner = family.FamilyRunner(model, str(tmp_path), tiny=True,
                                 device="cpu")
    assert type(runner.p_codec) is family.P_CODECS[model][0]


def test_fast_mode_raises(png_seq, tmp_path):
    with pytest.raises(ValueError, match="--fast"):
        family_main.main(["--model", "rt", "--test_config", png_seq[0],
                          "--fast", "--tiny", "--device", "cpu",
                          "--stream_path", str(tmp_path)])
