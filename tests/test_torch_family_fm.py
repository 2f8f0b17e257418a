"""The legacy-family evaluation of the port for DCVC-FM (eval/family.py,
eval/family_main.py `--model fm`, `--fast`) against dcvc_tpu's
(eval/family.py), at TINY_FM_CONFIG / TINY_INTRA_NOAR_CONFIG, float32 on
the CPU.

The two runners load the same dcvc_tpu.params.v1 files, which the port
writes (save_native): the P model is tests/test_torch_dcvc_fm.py's
lifted seeded DMCFM, the intra model perf_probe.lifted_legacy_intra's
IntraNoAR (init_scale 0.4, the encoder's last conv x 50, the hyper
encoder's x 400, the prior scale biases + 2), so that both code
symbols.  The JAX runner's _build calls its codecs' init_random (110 s
for FM at TINY); monkeypatch makes that return codecs around these
params, and the runner then loads the files as the port's does.

On a 6-frame 48x80 PNG sequence at gop 4 (I P P P I P: fa_idx 1, 0, 2
and 2 from INDEX_MAP_FM, the DPB reseeded by the second intra frame,
the frames padded to 64x96 inside the codecs) the port's FM NAL file is
byte-identical to the JAX runner's, and its numbers (bpp, frame types,
q index, the bit-exact flag) equal them, the PSNRs within PSNR_ATOL (as
tests/test_torch_family.py: each framework rounds its own float
reconstruction to 8 bits).  The CLI gives the same file and numbers.
The estimated-bits mode (`--fast`: frames edge-padded to 64x128, the P
frames' rates from the eval forward) gives the JAX runner's bpp within
1e-5 relative, the PSNRs within PSNR_ATOL, and the same frame types.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcvc_tpu.eval import family as jfamily
from dcvc_tpu.legacy import dcvc_fm as jfm
from dcvc_tpu.legacy import hem_intra as jhi
from dcvc_tpu.runtime import evc_codec as jevc
from dcvc_tpu.runtime import fm_codec as jfm_codec
from dcvc_tpu.utils.checkpoint import load_params
from dcvc_tpu_torch.eval import family, family_main
from dcvc_tpu_torch.legacy.hem_intra import IntraNoAR, \
    TINY_INTRA_NOAR_CONFIG
from dcvc_tpu_torch.perf_probe import lifted_legacy_intra
from dcvc_tpu_torch.utils.jax_bridge import save_native
from dcvc_tpu_torch.utils.png import write_png
from test_torch_dcvc_fm import lifted_model
from test_torch_family import PSNR_ATOL, _same_numbers

H, W, N, GOP = 48, 80, 6, 4
BIN = "cls_seq1_r0_q12.bin"


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    paths = (str(d / "fm_i.bin"), str(d / "fm_p.bin"))
    save_native(lifted_legacy_intra(IntraNoAR, TINY_INTRA_NOAR_CONFIG, 0),
                paths[0])
    save_native(lifted_model(), paths[1])
    return paths


@pytest.fixture(scope="module")
def png_seq(tmp_path_factory):
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp("seq")
    d = root / "cls" / "seq1"
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (H, W, 3)), 4.0)
    base = np.clip((base - 128) * 4 + 128, 0, 255)
    frames = []
    for i in range(N):
        img = np.clip(np.roll(base, i * 2, 1)
                      + rng.normal(0, 3, (H, W, 3)), 0, 255).astype(np.uint8)
        write_png(str(d / f"im{i + 1}.png"), img)
        frames.append(img.transpose(2, 0, 1))
    cfg = {"root_path": str(root), "test_classes": {"cls": {
        "test": 1, "base_path": "cls", "src_type": "png",
        "sequences": {"seq1": {"width": W, "height": H, "frames": N,
                               "intra_period": GOP}}}}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    return str(root / "cfg.json"), frames


@contextlib.contextmanager
def _jax_runner(model_files, out):
    """dcvc_tpu's FamilyRunner("fm", tiny) on model_files, its codecs'
    init_random replaced by codecs around the files' params."""
    params_i = jax.tree.map(jnp.asarray, load_params(model_files[0])[0])
    params_p = jax.tree.map(jnp.asarray, load_params(model_files[1])[0])

    def intra(cls, rng=None, cfg=None, dtype=jnp.float32, init_scale=1.0):
        return cls(jhi.IntraNoAR(cfg=cfg), params_i)

    def p_frame(cls, rng=None, cfg=None, dtype=jnp.float32, init_scale=1.0):
        return cls(jfm.DMCFM(cfg=cfg), params_p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jevc.IntraNoARCodec, "init_random", classmethod(intra))
        mp.setattr(jfm_codec.DMCFMCodec, "init_random",
                   classmethod(p_frame))
        yield jfamily.FamilyRunner("fm", str(out), rate_num=1, tiny=True,
                                   model_path_i=model_files[0],
                                   model_path_p=model_files[1])


@pytest.fixture(scope="module")
def jax_runner(model_files, tmp_path_factory):
    with _jax_runner(model_files, tmp_path_factory.mktemp("jax_bin")) as r:
        yield r


@pytest.fixture(scope="module")
def jax_run(jax_runner, png_seq):
    res = jax_runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    out = jax_runner.stream_dir
    return res, {f: open(os.path.join(out, f), "rb").read()
                 for f in os.listdir(out)}


def _port_runner(model_files, out):
    return family.FamilyRunner("fm", str(out), rate_num=1, tiny=True,
                               model_path_i=model_files[0],
                               model_path_p=model_files[1], device="cpu")


def test_runner_matches_jax(model_files, png_seq, jax_run, tmp_path):
    jres, jbins = jax_run
    runner = _port_runner(model_files, tmp_path)
    res = runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    bins = {f: (tmp_path / f).read_bytes() for f in os.listdir(tmp_path)}
    assert list(bins) == list(jbins) == [BIN]
    assert bins == jbins
    _same_numbers(res, jres)
    r = res["rate_0"]
    assert r["bitexact"] and r["frame_type"] == [0, 1, 1, 1, 0, 1]
    assert r["q_index"] == 12 and all(np.isfinite(r["frame_psnr"]))
    assert len(jbins[BIN]) > 500


def test_cli_matches_jax(model_files, png_seq, jax_run, tmp_path):
    jres, jbins = jax_run
    out = tmp_path / "out.json"
    code = family_main.main([
        "--model", "fm", "--test_config", png_seq[0], "--rate_num", "1",
        "--gop", str(GOP), "--tiny", "--stream_path", str(tmp_path / "bin"),
        "--output_path", str(out), "--model_path_i", model_files[0],
        "--model_path_p", model_files[1], "--device", "cpu"])
    assert code == 0
    data = json.loads(out.read_text())
    assert data["model"] == "fm"
    _same_numbers(data["results"]["cls"]["seq1"], jres)
    assert (tmp_path / "bin" / BIN).read_bytes() == jbins[BIN]


def _same_fast(got, want, psnr_atol=PSNR_ATOL):
    assert got["frame_type"] == want["frame_type"] == [0, 1, 1, 1, 0, 1]
    np.testing.assert_allclose(got["frame_bpp"], want["frame_bpp"],
                               rtol=1e-5, atol=0)
    for k in ("frame_psnr", "avg_psnr", "avg_psnr_i", "avg_psnr_p"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=psnr_atol,
                                   err_msg=k)
    np.testing.assert_allclose(got["avg_bpp"], want["avg_bpp"], rtol=1e-5)
    assert got["q_index"] == want["q_index"] and got["fast"]


@pytest.fixture(scope="module")
def jax_fast(jax_runner, png_seq):
    return jax_runner.run_sequence_fast(png_seq[1], 0, GOP)


def test_fast_matches_jax(model_files, png_seq, jax_fast, tmp_path):
    runner = _port_runner(model_files, tmp_path)
    got = runner.run_sequence_fast(png_seq[1], 0, GOP)
    _same_fast(got, jax_fast)
    # the P frames' estimated rates are coded ones' order of magnitude
    assert all(b > 0.01 for b in got["frame_bpp"])


def test_fast_cli_matches_jax(model_files, png_seq, jax_fast, tmp_path):
    out = tmp_path / "out.json"
    code = family_main.main([
        "--model", "fm", "--test_config", png_seq[0], "--rate_num", "1",
        "--gop", str(GOP), "--tiny", "--fast", "--stream_path",
        str(tmp_path / "bin"), "--output_path", str(out), "--model_path_i",
        model_files[0], "--model_path_p", model_files[1], "--device",
        "cpu"])
    assert code == 0
    got = json.loads(out.read_text())["results"]["cls"]["seq1"]["rate_0"]
    _same_fast(got, jax_fast)
    assert not os.listdir(tmp_path / "bin")


def test_q_index_of_each_rate():
    runner = family.FamilyRunner.__new__(family.FamilyRunner)
    runner.rate_num = 4
    assert [runner._q_index(r) for r in range(4)] == [12, 25, 38, 51]
