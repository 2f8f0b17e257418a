"""The port's per-variant benchmark, dcvc_tpu_torch/eval/bench_variants.py,
against the JAX repo's scripts/bench_variants.py, on the CPU at TINY
configs in float32.

- make_frames gives the arrays of the script's make_frames.
- DMCI's 0.65 damping, done through the weight bridge, equals the
  script's tree_map_with_path lambda (:143-145) applied to the bridged
  TINY DMCI params, exactly.
- The zero-symbol decode chains: the DMCI chain and the HTS chain give
  the JAX chains' reconstructions (the script's device_decode_ms_image /
  device_decode_ms_video, their last reconstruction taken from the
  script's sync1) within atol = rtol = 2e-5 (tests/test_fused_dcb.py:57),
  on bridged weights, the video chain from the same DPB; the codec's DPB
  is left as it was.
- bench_dmci / bench_ht at TINY print the script's JSON fields, with its
  `_devec` / `_trained` tags and baselines; collect_envelope gives the
  JAX collect_envelope.py's records on the same log (its default note
  names the card instead of the TPU chip), run_envelope writes
  run_envelope.sh's markers.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY_HT
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxImageCodec
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxVideoCodec
from dcvc_tpu_torch.eval import bench_variants as bv
from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG, TINY_HTL_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax, \
    dmci_params_from_jax, dmci_params_to_jax, save_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
FIELDS = ["metric", "value", "unit", "vs_baseline", "enc_fps", "dec_fps",
          "dec_device_fps", "bpp"]


def _script(name):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bv():
    return _script("bench_variants.py")


@pytest.mark.parametrize("h,w,n,seed", [(24, 40, 3, 0), (9, 17, 1, 5)])
def test_make_frames_is_the_scripts(jax_bv, h, w, n, seed):
    got = bv.make_frames(h, w, n, np.random.default_rng(seed))
    want = jax_bv.make_frames(h, w, n, np.random.default_rng(seed))
    assert len(got) == len(want) == n
    for g, x in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, x)


def test_dmci_frames_lead_the_ht_frames():
    """bench_dmci's 8 images are the first 8 of bench_ht's 48 frames (one
    seeded picture, then each frame's noise in turn), so the smoke makes
    one set per size for both."""
    short = bv.make_frames(16, 24, 8, np.random.default_rng(0))
    long = bv.make_frames(16, 24, 48, np.random.default_rng(0))
    for a, b in zip(short, long):
        np.testing.assert_array_equal(a, b)


def test_constants_are_the_scripts(jax_bv):
    assert bv.RESOLUTIONS == jax_bv.RESOLUTIONS
    with open(os.path.join(REPO, "scripts", "bench_variants.py")) as f:
        src = f.read()
    assert "base = 1.0 / (1.0 / 81.5 + 1.0 / 95.0)" in src
    assert "base = 1.0 / (1.0 / 125.2 + 1.0 / 112.8)" in src
    assert bv.UF_INTRA_A100_FPS == 1.0 / (1.0 / 81.5 + 1.0 / 95.0)
    assert bv.RT_A100_FPS == 1.0 / (1.0 / 125.2 + 1.0 / 112.8)
    assert "l * 0.65" in src and bv.DMCI_DAMPING == 0.65
    with open(os.path.join(REPO, "scripts", "run_envelope.sh")) as f:
        sh = f.read()
    assert f"for RES in {' '.join(bv.ENVELOPE)}; do" in sh
    assert f"timeout {bv.ENVELOPE_TIMEOUT} " in sh


def test_damping_is_the_scripts_lambda():
    model = DMCI(TINY_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(3))
    state = model.state_dict()
    got = bv.damp_kernels(state)
    tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        dmci_params_to_jax(state))
    # scripts/bench_variants.py:143-145
    damped = jax.tree_util.tree_map_with_path(
        lambda p, l: np.asarray(l * 0.65) if p[-1].key == "kernel" else l,
        tree)
    want = dmci_params_from_jax(damped)
    assert list(got) == list(want)
    changed = 0
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], state[k])
    assert 0 < changed < len(want)        # kernels only: biases etc. stay


@pytest.fixture(scope="module")
def image_codecs():
    jcodec = JaxImageCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                       dtype=jnp.float32, skip_thres=0.15)
    tcodec = DMCICodec(dmci_params_from_jax(jcodec.params), cfg=TINY_CONFIG,
                       dtype=torch.float32, device="cpu", skip_thres=0.15)
    return jcodec, tcodec


def _jax_chain(jax_bv, monkeypatch, fn, *args):
    """The script's chain timer fn(*args); returns the reconstruction it
    synchronises on last."""
    seen = []
    monkeypatch.setattr(jax_bv, "sync1", lambda a: seen.append(a))
    fn(*args)
    return np.asarray(seen[-1])


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_image_chain_is_the_scripts(jax_bv, image_codecs, monkeypatch, h,
                                    w):
    jcodec, tcodec = image_codecs
    want = _jax_chain(jax_bv, monkeypatch, jax_bv.device_decode_ms_image,
                      jcodec, jnp, h, w, None, 1)
    ms, got = bv.device_decode_image(tcodec, h, w, iters=1)
    assert ms > 0 and got.shape == (1, h, w, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def video_codecs():
    init = JaxVideoCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY_HT,
                                     dtype=jnp.float32, skip_thres=0.15,
                                     init_scale=0.5)
    tcodec = DMCHTCodec(dmc_ht_params_from_jax(init.params),
                        cfg=TINY_HT_CONFIG, dtype=torch.float32,
                        device="cpu", skip_thres=0.15)
    return init, tcodec


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_video_chain_is_the_scripts(jax_bv, video_codecs, monkeypatch, h,
                                    w):
    jcodec, tcodec = video_codecs
    frames = bv.make_frames(h, w, 9, np.random.default_rng(1))
    jcodec.clear_dpb()
    jcodec.add_ref_feature_from_frame(frames[0][None])
    jcodec.compress(np.concatenate([f[None] for f in frames[1:]], -1), 7)
    tcodec.ref_feature = torch.from_numpy(np.array(jcodec.ref_feature))
    tcodec.memory = torch.from_numpy(np.array(jcodec.memory))
    dpb = tcodec.ref_feature.clone(), tcodec.memory.clone()
    want = _jax_chain(jax_bv, monkeypatch, jax_bv.device_decode_ms_video,
                      jcodec, jnp, h, w, None, 1)
    ms, got = bv.device_decode_video(tcodec, h, w, iters=1)
    assert ms > 0 and got.shape == (8, h, w, 3)
    # the JAX recon's frames, as tests/test_torch_video_codec.py reads them
    want = want.reshape(8, h, w, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(tcodec.ref_feature, dpb[0])
    assert torch.equal(tcodec.memory, dpb[1])


def test_video_chain_needs_a_decoded_dpb(video_codecs):
    _, tcodec = video_codecs
    tcodec.clear_dpb()
    with pytest.raises(ValueError, match="real decode"):
        bv.device_decode_video(tcodec, 64, 64)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("device_ec", [False, True])
def test_bench_dmci_fields(capsys, device_ec):
    rec = bv.bench_dmci(32, 48, "1080p", device_ec=device_ec, device="cpu",
                        cfg=TINY_CONFIG, n=3)
    assert _last_json(capsys) == rec and list(rec) == FIELDS
    tag = "_devec" if device_ec else ""
    assert rec["metric"] == f"dmci{tag}_1080p_encdec_fps"
    assert rec["value"] > 0 and rec["dec_device_fps"] > 0
    assert rec["bpp"] > 0
    assert (rec["vs_baseline"] is None) == device_ec
    if not device_ec:
        assert rec["vs_baseline"] == round(
            rec["value"] / bv.UF_INTRA_A100_FPS, 4)


def test_bench_dmci_trained(capsys, tmp_path):
    model = DMCI(TINY_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(4))
    path = str(tmp_path / "dmci.bin")
    save_native(model, path)
    rec = bv.bench_dmci(32, 32, "240p", model_path=path, device="cpu", n=2)
    assert list(rec) == FIELDS and rec["value"] > 0
    assert rec["metric"] == "dmci_trained_240p_encdec_fps"
    assert rec["vs_baseline"] is None


@pytest.mark.parametrize("variant,cfg,device_ec", [
    ("hts", TINY_HT_CONFIG, False), ("htl", TINY_HTL_CONFIG, True)])
def test_bench_ht_fields(capsys, variant, cfg, device_ec):
    rec = bv.bench_ht(32, 48, variant, "480p", device_ec=device_ec,
                      device="cpu", cfg=cfg, n_chunks=2)
    assert _last_json(capsys) == rec and list(rec) == FIELDS
    tag = "_devec" if device_ec else ""
    assert rec["metric"] == f"dmc_{variant}{tag}_480p_encdec_fps"
    assert rec["value"] > 0 and rec["dec_device_fps"] > 0
    assert rec["vs_baseline"] is None


def test_bench_ht_mismatch(capsys, monkeypatch):
    real = DMCHTCodec.decompress_sequence

    def perturbed(self, *args, **kwargs):
        outs = real(self, *args, **kwargs)
        self.ref_feature = self.ref_feature * 2.0 + 1.0
        return outs
    monkeypatch.setattr(DMCHTCodec, "decompress_sequence", perturbed)
    rec = bv.bench_ht(32, 32, "hts", device="cpu", cfg=TINY_HT_CONFIG,
                      n_chunks=1)
    assert _last_json(capsys) == rec == {
        "metric": "dmc_hts_1080p_encdec_fps", "value": 0.0, "unit": "fps",
        "error": "round-trip mismatch"}


LOG = """=== RES 1080p ===
# dmci iter 0: 8f enc 120 ms dec 130 ms
{"metric": "dmci_1080p_encdec_fps", "value": 30.1, "unit": "fps", "bpp": 1}
--- done dmci 1080p rc=0 ---
{"metric": "dmc_hts_1080p_encdec_fps", "value": 200.5, "unit": "fps"}
{not json
{"metric": "dmci_1080p_encdec_fps", "value": 31.7, "unit": "fps", "bpp": 2}
{"value": 1}
=== ENVELOPE COMPLETE ===
"""


@pytest.mark.parametrize("note", [None, "my note"])
def test_collect_envelope_is_the_scripts(tmp_path, monkeypatch, note):
    log = tmp_path / "env.log"
    log.write_text(LOG)
    jax_out, out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_ce = _script("collect_envelope.py")
    argv = ["collect_envelope.py", str(log), jax_out]
    monkeypatch.setattr(sys, "argv", argv + (["--note", note] if note
                                             else []))
    jax_ce.main()
    art = bv.collect_envelope(str(log), out, note)
    with open(jax_out) as f:
        want = json.load(f)
    with open(out) as f:
        assert json.load(f) == art
    assert art["results"] == want["results"]
    assert art["results"]["dmci_1080p_encdec_fps"]["value"] == 31.7
    if note:
        assert art == want
    else:
        # the one deliberate difference: the note names the card
        assert "v5e" in want["note"] and "v5e" not in art["note"]
        assert art["note"].startswith("per-variant speed on ")


def test_run_envelope_writes_the_scripts_markers(tmp_path, monkeypatch):
    calls = []

    def fake_run(cmd, stdout, stderr, env, timeout):
        calls.append(cmd)
        v, res = cmd[3], cmd[5]
        if (v, res) == ("hts", "240p"):
            raise subprocess.TimeoutExpired(cmd, timeout)
        stdout.write(json.dumps({"metric": f"{v}_{res}"}) + "\n")
        stdout.flush()
        return subprocess.CompletedProcess(cmd, 0)
    monkeypatch.setattr(bv.subprocess, "run", fake_run)
    log = str(tmp_path / "env.log")
    rcs = bv.run_envelope(log, resolutions=("1080p", "240p"),
                          variants=("dmci", "hts"),
                          extra=("--device", "cpu"))
    assert rcs == {("dmci", "1080p"): 0, ("hts", "1080p"): 0,
                   ("dmci", "240p"): 0, ("hts", "240p"): 124}
    assert calls[0] == [sys.executable, "-m", bv.MODULE, "dmci", "--res",
                        "1080p", "--device", "cpu"]
    with open(log) as f:
        lines = f.read().splitlines()
    assert lines == [
        "=== RES 1080p ===", '{"metric": "dmci_1080p"}',
        "--- done dmci 1080p rc=0 ---", '{"metric": "hts_1080p"}',
        "--- done hts 1080p rc=0 ---", "=== RES 240p ===",
        '{"metric": "dmci_240p"}', "--- done dmci 240p rc=0 ---",
        "--- done hts 240p rc=124 ---", "=== ENVELOPE COMPLETE ==="]


def test_cli(monkeypatch, tmp_path):
    with pytest.raises(SystemExit):
        bv.main(["dmci", "hevc"])
    log = tmp_path / "env.log"
    log.write_text(LOG)
    out = str(tmp_path / "art.json")
    assert bv.main(["--collect", str(log), out, "--note", "n"]) == 0
    with open(out) as f:
        assert json.load(f)["note"] == "n"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bv.main(["dmci"])


@pytest.fixture(scope="module")
def envelope_launches():
    """perf_probe.uf_call_launches of each variant at each resolution of
    the envelope."""
    from dcvc_tpu_torch.models.dmc_ht import HTL_CONFIG, HTS_CONFIG
    from dcvc_tpu_torch.models.dmci import DMCIConfig
    from dcvc_tpu_torch.perf_probe import uf_call_launches
    cfgs = {"dmci": DMCIConfig(), "hts": HTS_CONFIG, "htl": HTL_CONFIG}
    return {(v, res): uf_call_launches(v, cfgs[v], *bv.RESOLUTIONS[res])
            for v in bv.VARIANTS for res in bv.ENVELOPE}


def test_envelope_launch_counts_are_the_smokes(envelope_launches):
    """K1 launches per call do not depend on the size: at every size of
    the envelope they are the counts chip_smoke.py asserts at 1080p."""
    sys.path.insert(0, REPO)
    import chip_smoke
    for (v, res), got in envelope_launches.items():
        if v == "dmci":
            want = {"encode": chip_smoke.ENCODE_LAUNCHES,
                    "decode": chip_smoke.DECODE_LAUNCHES}
        else:
            spec = chip_smoke.VIDEO[v.upper()]
            want = {k: spec[k] for k in ("encode", "decode", "first_encode",
                                         "first_decode", "recon")}
        assert {k: got[k] for k in want} == want, (v, res)


def test_envelope_plans_fit_and_cover_once(envelope_launches):
    """K1's plan at every shape the envelope launches it at that
    tests/test_torch_k1_plan.py does not list (240p's 15x26 y grid and
    30x52 feature grid, 480p's, 2160p's and 720p's HT shapes) passes that
    file's checks."""
    import test_torch_k1_plan as plans
    shapes = set()
    for got in envelope_launches.values():
        shapes |= got["shapes"]
    known = {str(k) for k in plans.SHAPES}
    new = sorted((k for k in shapes if str(k) not in known), key=str)
    assert any(k.h == 15 and k.w == 26 for k in new)      # 240p's y grid
    # 240p's recon heads, stacked at the 1/8 grid
    assert any(k.kind == "fused_dcb_stacked" and (k.h, k.w) == (30, 52)
               for k in new)
    for key in new:
        plans.test_plan_fits_and_covers_once(key)
        plans.test_plan_fills_the_card(key)
