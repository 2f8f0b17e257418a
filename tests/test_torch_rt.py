"""Port parity, DCVC-RT's P-frame codec: dcvc_tpu_torch's DMCRT and
DMCRTCodec against dcvc_tpu's at TINY_RT_CONFIG, float32 on the CPU, on
the same weights (through the bridge) and inputs.

- The copies of dcvc_tpu's key map (`_map_rt`, `key_fn_rt`) are pinned.
- The bridge gives the port's keys at TINY_RT_CONFIG and at the published
  RT_CONFIG (shapes from jax.eval_shape, the port on the meta device), the
  inverse bridge gives the flax tree back exactly, and a reference-format
  state_dict (the z prior as per-layer `f{i}` tensors) goes through
  dcvc_tpu's importer and through utils/checkpoint.py's
  load_reference_into (DMCRT.from_reference) to the same weights; a
  params.v1 file the JAX package writes loads into the port, and the
  port's save_native rewrites it byte for byte.
- Stage parity: z_int8 exact, floats within 1e-5 of each tensor's peak,
  frames within an absolute 1e-4, on an even (4x4) and an odd (5x7) y
  grid.
- The codec: 2 P frames after an intra frame, at QPs that include shifted
  banks up to qp_num + EXTRA_QP - 1, with force_ec 1 and 2, and 3 frames
  with a feature reset on the second: the streams are byte-identical to
  the JAX DMCRTCodec's, the port's round trip is bit-exact with equal
  final DPBs, and device_ec (K2's plain version on the CPU: z, then one
  call per checkerboard step) gives the host decode's frames and DPB.
  The damped random prior (init_scale 0.4, as dcvc_tpu's family runner)
  puts every scale at or below the skip threshold, so the scale third of
  the fusion output's bias and the scale half of the spatial prior's are
  lifted by 2 so that y symbols are coded.
- The training forward (its rate terms on the noise JAX draws from the
  same rng) and every parameter's gradient of an RD loss, on both adaptor
  branches.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_rt as jrt
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu.utils.torch_import import import_state_dict
from dcvc_tpu_torch.legacy import dcvc_rt
from dcvc_tpu_torch.legacy.dcvc_rt import DMCRT, DMCRTCodec, EXTRA_QP, \
    TINY_RT_CONFIG
from dcvc_tpu_torch.runtime import image_codec
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.checkpoint import load_reference_into
from dcvc_tpu_torch.utils.jax_bridge import dmc_rt_params_from_jax, \
    dmc_rt_params_to_jax

REL = 1e-5
GRAD_REL = 1e-4
X_HAT_ATOL = 1e-4
JAX_TINY = jrt.TINY_RT_CONFIG


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("copy,original", [
    (keys._map_rt, jkeys._map_rt), (keys.key_fn_rt, jkeys.key_fn_rt)])
def test_key_map_copies_source_equal(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)


def test_config_and_schedule_match_jax():
    assert dataclasses_equal(TINY_RT_CONFIG, JAX_TINY)
    assert dataclasses_equal(dcvc_rt.RT_CONFIG, jrt.RT_CONFIG)
    assert (dcvc_rt.QP_SHIFT, dcvc_rt.EXTRA_QP, dcvc_rt.INDEX_MAP) == \
        (jrt.QP_SHIFT, jrt.EXTRA_QP, jrt.INDEX_MAP)
    assert TINY_RT_CONFIG.qp_bank == JAX_TINY.qp_bank == 16
    for qp in (0, 10, 60, 63):
        for fa in range(3):
            assert dcvc_rt.shift_qp(qp, fa) == jrt.shift_qp(qp, fa)
            assert dcvc_rt.shift_qp(qp, fa, 8) == jrt.shift_qp(qp, fa, 8)


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def jax_codec():
    """The JAX codec at TINY_RT_CONFIG (kernels damped by 0.4), with the
    scale parts of the prior outputs' biases lifted by 2."""
    init = jrt.DMCRTCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                      dtype=jnp.float32, init_scale=0.4)
    params = jax.tree.map(np.array, init.params)
    cy = JAX_TINY.ch_y
    params["y_prior_fusion"]["layers_3"]["conv"]["bias"][cy:2 * cy] += 2.0
    params["y_spatial_prior"]["layers_2"]["conv"]["bias"][:cy] += 2.0
    return jrt.DMCRTCodec(init.model, params)


@pytest.fixture(scope="module")
def models(jax_codec):
    tmodel = DMCRT(TINY_RT_CONFIG)
    tmodel.load_state_dict(dmc_rt_params_from_jax(jax_codec.params))
    return jax_codec.model, {"params": jax_codec.params}, tmodel.eval()


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(jrt.DMCRT, method))


def test_state_dict_keys_match_bridge(models):
    _, v, tmodel = models
    state = dmc_rt_params_from_jax(v["params"])
    assert {k: tuple(t.shape) for k, t in state.items()} == \
        {k: tuple(t.shape) for k, t in tmodel.state_dict().items()}


def test_inverse_bridge_gives_the_flax_tree(models):
    _, v, tmodel = models
    back = dmc_rt_params_to_jax(tmodel.state_dict())
    want = jax.tree_util.tree_leaves_with_path(v["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _reference_state(tmodel):
    """The port's weights in the reference's names: the z prior's h / b / a
    banks split on their last axis into `bit_estimator_z.f{i}.{h,b,a}`
    tensors of shape (Q, C, 1, 1)."""
    state = {k: t.detach().clone() for k, t in tmodel.state_dict().items()}
    for name in ("h", "b", "a"):
        bank = state.pop(f"bit_estimator_z.{name}")
        for i in range(bank.shape[-1]):
            state[f"bit_estimator_z.f{i + 1}.{name}"] = \
                bank[..., i].reshape(bank.shape[0], -1, 1, 1).clone()
    return state


def test_reference_checkpoint_loads_like_the_importer(models, tmp_path):
    """A reference-format .pth.tar of the model: dcvc_tpu's importer
    (key_fn_rt) gives the flax params back exactly, and the port's
    load_reference_into gives the port's weights back exactly."""
    _, v, tmodel = models
    ref = _reference_state(tmodel)
    params, unused = import_state_dict(
        {k: t.numpy() for k, t in ref.items()}, v["params"],
        key_fn=jkeys.key_fn_rt)
    assert unused == []
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want[path]))
    path = tmp_path / "rt.pth.tar"
    torch.save({"state_dict": ref}, path)
    got = load_reference_into(DMCRT(TINY_RT_CONFIG), str(path))
    for k, t in tmodel.state_dict().items():
        assert torch.equal(got.state_dict()[k], t), k
    # a state_dict that lacks a layer of the z prior is refused
    del ref["bit_estimator_z.f4.h"]
    torch.save({"state_dict": ref}, path)
    with pytest.raises(KeyError):
        load_reference_into(DMCRT(TINY_RT_CONFIG), str(path))


def test_published_keys_and_shapes_match_bridge():
    """RT_CONFIG: the flax params' shapes (jax.eval_shape of both adaptor
    branches) through the bridge equal the port's state_dict on the meta
    device, key for key and shape for shape."""
    cfg = jrt.RT_CONFIG
    model = jrt.DMCRT(cfg=cfg, dtype=jnp.float32)

    def spec(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)
    ks = (jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    x = spec(1, 64, 64, 3)
    p_i = jax.eval_shape(lambda a, b, *t: model.init(
        {"params": a}, t[0], t[1], None, 0, b), *ks, x,
        spec(1, 8, 8, cfg.ch_src_d))["params"]
    p_m = jax.eval_shape(lambda a, b, *t: model.init(
        {"params": a}, *t, 0, b), *ks, x, spec(1, 8, 8, cfg.ch_d),
        spec(1, 8, 8, cfg.ch_d))["params"]
    params = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        {**p_m, **p_i})
    state = dmc_rt_params_from_jax(params)
    with torch.device("meta"):
        port = DMCRT(dcvc_rt.RT_CONFIG)
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    got = {k: tuple(t.shape) for k, t in state.items()}
    assert got == want
    assert want["q_recon"] == (cfg.qp_bank, 320)
    assert want["bit_estimator_z.h"] == (72, 128, 4)


def test_temporal_stages_match_flax(models):
    jmodel, v, tmodel = models
    c = TINY_RT_CONFIG
    ref = _rand((1, 8, 8, c.ch_src_d), 1, 0.0, 1.0)
    feat = _rand((1, 8, 8, c.ch_d), 2)
    with torch.inference_mode():
        got_i = tmodel.adaptor_i(torch.from_numpy(ref))
        got_m = tmodel.adaptor_m(torch.from_numpy(feat),
                                 torch.from_numpy(feat))
        got_r = tmodel.reset_feature(torch.from_numpy(feat))
    for got, want in zip(got_i, _j(jmodel, v, "adaptor_i", jnp.asarray(ref))):
        _close(got, want)
    for got, want in zip(got_m, _j(jmodel, v, "adaptor_m", jnp.asarray(feat),
                                   jnp.asarray(feat))):
        _close(got, want)
    assert got_r.shape == (1, 8, 8, c.ch_src_d)
    _close(got_r, _j(jmodel, v, "reset_feature", jnp.asarray(feat)))


@pytest.mark.parametrize("h,w,qp", [(64, 64, 3), (80, 112, 13)])
def test_coding_stages_match_flax(models, h, w, qp):
    jmodel, v, tmodel = models
    c = TINY_RT_CONFIG
    x = _rand((1, h, w, 3), h, 0.0, 1.0)
    feat = _rand((1, h // 8, w // 8, c.ch_d), h + 1)

    y_j, z_j = _j(jmodel, v, "analysis", jnp.asarray(x), jnp.asarray(feat),
                  qp)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x),
                                   torch.from_numpy(feat), qp)
    _close(y_t, y_j)
    assert z_t.dtype == torch.int8
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))

    yh, yw = y_j.shape[1], y_j.shape[2]
    prior_j = _j(jmodel, v, "prior0", z_j, jnp.asarray(feat), qp, yh, yw)
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        prior_t = tmodel.prior0(torch.from_numpy(np.array(z_j)),
                                torch.from_numpy(feat), qp, yh, yw)
        step_t = tmodel.prior_step(torch.from_numpy(np.array(prior_j[4])),
                                   torch.from_numpy(y_hat))
        feat_t = tmodel.synthesis_feature(torch.from_numpy(y_hat),
                                          torch.from_numpy(feat), qp)
        frames_t = tmodel.recon_frames(feat_t, qp, h, w)
    for got, want in zip(prior_t, prior_j):
        _close(got, want)
    for got, want in zip(step_t, _j(jmodel, v, "prior_step", prior_j[4],
                                    jnp.asarray(y_hat))):
        _close(got, want)
    feat_j = _j(jmodel, v, "synthesis_feature", jnp.asarray(y_hat),
                jnp.asarray(feat), qp)
    _close(feat_t, feat_j)
    frames_j = np.asarray(_j(jmodel, v, "recon_frames", feat_j, qp, h, w))
    assert frames_t.shape == (1, h, w, 3)
    assert 0.0 <= float(frames_t.min()) and float(frames_t.max()) <= 1.0
    np.testing.assert_allclose(frames_t.numpy(), frames_j, rtol=0,
                               atol=X_HAT_ATOL)


def test_random_init_is_seeded_and_damped():
    a = DMCRTCodec.init_random(torch.Generator().manual_seed(5),
                               cfg=TINY_RT_CONFIG, init_scale=0.4,
                               dtype=torch.float32, device="cpu")
    b = DMCRT(TINY_RT_CONFIG)
    b.reset_parameters(torch.Generator().manual_seed(5))
    for name, pb in b.state_dict().items():
        pa = a.model.state_dict()[name]
        if name.endswith(".weight"):
            assert torch.equal(pa, 0.4 * pb), name
        else:
            assert torch.equal(pa, pb), name
    assert torch.all(a.model.q_recon == 1.0)
    assert a.steps == 2 and not a.single_pass and a.MAX_EC == 2
    assert a.qp_bank == 16


# ---------------------------------------------------------------- codec

def _frames(h, w, seed, n):
    """An intra frame and n slowly moving smooth frames, RGB in [0, 1]."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 3.0)
    frames = [np.clip(np.roll(base, i, axis=1)
                      + rng.normal(0, 0.01, (h, w, 3)), 0, 1)
              for i in range(n + 1)]
    frames = [f[None].astype(np.float32) for f in frames]
    return frames[0], frames[1:]


@pytest.fixture(scope="module")
def tcodec(jax_codec):
    return DMCRTCodec(dmc_rt_params_from_jax(jax_codec.params),
                      cfg=TINY_RT_CONFIG, dtype=torch.float32, device="cpu")


def _encode(codec, intra, frames, qps, resets, force_ec=None):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    codec.force_ec = force_ec
    try:
        return [codec.compress(x, qp, reset_feature_memory=rs, recon=True)
                for x, qp, rs in zip(frames, qps, resets)]
    finally:
        codec.force_ec = None


def _decode(codec, intra, streams, qps, resets, h, w):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.decompress(bs, qp, h, w, ec, reset_feature_memory=rs)
            ["x_hat"] for (bs, ec), qp, rs in zip(streams, qps, resets)]


# (h, w, qps, resets, force_ec): the shifted banks of the P frames (qp
# + 8, qp + 4) up to the last row, qp_num + EXTRA_QP - 1 = 15
CODEC_CASES = [
    (64, 64, (3, 11), (False, False), None),
    (64, 64, (7, 15), (False, False), 1),
    (80, 112, (5, 13), (False, False), 2),
    (64, 64, (3, 11, 7), (False, True, False), 2),
]


@pytest.mark.parametrize("h,w,qps,resets,force_ec", CODEC_CASES)
def test_streams_byte_identical_to_jax(jax_codec, tcodec, monkeypatch, h, w,
                                       qps, resets, force_ec):
    intra, frames = _frames(h, w, sum(qps), len(qps))
    jres = _encode(jax_codec, intra, frames, qps, resets, force_ec)
    res = _encode(tcodec, intra, frames, qps, resets, force_ec)
    enc_dpb = tcodec.ref_feature
    assert max(qps) >= TINY_RT_CONFIG.qp_num      # a shifted bank
    for u, (r, j) in enumerate(zip(res, jres)):
        assert len(j["bit_stream"]) > 40, "the frame codes no y symbol"
        assert r["ec_parallel"] == j["ec_parallel"], f"frame {u}"
        if force_ec:
            assert r["ec_parallel"] == force_ec
        assert r["bit_stream"] == j["bit_stream"], f"frame {u}"
        np.testing.assert_allclose(
            r["x_hat"].numpy(), np.asarray(j["x_hat"]).reshape(1, h, w, 3),
            rtol=0, atol=X_HAT_ATOL, err_msg=f"frame {u}")
    streams = [(r["bit_stream"], r["ec_parallel"]) for r in res]
    host = _decode(tcodec, intra, streams, qps, resets, h, w)
    assert torch.equal(tcodec.ref_feature, enc_dpb)
    calls = [0]
    real = image_codec.rans_decode

    def counted(*args):
        calls[0] += 1
        return real(*args)
    monkeypatch.setattr(image_codec, "rans_decode", counted)
    tcodec.device_ec = True
    try:
        dev = _decode(tcodec, intra, streams, qps, resets, h, w)
    finally:
        tcodec.device_ec = False
    assert calls[0] == 3 * len(qps)       # z, then one per step
    assert torch.equal(tcodec.ref_feature, enc_dpb)
    for u, r in enumerate(res):
        assert bool(torch.isfinite(host[u]).all())
        assert torch.equal(host[u], r["x_hat"]), f"frame {u}"
        assert torch.equal(dev[u], host[u]), f"frame {u}"


def test_qp_past_the_bank_raises(tcodec):
    intra, frames = _frames(64, 64, 0, 1)
    tcodec.clear_dpb()
    tcodec.add_ref_feature_from_frame(intra)
    with pytest.raises(ValueError, match="out of range"):
        tcodec.compress(frames[0], TINY_RT_CONFIG.qp_num + EXTRA_QP)


# ---------------------------------------------------------------- training

def _jax_noise(rng, b, h, w):
    c = TINY_RT_CONFIG
    shapes = {"y": (b, h // 16, w // 16, c.ch_y),
              "z": (b, h // 64, w // 64, c.ch_z)}
    rng_y, rng_z = jax.random.split(rng)
    return {k: torch.from_numpy(np.array(jax.random.uniform(
        r, shapes[k], jnp.float32, -0.5, 0.5)))
        for k, r in (("y", rng_y), ("z", rng_z))}


@pytest.fixture(scope="module")
def train_models(jax_codec):
    """The codec's weights (undamped scale biases aside) as a training
    model pair."""
    tmodel = DMCRT(TINY_RT_CONFIG)
    tmodel.load_state_dict(dmc_rt_params_from_jax(jax_codec.params))
    jmodel = jrt.DMCRT(cfg=JAX_TINY, dtype=jnp.float32)
    return jmodel, jax_codec.params, tmodel


@pytest.mark.parametrize("branch", ["intra", "feature"])
def test_training_forward_and_gradients_match_jax(train_models, branch):
    jmodel, params, tmodel = train_models
    c = TINY_RT_CONFIG
    b, h, w = 2, 64, 64
    x = _rand((b, h, w, 3), 11, 0.0, 1.0)
    if branch == "intra":
        ref, memory = _rand((b, 8, 8, c.ch_src_d), 12, 0.0, 1.0), None
    else:
        ref = _rand((b, 8, 8, c.ch_d), 13)
        memory = ref
    qp = np.array([2, 13], np.int32)
    rng = jax.random.PRNGKey(7)
    noise = _jax_noise(rng, b, h, w)

    def jfwd(p):
        out, feat, _ = jmodel.apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(ref),
            None if memory is None else jnp.asarray(memory),
            jnp.asarray(qp), rng)
        loss = jnp.mean(100.0 * out["mse"] + out["bpp"]) \
            + 1e-3 * jnp.mean(feat ** 2)
        return loss, (out, feat)
    (jloss, (jout, jfeat)), jgrad = jax.jit(jax.value_and_grad(
        jfwd, has_aux=True))(params)

    tmodel.zero_grad(set_to_none=True)
    out, feat, feat2 = tmodel(
        torch.from_numpy(x), torch.from_numpy(ref),
        None if memory is None else torch.from_numpy(memory),
        torch.from_numpy(qp).long(), noise)
    assert feat is feat2
    for k in ("bits_y", "bits_z", "bpp", "mse", "x_hat"):
        _close(out[k], jout[k])
    _close(feat, jfeat)
    assert float(np.min(jout["bits_y"])) > 10
    loss = torch.mean(100.0 * out["mse"] + out["bpp"]) \
        + 1e-3 * torch.mean(feat ** 2)
    _close(loss, jloss)
    loss.backward()
    want = dmc_rt_params_from_jax(jgrad)
    names = dict(tmodel.named_parameters())
    assert set(names) == set(want)
    reached = 0
    for name, p in names.items():
        g = want[name].numpy()
        peak = float(np.abs(g).max())
        if p.grad is None:
            assert peak == 0.0, name
            continue
        reached += 1
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= GRAD_REL * peak or err == 0.0, (name, err, peak)
    # the other branch's adaptor has no gradient
    unused = "feature_adaptor_p" if branch == "intra" else \
        "feature_adaptor_i"
    assert all(names[n].grad is None for n in names if n.startswith(unused))
    assert reached > 100


def test_params_v1_files_both_ways(jax_codec, tmp_path):
    """A dcvc_tpu.params.v1 file the JAX package writes loads into the
    port's DMCRT at the file's config, and the port's save_native of that
    model rewrites the file byte for byte."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.legacy.dcvc_rt import DMCRTConfig
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    path, again = str(tmp_path / "rt.bin"), str(tmp_path / "rt_again.bin")
    save_params(path, jax_codec.params, JAX_TINY)
    cfg = native_config(path, DMCRTConfig, None)
    assert cfg == TINY_RT_CONFIG
    model = load_native_into(DMCRT(cfg), path)
    want = dmc_rt_params_from_jax(jax_codec.params)
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
