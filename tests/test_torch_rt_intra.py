"""Port parity, DCVC-RT's intra codec: dcvc_tpu_torch's DMCIRT and
RTIntraCodec against dcvc_tpu's at TINY_RT_INTRA_CONFIG, float32 on the
CPU, on the same weights (through the bridge: key_fn_dmci's names) and
inputs.

- The bridge gives the port's keys at TINY and at the published
  DMCIRTConfig() (shapes from jax.eval_shape, the port on the meta
  device), and the inverse bridge gives the flax tree back exactly; a
  params.v1 file the JAX package writes loads into the port, and the
  port's save_native rewrites it byte for byte.
- Stage parity (analysis, prior0 with its q maps, prior_step, synthesis):
  z_int8 exact, floats within 1e-5 of each tensor's peak, frames within
  an absolute 1e-4.
- The conv kernels are damped by 0.7, as the training tests damp theirs,
  and the scale parts of the prior outputs' biases lifted by 2 so that y
  symbols are coded.
- The codec: streams byte-identical to the JAX RTIntraCodec's at 64x64
  (two QPs) and at 70x90 (an odd 5x6 y grid, after tests/test_rt_intra.py),
  with force_ec 1 and 2; the port's round trip bit-exact and in [0, 1];
  device_ec raises (the JAX codec has no device decode).
- The training forward (its rate terms on the noise JAX draws from the
  same rng) and every parameter's gradient of an RD loss.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import rt_intra as jrt
from dcvc_tpu.runtime.rt_image_codec import RTIntraCodec as JaxCodec
from dcvc_tpu_torch.legacy import rt_intra
from dcvc_tpu_torch.legacy.rt_intra import DMCIRT, DMCIRTConfig, \
    TINY_RT_INTRA_CONFIG
from dcvc_tpu_torch.runtime.rt_image_codec import RTIntraCodec
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax, \
    dmci_params_to_jax

REL = 1e-5
GRAD_REL = 1e-4
X_HAT_ATOL = 1e-4
JAX_TINY = jrt.TINY_RT_INTRA_CONFIG


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


def _img(h, w, seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 2.0)
    return np.clip(x, 0, 1)[None].astype(np.float32)


@pytest.fixture(scope="module")
def jax_codec():
    """The JAX codec at TINY with its conv kernels damped by 0.7, as the
    training tests damp theirs: undamped, the random decoder's output
    before the clamp reaches ~1e1, where the 1e-4 frame tolerance is
    below float32's rounding of the two frameworks' sums."""
    init = JaxCodec.init_random(jax.random.PRNGKey(3), cfg=JAX_TINY,
                                dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.asarray(leaf) * (0.7 if p[-1].key == "kernel"
                                            else 1.0), init.params)
    cy = JAX_TINY.ch_y
    params["y_prior_fusion"]["conv_3"]["conv"]["bias"][2:2 + cy] += 2.0
    params["y_spatial_prior"]["conv_3"]["conv"]["bias"][:cy] += 2.0
    return JaxCodec(params, cfg=JAX_TINY, dtype=jnp.float32)


@pytest.fixture(scope="module")
def models(jax_codec):
    tmodel = DMCIRT(TINY_RT_INTRA_CONFIG)
    tmodel.load_state_dict(dmci_params_from_jax(jax_codec.params))
    return jax_codec.model, {"params": jax_codec.params}, tmodel.eval()


@pytest.fixture(scope="module")
def tcodec(jax_codec):
    return RTIntraCodec(dmci_params_from_jax(jax_codec.params),
                        cfg=TINY_RT_INTRA_CONFIG, dtype=torch.float32,
                        device="cpu")


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(jrt.DMCIRT, method))


def test_config_matches_jax():
    import dataclasses
    for a, b in ((TINY_RT_INTRA_CONFIG, JAX_TINY),
                 (DMCIRTConfig(), jrt.DMCIRTConfig())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.as_dmci()) == \
            dataclasses.asdict(b.as_dmci())
    assert DMCIRTConfig().ch_enc_dec == 368


def test_keys_and_inverse_bridge(models):
    _, v, tmodel = models
    state = dmci_params_from_jax(v["params"])
    assert {k: tuple(t.shape) for k, t in state.items()} == \
        {k: tuple(t.shape) for k, t in tmodel.state_dict().items()}
    back = dmci_params_to_jax(tmodel.state_dict())
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = jax.tree_util.tree_leaves_with_path(v["params"])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


def test_published_keys_and_shapes_match_bridge():
    model = jrt.DMCIRT(cfg=jrt.DMCIRTConfig(), dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a, b, x_: model.init(
        {"params": a}, x_, 0, b), jax.random.PRNGKey(0),
        jax.random.PRNGKey(1), x)["params"]
    params = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    state = dmci_params_from_jax(params)
    with torch.device("meta"):
        port = DMCIRT(DMCIRTConfig())
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in state.items()} == want
    assert want["enc.enc_2.5.dc.0.weight"] == (368, 368, 1, 1)
    assert want["y_prior_fusion.conv.3.weight"] == (514, 512, 1, 1)


def test_separate_prior_matches_jax():
    params = np.random.default_rng(4).normal(0, 3, (1, 3, 5, 34)).astype(
        np.float32)
    got = rt_intra.separate_prior_rt_image(torch.from_numpy(params))
    want = jrt.separate_prior_rt_image(jnp.asarray(params))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    assert float(got[0].min()) >= 0.5 and float(got[1].max()) <= 2.0


@pytest.mark.parametrize("h,w,qp", [(64, 64, 5), (70, 90, 2)])
def test_stages_match_flax(models, h, w, qp):
    jmodel, v, tmodel = models
    pad_h, pad_w = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(_img(h, w, qp), ((0, 0), (0, pad_h - h), (0, pad_w - w),
                                (0, 0)), mode="edge")
    y_j, z_j = _j(jmodel, v, "analysis", jnp.asarray(x), qp)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x), qp)
    _close(y_t, y_j)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    yh, yw = y_j.shape[1], y_j.shape[2]
    prior_j = _j(jmodel, v, "prior0", z_j, yh, yw)
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        prior_t = tmodel.prior0(torch.from_numpy(np.array(z_j)), yh, yw)
        step_t = tmodel.prior_step(torch.from_numpy(np.array(prior_j[2])),
                                   torch.from_numpy(y_hat), 2)
        x_t = tmodel.synthesis(torch.from_numpy(y_hat),
                               torch.from_numpy(np.array(prior_j[4])), qp,
                               h, w)
    for got, want in zip(prior_t, prior_j):
        _close(got, want)
    for got, want in zip(step_t, _j(jmodel, v, "prior_step", prior_j[2],
                                    jnp.asarray(y_hat), 2)):
        _close(got, want)
    x_j = np.asarray(_j(jmodel, v, "synthesis", jnp.asarray(y_hat),
                        prior_j[4], qp, h, w))
    assert x_t.shape == (1, h, w, 3)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=X_HAT_ATOL)


@pytest.mark.parametrize("h,w,qp,force_ec", [
    (64, 64, 0, None), (64, 64, 5, 2), (70, 90, 2, 1), (70, 90, 7, 2)])
def test_streams_byte_identical_to_jax(jax_codec, tcodec, h, w, qp,
                                       force_ec):
    x = _img(h, w, 10 + qp)
    jax_codec.force_ec = tcodec.force_ec = force_ec
    try:
        j = jax_codec.compress(x, qp, h, w)
        r = tcodec.compress(x, qp)
    finally:
        jax_codec.force_ec = tcodec.force_ec = None
    assert len(j["bit_stream"]) > 40
    assert r["ec_parallel"] == j["ec_parallel"] <= RTIntraCodec.MAX_EC
    if force_ec:
        assert r["ec_parallel"] == force_ec
    assert r["bit_stream"] == j["bit_stream"]
    np.testing.assert_allclose(r["x_hat"].numpy(), np.asarray(j["x_hat"]),
                               rtol=0, atol=X_HAT_ATOL)
    out = tcodec.decompress(j["bit_stream"], qp, h, w, j["ec_parallel"])
    assert torch.equal(out["x_hat"], r["x_hat"])
    assert out["x_hat"].shape == (1, h, w, 3)
    assert 0.0 <= float(out["x_hat"].min()) <= float(out["x_hat"].max()) \
        <= 1.0


def test_device_ec_raises(jax_codec):
    state = dmci_params_from_jax(jax_codec.params)
    with pytest.raises(ValueError, match="device entropy decode"):
        RTIntraCodec(state, cfg=TINY_RT_INTRA_CONFIG, dtype=torch.float32,
                     device="cpu", device_ec=True)
    with pytest.raises(ValueError, match="device entropy decode"):
        RTIntraCodec.init_random(cfg=TINY_RT_INTRA_CONFIG,
                                 dtype=torch.float32, device="cpu",
                                 device_ec=True)


def test_random_init_is_seeded():
    a = RTIntraCodec.init_random(torch.Generator().manual_seed(2),
                                 cfg=TINY_RT_INTRA_CONFIG,
                                 dtype=torch.float32, device="cpu")
    b = DMCIRT(TINY_RT_INTRA_CONFIG)
    b.reset_parameters(torch.Generator().manual_seed(2))
    for k, t in b.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], t), k
    assert float(b.q_scale_enc.detach()[0, 0]) == pytest.approx(0.5)
    assert float(b.q_scale_dec.detach()[0, 0]) == pytest.approx(2.0)


def test_training_forward_and_gradients_match_jax(models):
    jmodel, v, tmodel = models
    c = TINY_RT_INTRA_CONFIG
    b, h, w = 2, 64, 64
    x = np.concatenate([_img(h, w, 21), _img(h, w, 22)])
    qp = np.array([1, 6], np.int32)
    rng = jax.random.PRNGKey(5)
    rng_y, rng_z = jax.random.split(rng)
    noise = {"y": torch.from_numpy(np.array(jax.random.uniform(
        rng_y, (b, h // 16, w // 16, c.ch_y), jnp.float32, -0.5, 0.5))),
        "z": torch.from_numpy(np.array(jax.random.uniform(
            rng_z, (b, h // 64, w // 64, c.ch_z), jnp.float32, -0.5,
            0.5)))}

    def jfwd(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(qp),
                           rng)
        return jnp.mean(100.0 * out["mse"] + out["bpp"]), out
    (jloss, jout), jgrad = jax.jit(jax.value_and_grad(
        jfwd, has_aux=True))(v["params"])
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(x), torch.from_numpy(qp).long(), noise)
    for k in ("bits_y", "bits_z", "bpp", "mse", "x_hat"):
        _close(out[k], jout[k])
    assert float(np.min(jout["bits_y"])) > 10
    loss = torch.mean(100.0 * out["mse"] + out["bpp"])
    _close(loss, jloss)
    loss.backward()
    want = dmci_params_from_jax(jgrad)
    names = dict(tmodel.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        g = want[name].numpy()
        peak = float(np.abs(g).max())
        if p.grad is None:
            assert peak == 0.0, name
            continue
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= GRAD_REL * peak or err == 0.0, (name, err, peak)
    tmodel.zero_grad(set_to_none=True)


def test_params_v1_files_both_ways(jax_codec, tmp_path):
    """A dcvc_tpu.params.v1 file the JAX package writes loads into the
    port's DMCIRT at the file's config, and the port's save_native of that
    model rewrites the file byte for byte."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    path, again = str(tmp_path / "rti.bin"), str(tmp_path / "rti_again.bin")
    save_params(path, jax_codec.params, JAX_TINY)
    cfg = native_config(path, DMCIRTConfig, None)
    assert cfg == TINY_RT_INTRA_CONFIG
    model = load_native_into(DMCIRT(cfg), path)
    want = dmci_params_from_jax(jax_codec.params)
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
