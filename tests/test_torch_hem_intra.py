"""Port parity, IntraNoAR (the HEM / DC / FM family intra codec):
dcvc_tpu_torch's HEMUNet, IntraNoAR and IntraNoARCodec against
dcvc_tpu's at TINY_INTRA_NOAR_CONFIG, float32 on the CPU, on the same
weights (through the bridge: the port's modules mirror the flax tree) and
inputs.

- The bridge gives the port's keys at TINY and at the published configs
  (N 192 and FM's N 256; shapes from jax.eval_shape, the port on the meta
  device), the inverse bridge gives the flax tree back exactly, and
  params.v1 files move both ways.
- HEMUNet, the stages (analysis, prior, spatial, synthesis) and the
  training forward (with and without the rate noise) within
  atol = rtol = 2e-5; z exact.
- The codec: streams byte-identical to the JAX IntraNoARCodec's at 64x64
  and 64x96 for q_scale 0.8 and 1.4; the port's round trip bit-exact;
  the port decodes the JAX stream to the JAX x_hat within 2e-5.
- The weights: the JAX codec's seeded init at init_scale 0.7, the
  encoder's last conv times 20 and the hyper encoder's last times 8 (the
  quant step is lower-bounded at 0.5, so y is lifted in the encoder) and
  the scale parts of the prior outputs' last biases lifted by 2, so that
  z and y symbols spread over many CDF rows.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_hem as jhem
from dcvc_tpu.legacy import hem_intra as jhi
from dcvc_tpu.runtime.evc_codec import IntraNoARCodec as JaxCodec
from dcvc_tpu_torch.legacy import dcvc_hem, hem_intra
from dcvc_tpu_torch.runtime.evc_codec import IntraNoARCodec
from dcvc_tpu_torch.utils.jax_bridge import intra_noar_params_from_jax, \
    intra_noar_params_to_jax

TOL = 2e-5
TINY = hem_intra.TINY_INTRA_NOAR_CONFIG
JAX_TINY = jhi.TINY_INTRA_NOAR_CONFIG


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _img(h, w, seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 2.0)
    return np.clip((x - 0.5) * 3 + 0.5, 0, 1)[None].astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    init = JaxCodec.init_random(jax.random.PRNGKey(4), cfg=JAX_TINY,
                                init_scale=0.7)
    p = jax.tree.map(np.array, init.params)
    n = JAX_TINY.n
    p["enc"]["layers_6"]["conv"]["kernel"] *= 20.0
    p["hyper_enc"]["layers_8"]["conv"]["kernel"] *= 8.0
    p["y_prior_fusion"]["layers_4"]["conv"]["bias"][n:2 * n] += 2.0
    sp = p["y_spatial_prior"]["layers_4"]["conv"]["bias"]
    sp[:n // 2] += 2.0
    sp[n:n + n // 2] += 2.0
    jcodec = JaxCodec(init.model, jax.tree.map(jnp.asarray, p))
    tcodec = IntraNoARCodec(intra_noar_params_from_jax(p), cfg=TINY,
                            device="cpu")
    return jcodec, tcodec


def _j(jcodec, method, *args, **kw):
    return jcodec.model.apply({"params": jcodec.params}, *args,
                              method=getattr(jhi.IntraNoAR, method), **kw)


def test_configs_match_jax():
    for name in ("INTRA_NOAR_CONFIG", "INTRA_NOAR_FM_CONFIG",
                 "TINY_INTRA_NOAR_CONFIG"):
        assert dataclasses.asdict(getattr(hem_intra, name)) == \
            dataclasses.asdict(getattr(jhi, name))
    assert hem_intra.INTRA_NOAR_FM_CONFIG.n == 256


def test_keys_and_inverse_bridge(codecs):
    jcodec, tcodec = codecs
    state = intra_noar_params_from_jax(jcodec.params)
    assert {k: tuple(t.shape) for k, t in state.items()} == \
        {k: tuple(t.shape) for k, t in tcodec.model.state_dict().items()}
    assert tuple(state["refine_unet.conv1.se.fc1.weight"].shape) == (2, 32)
    back = intra_noar_params_to_jax(tcodec.model.state_dict())
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(jcodec.params)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


@pytest.mark.parametrize("name", ["INTRA_NOAR_CONFIG",
                                  "INTRA_NOAR_FM_CONFIG"])
def test_published_keys_and_shapes_match_bridge(name):
    model = jhi.IntraNoAR(cfg=getattr(jhi, name))
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3))),
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    state = intra_noar_params_from_jax(params)
    with torch.device("meta"):
        port = hem_intra.IntraNoAR(getattr(hem_intra, name))
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in state.items()} == want
    back = intra_noar_params_to_jax(
        {k: torch.zeros(s) for k, s in want.items()})
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)


@pytest.mark.parametrize("in_ch,out_ch,hw", [(8, 8, (16, 24)),
                                             (6, 4, (8, 8))])
def test_hem_unet_matches_flax(in_ch, out_ch, hw):
    """HEMUNet at full resolution (refine_ch in, 32/64/128 inside), on a
    grid whose two sides differ."""
    jm = jhem.HEMUNet(out_ch)
    x = np.random.default_rng(in_ch).normal(0, 1, (2,) + hw + (in_ch,)) \
        .astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(in_ch)},
                     jnp.asarray(x))["params"]
    tm = dcvc_hem.HEMUNet(in_ch, out_ch)
    tm.load_state_dict(intra_noar_params_from_jax(params))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)),
               jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("h,w,qs", [(64, 64, 0.8), (64, 128, 1.4)])
def test_stages_match_flax(codecs, h, w, qs):
    jcodec, tcodec = codecs
    m = tcodec.model
    x = _img(h, w, 6)
    q = jnp.float32(qs)
    tq = torch.tensor(qs, dtype=torch.float32)
    y_j, z_j = _j(jcodec, "analysis", jnp.asarray(x), q)
    with torch.inference_mode():
        y_t, z_t = m.analysis(torch.from_numpy(x), tq)
        _close(y_t, y_j)
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
        assert int(np.abs(np.asarray(z_j)).max()) > 0
        prior_j = _j(jcodec, "prior", z_j)
        prior_t = m.prior(torch.from_numpy(np.array(z_j)))
        for g, want in zip(prior_t, prior_j):
            _close(g, want)
        y_hat0 = np.round(np.asarray(y_j)).astype(np.float32)
        sp_j = _j(jcodec, "spatial", jnp.asarray(y_hat0), *prior_j)
        sp_t = m.spatial(torch.from_numpy(y_hat0),
                         *[torch.from_numpy(np.array(a)) for a in prior_j])
        for g, want in zip(sp_t, sp_j):
            _close(g, want)
        x_j = _j(jcodec, "synthesis", jnp.asarray(y_hat0), q)
        x_t = m.synthesis(torch.from_numpy(y_hat0), tq)
        _close(x_t, x_j)
        assert 0.01 < float(x_t.std())


def test_q_basic_lower_bound():
    """IntraNoAR bounds q_basic below at 0.5 (EVC does not)."""
    m = hem_intra.IntraNoAR(TINY)
    with torch.no_grad():
        m.q_basic.fill_(0.1)
    assert float(m._curr_q(torch.tensor(2.0)).max()) == 1.0


def test_training_forward_matches_flax(codecs):
    jcodec, tcodec = codecs
    x = np.concatenate([_img(64, 64, 8), _img(64, 64, 9)])
    rng = jax.random.PRNGKey(7)
    noise = torch.from_numpy(np.array(jax.random.uniform(
        rng, (2, 4, 4, TINY.n), jnp.float32, -0.5, 0.5)))
    for qs, use_rng in ((None, False), (1.2, True)):
        q = None if qs is None else jnp.float32(qs)
        want = jcodec.model.apply({"params": jcodec.params}, jnp.asarray(x),
                                  q, rng if use_rng else None)
        with torch.no_grad():
            got = tcodec.model(torch.from_numpy(x),
                               None if qs is None else torch.tensor(qs),
                               noise if use_rng else None)
        for k in ("x_hat", "bpp", "bpp_y", "bpp_z", "mse"):
            _close(got[k], want[k])


@pytest.mark.parametrize("h,w", [(64, 64), (64, 96)])
def test_streams_byte_identical_to_jax(codecs, h, w):
    jcodec, tcodec = codecs
    x = _img(h, w, 21 + w)
    for qs in (0.8, 1.4):
        j = jcodec.compress(jnp.asarray(x), qs, h=h, w=w)
        r = tcodec.compress(x, qs)
        assert len(j["bit_stream"]) > 60
        assert r["bit_stream"] == j["bit_stream"]
        _close(r["x_hat"], j["x_hat"])
        out = tcodec.decompress(j["bit_stream"], qs, h, w)
        assert torch.equal(out["x_hat"], r["x_hat"])
        _close(out["x_hat"], j["x_hat"])
        assert out["x_hat"].shape == (1, h, w, 3)


def test_random_init_is_seeded_and_damped():
    a = IntraNoARCodec.init_random(torch.Generator().manual_seed(2),
                                   cfg=TINY, init_scale=0.4, device="cpu")
    b = hem_intra.IntraNoAR(TINY)
    b.reset_parameters(torch.Generator().manual_seed(2))
    for k, t in b.state_dict().items():
        scale = 0.4 if k.endswith(".weight") else 1.0
        torch.testing.assert_close(a.model.state_dict()[k], t * scale,
                                   rtol=0, atol=0)


def test_params_v1_files_both_ways(codecs, tmp_path):
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    jcodec, tcodec = codecs
    path, again = str(tmp_path / "noar.bin"), str(tmp_path / "again.bin")
    save_params(path, jax.tree.map(np.asarray, jcodec.params), JAX_TINY)
    cfg = native_config(path, hem_intra.IntraNoARConfig, None)
    assert cfg == TINY
    model = load_native_into(hem_intra.IntraNoAR(cfg), path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, tcodec.model.state_dict()[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
