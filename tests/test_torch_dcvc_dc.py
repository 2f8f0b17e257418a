"""Port parity, the DCVC-DC P-frame model: dcvc_tpu_torch's
legacy/dcvc_dc.py DMCDC against dcvc_tpu's at TINY_DC_CONFIG, float32 on
the CPU, on the same weights and inputs (made from a numpy seed).

- The weights are the port's seeded init (DMCDC.reset_parameters,
  feature_adaptor_1 cloned into slots 0 and 2 as the codec's init does),
  lifted as tests/test_torch_dcvc_fm.py lifts FM's (perf_probe.lifted_dc:
  kernels x 0.7, the encoders' last convs x 30 (y) and x 10 (mv), the
  hyper encoders' x 40 (z) and x 450 (mv_z: DC's five-conv mv hyper
  encoder shrinks it more than FM's), the prior scale biases + 2, the
  encoders' anchors spread
  log-uniformly from 0.5 to 2.0 and the decoders' from 2.0 to 0.5, so
  that every q index has its own quant scalars) and the
  reconstruction's last conv x 30, its bias + 0.5; carried to flax by
  dc_params_to_jax, the JAX model is never initialised.
- The quant scalars (_q) equal the JAX model's jitted _q_infer bit for
  bit at every fine q index (0-63) and at every anchor (q_in_ckpt), on
  the lifted anchors and random ones.
- Every submodule and stage method, with the DPB empty and full, fa_idx
  0-2, and the 48x80 frame's odd latent grid (edge-padded to a multiple
  of 4 before the hyper encoders), within atol = rtol = 2e-5; the int16 z
  of both hyper encoders exactly; the training / eval forward on the
  INDEX_MAP schedule with and without JAX's rate noise.
The weights are held by tests/test_torch_hem_dc_weights.py, the codec by
tests/test_torch_dc_codec.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_dc as jdc
from dcvc_tpu_torch.legacy import dcvc_dc
from dcvc_tpu_torch.legacy.dcvc_fm import DPB_KEYS
from dcvc_tpu_torch.perf_probe import lifted_dc
from dcvc_tpu_torch.utils.jax_bridge import dc_params_to_jax
from test_torch_dcvc_fm import LIFT as FM_LIFT, fm_frames

TOL = 2e-5
TINY = dcvc_dc.TINY_DC_CONFIG
JAX_TINY = jdc.TINY_DC_CONFIG
Q_INDEX = 37
LIFT = {**FM_LIFT, "y_gain": 30.0, "z_gain": 40.0, "mv_z_gain": 450.0,
        "recon_gain": 30.0, "recon_bias": 0.5}
Q_NAMES = ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec")


def lifted_model(seed=0, cfg=TINY):
    """The port's DMCDC with seeded weights, lifted as LIFT says."""
    return lifted_dc(cfg, seed, LIFT)


def jax_params(state):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        dc_params_to_jax(state))


def jax_codec(state, cfg=JAX_TINY):
    """dcvc_tpu's DMCDCCodec on the port's weights (no flax init)."""
    from dcvc_tpu.runtime.dc_codec import DMCDCCodec as JaxCodec
    return JaxCodec(jdc.DMCDC(cfg=cfg), jax_params(state))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _jax_dpb(ref_frame):
    return {"ref_frame": jnp.asarray(ref_frame), "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}


@pytest.fixture(scope="module")
def dc():
    """(port model, flax params, flax model, frames, full DPB): the DPB
    after the JAX eval forward of frame 1 against frame 0."""
    tm = lifted_model().eval()
    jp = jax_params(tm.state_dict())
    jm = jdc.DMCDC(cfg=JAX_TINY)
    frames = fm_frames(64, 64, 4)
    out = jm.apply({"params": jp}, jnp.asarray(frames[1]),
                   _jax_dpb(frames[0]), 1, 1, None)
    return tm, jp, jm, frames, {k: np.asarray(v)
                                for k, v in out["dpb"].items()}


def _j(dc, method, *args):
    """dcvc_tpu's DMCDC `method` (a name: a method or a submodule)."""
    _, jp, jm, _, _ = dc
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]
    return jm.apply({"params": jp}, *args,
                    method=lambda m, *a: getattr(m, method)(*a))


def _port(dc, method, *args):
    with torch.no_grad():
        return getattr(dc[0], method)(*[_t(a) if isinstance(a, np.ndarray)
                                        else a for a in args])


def _check(dc, method, *args, jax_method=None):
    got = _port(dc, method, *args)
    want = _j(dc, jax_method or method, *args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.int16:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(np.abs(np.asarray(w)).max()) > 0
        else:
            _close(g, w)
    return [np.asarray(w) for w in want]


def _ref(dc, full):
    frames, dpb = dc[3], dc[4]
    return dpb if full else {"ref_frame": frames[0], "ref_feature": None,
                             "ref_mv_feature": None, "ref_y": None,
                             "ref_mv_y": None}


# ----------------------------------------------------------- quant scalars

def test_configs_match_jax():
    import dataclasses
    for name in ("DC_CONFIG", "TINY_DC_CONFIG"):
        assert dataclasses.asdict(getattr(dcvc_dc, name)) == \
            dataclasses.asdict(getattr(jdc, name))
    assert dcvc_dc.INDEX_MAP == jdc.INDEX_MAP
    anchors = np.array([0.5, 0.9, 1.4, 2.0])
    np.testing.assert_array_equal(dcvc_dc.fine_q_scales(anchors),
                                  jdc.fine_q_scales(anchors))


@pytest.fixture(scope="module")
def jax_q(dc):
    """dcvc_tpu's DMCDC._q_infer (it reads no parameter of its module:
    called on the unbound flax model), jitted, q_index traced (as the
    codec's programs take it)."""
    jm = dc[2]
    return jax.jit(lambda basic, anchors, qi, ckpt: jdc.DMCDC._q_infer(
        jm, basic, anchors, qi, ckpt), static_argnums=3)


@pytest.mark.parametrize("anchors", ["lifted", "random"])
def test_q_scalars_exact(dc, jax_q, anchors):
    """Every fine q index and every anchor of the four quant vectors,
    equal to the JAX package's bit for bit."""
    tm = lifted_model().eval()
    if anchors == "random":
        rng = np.random.default_rng(3)
        with torch.no_grad():
            for name in dcvc_dc.DMCDC.Q_PARAMS:
                p = getattr(tm, name)
                v = np.exp(rng.uniform(-2, 2, p.shape)) if "scale" in name \
                    else rng.uniform(0.5, 2, p.shape)
                p.copy_(torch.from_numpy(v.astype(np.float32)))
    distinct = set()
    for name in Q_NAMES:
        basic, anchors = (jnp.asarray(getattr(tm, name.replace(
            "_q_", f"_q_{part}_")).detach().numpy())
            for part in ("basic", "scale"))
        for ckpt, n in ((False, dcvc_dc.FINE_QP_NUM),
                        (True, TINY.anchor_num)):
            with torch.no_grad():
                got = np.stack([tm._q(name, i, ckpt).numpy()
                                for i in range(n)])
            want = np.stack([np.asarray(jax_q(basic, anchors, jnp.int32(i),
                                              ckpt)) for i in range(n)])
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {ckpt}")
            distinct.update(np.unique(got[:, 0, 0, 0, 0]).tolist())
    assert len(distinct) > 64


# ------------------------------------------------------------ submodules

@pytest.mark.parametrize("name,shape", [
    ("optic_flow", None),
    ("feature_extractor", (1, 32, 32, TINY.ch_1x)),
    ("mv_hyper_prior_encoder", (1, 4, 4, TINY.ch_mv)),
    ("mv_hyper_prior_decoder", (1, 1, 1, TINY.ch_n)),
    ("mv_y_prior_fusion_adaptor_0", (1, 4, 4, TINY.ch_mv)),
    ("mv_y_prior_fusion_adaptor_1", (1, 4, 4, 2 * TINY.ch_mv)),
    ("mv_y_prior_fusion", (1, 4, 4, 2 * TINY.ch_mv)),
    ("mv_y_spatial_prior", (1, 4, 4, 3 * TINY.ch_mv)),
    ("contextual_hyper_prior_encoder", (1, 4, 4, TINY.ch_16x)),
    ("contextual_hyper_prior_decoder", (1, 1, 1, TINY.ch_16x)),
    ("temporal_prior_encoder", (1, 16, 16, TINY.ch_4x)),
    ("y_prior_fusion_adaptor_0", (1, 4, 4, 2 * TINY.ch_16x)),
    ("y_prior_fusion_adaptor_1", (1, 4, 4, 3 * TINY.ch_16x)),
    ("y_spatial_prior", (1, 4, 4, 3 * TINY.ch_16x)),
])
def test_submodule_matches_flax(dc, name, shape):
    if shape is None:                  # SpyNet on two frames
        args = (dc[3][1], dc[3][0])
    else:
        args = (_rand(*shape, seed=len(name), scale=2.0),)
    _check(dc, name, *args)


@pytest.mark.parametrize("with_context", [False, True])
def test_mv_coders_match_flax(dc, with_context):
    ctx = _rand(1, 16, 16, TINY.ch_mv, seed=4) if with_context else None
    _check(dc, "mv_encoder", _rand(1, 64, 64, 2, scale=3.0), ctx,
           np.float32(1.3))
    _check(dc, "mv_decoder", _rand(1, 4, 4, TINY.ch_mv, scale=2.0),
           np.float32(0.7))


def test_contextual_coders_match_flax(dc):
    c = TINY
    c1 = _rand(1, 64, 64, c.ch_1x, seed=2)
    c2 = _rand(1, 32, 32, c.ch_2x, seed=3)
    c3 = _rand(1, 16, 16, c.ch_4x, seed=4)
    _check(dc, "contextual_encoder", _rand(1, 64, 64, 3, seed=1), c1, c2,
           c3, np.float32(1.7))
    _check(dc, "contextual_decoder", _rand(1, 4, 4, c.ch_16x, seed=5), c2,
           c3, np.float32(0.6))


def test_recon_generation_matches_flax(dc):
    """DC's concat order is [c1, recon_feat] (its forward(ctx, res))."""
    _check(dc, "recon_generation_net", _rand(1, 32, 32, 32, seed=1),
           _rand(1, 32, 32, TINY.ch_1x, seed=2))


def test_align_and_fusion_match_flax(dc):
    from scipy.ndimage import gaussian_filter
    c = TINY
    x = gaussian_filter(_rand(1, 32, 40, c.ch_1x, seed=1), (0, 2, 2, 0))
    _check(dc, "align", x, _rand(1, 32, 40, c.ch_1x + 5, seed=2),
           _rand(1, 32, 40, 2, seed=3, scale=3.0))
    _check(dc, "context_fusion_net", _rand(1, 32, 32, c.ch_1x, seed=1),
           _rand(1, 16, 16, c.ch_2x, seed=2), _rand(1, 8, 8, c.ch_4x,
                                                    seed=3))


# --------------------------------------------------------- stage methods

@pytest.mark.parametrize("full,q_in_ckpt", [(False, False), (True, False),
                                            (True, True)])
def test_mv_stages_match_flax(dc, full, q_in_ckpt):
    """mv_analysis, mv_prior0 on the JAX encoder's int16 mv_z, the three
    spatial prior steps on a rounded y_hat so far, mv_synthesis."""
    ref = _ref(dc, full)
    qi = 2 if q_in_ckpt else Q_INDEX
    mv_y, mv_z = _check(dc, "mv_analysis", dc[3][2], ref["ref_frame"],
                        ref["ref_mv_feature"], qi, q_in_ckpt)
    out = _check(dc, "mv_prior0", mv_z, ref["ref_mv_y"], 4, 4)
    y_hat = np.round(mv_y)
    for step in (1, 2, 3):
        _check(dc, "mv_prior_step", out[4], y_hat, step)
    _check(dc, "mv_synthesis", y_hat, qi, q_in_ckpt)


def _mv_hat(dc):
    mv_hat = np.asarray(_j(dc, "mv_synthesis", np.round(
        _rand(1, 4, 4, TINY.ch_mv, seed=5, scale=3.0)), Q_INDEX)[0])
    assert np.abs(mv_hat).max() > 0.5
    return mv_hat


@pytest.mark.parametrize("full,fa_idx", [(False, 0), (True, 0), (True, 1),
                                         (True, 2)])
def test_mc_matches_flax(dc, full, fa_idx):
    ref = _ref(dc, full)
    _check(dc, "mc", ref["ref_frame"], ref["ref_feature"], fa_idx,
           _mv_hat(dc))


@pytest.mark.parametrize("full", [False, True])
def test_ctx_stages_match_flax(dc, full):
    """ctx_analysis, ctx_prior0 and its steps, synthesis, on the JAX
    contexts."""
    ref = _ref(dc, full)
    c1, c2, c3 = (np.asarray(c) for c in _j(
        dc, "mc", ref["ref_frame"], ref["ref_feature"], 1, _mv_hat(dc)))
    y, z = _check(dc, "ctx_analysis", dc[3][2], c1, c2, c3, Q_INDEX)
    out = _check(dc, "ctx_prior0", z, ref["ref_y"], c3, 4, 4)
    y_hat = np.round(y)
    for step in (1, 2, 3):
        _check(dc, "ctx_prior_step", out[4], y_hat, step)
    x_hat, _ = _check(dc, "synthesis", y_hat, c1, c2, c3, Q_INDEX)
    assert 0.0 <= x_hat.min() and x_hat.max() <= 1.0 and x_hat.std() > 0.01


def test_odd_latent_pad4_and_crop(dc):
    """A 48x80 frame padded to 64x96 by the codec: the /16 grid 4x6 is
    edge-padded to 4x8 for the hyper encoder, the hyper decoder's output
    cropped back."""
    ref, x = [np.pad(f, ((0, 0), (0, 16), (0, 16), (0, 0)), mode="edge")
              for f in fm_frames(48, 80, 2, seed=3)]
    mv_y, mv_z = _check(dc, "mv_analysis", x, ref, None, Q_INDEX)
    assert mv_y.shape[1:3] == (4, 6) and mv_z.shape[1:3] == (1, 2)
    out = _check(dc, "mv_prior0", mv_z, None, 4, 6)
    assert out[2].shape[1:3] == (4, 6)


# ---------------------------------------------------------------- forward

def test_eval_forward_chain_matches_flax(dc):
    """The eval forward (rates of the rounded latents) over frames 1-3
    (feature adaptors INDEX_MAP[1..3]) from an empty DPB at anchors 1, 0
    and 3; each frame gets the JAX DPB."""
    frames = dc[3]
    tm, jp, jm = dc[0], dc[1], dc[2]
    dpb = dict.fromkeys(DPB_KEYS)
    dpb["ref_frame"] = frames[0]
    for i, q in ((1, 1), (2, 0), (3, 3)):
        want = jm.apply({"params": jp}, jnp.asarray(frames[i]),
                        {k: None if v is None else jnp.asarray(v)
                         for k, v in dpb.items()}, q, i, None)
        with torch.no_grad():
            got, tdpb = tm(torch.from_numpy(frames[i]),
                           {k: _t(v) for k, v in dpb.items()}, q, i)
        pixels = 64 * 64
        for k in ("y", "z", "mv_y", "mv_z"):
            _close(got[f"bits_{k}"] / pixels, want[f"bpp_{k}"])
        for k in ("bpp", "mse", "x_hat", "warp_frame"):
            _close(got[k], want[k])
        for k in DPB_KEYS:
            _close(tdpb[k], want["dpb"][k])
        assert float(got["bits_y"][0]) > 10 and \
            float(got["bits_mv_y"][0]) > 10
        dpb = {k: np.asarray(v) for k, v in want["dpb"].items()}


def test_training_forward_noise_matches_flax(dc):
    """With JAX's rate noise (split(rng, 4): y, mv_y, z, mv_z) passed to
    the port as tensors."""
    frames, dpb = dc[3], dc[4]
    tm, jp, jm = dc[0], dc[1], dc[2]
    rng = jax.random.PRNGKey(11)
    c = TINY
    shapes = {"y": (1, 4, 4, c.ch_16x), "mv_y": (1, 4, 4, c.ch_mv),
              "z": (1, 1, 1, c.ch_16x), "mv_z": (1, 1, 1, c.ch_n)}
    noise = {k: _t(jax.random.uniform(r, shapes[k], jnp.float32, -0.5,
                                      0.5))
             for k, r in zip(("y", "mv_y", "z", "mv_z"),
                             jax.random.split(rng, 4))}
    want = jm.apply({"params": jp}, jnp.asarray(frames[2]),
                    {k: jnp.asarray(v) for k, v in dpb.items()}, 2, 2, rng)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(frames[2]),
                    {k: _t(v) for k, v in dpb.items()}, 2, 2, noise)
    _close(got["bpp"], want["bpp"])
    _close(got["x_hat"], want["x_hat"])
