"""Port parity, DMC-HTS model: the stage methods of dcvc_tpu_torch's DMCHT
against dcvc_tpu's flax DMCHT at TINY_HT_CONFIG, float32 on the CPU, on
the same weights (through the bridge) and inputs; and the bridge checked
both ways through dcvc_tpu's reference-checkpoint importer.

z_int8 must be exact.  Float outputs must agree within 1e-5 of each
tensor's largest magnitude: the same f32 sums taken in another order
through up to a dozen blocks (the bound of tests/test_torch_dmci.py).
The reconstructed frames are a clamp to [-0.5, 0.5] of head outputs far
larger than that range, so they are held to an absolute 1e-4 instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.common import separate_prior_video_infer \
    as jax_separate_prior_video_infer
from dcvc_tpu.models.dmc_ht import DMCHT as JaxDMCHT
from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY
from dcvc_tpu.runtime.video_codec import _init_both_branches
from dcvc_tpu.utils.torch_import import import_state_dict, key_fn_dmc_ht
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HT_CONFIG
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax

REL = 1e-5
X_HAT_ATOL = 1e-4
QP = 3


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL * scale


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def models():
    c = JAX_TINY
    jmodel = JaxDMCHT(cfg=c, dtype=jnp.float32)
    params = _init_both_branches(
        jmodel, jnp.zeros((1, 64, 64, 24), jnp.float32),
        jnp.zeros((1, 8, 8, c.ch_src_intra), jnp.float32),
        jnp.zeros((1, 8, 8, c.ch_d), jnp.float32),
        jnp.zeros((1, 8, 8, c.ch_m), jnp.float32), jax.random.PRNGKey(0))
    tmodel = DMCHT(TINY_HT_CONFIG)
    tmodel.load_state_dict(dmc_ht_params_from_jax(params))
    return jmodel, {"params": params}, tmodel.eval()


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(JaxDMCHT, method))


def test_state_dict_keys_match_bridge(models):
    _, v, tmodel = models
    assert set(dmc_ht_params_from_jax(v["params"])) == \
        set(tmodel.state_dict())


def test_bridge_round_trips_through_importer(models):
    """The port's state_dict, read by dcvc_tpu's reference-checkpoint
    importer, gives back the flax params exactly and leaves no key."""
    _, v, tmodel = models
    state = {k: t.numpy() for k, t in tmodel.state_dict().items()}
    params, unused = import_state_dict(state, v["params"],
                                       key_fn=key_fn_dmc_ht)
    assert unused == []
    got = jax.tree_util.tree_leaves_with_path(params)
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_temporal_stages_match_flax(models):
    jmodel, v, tmodel = models
    c = TINY_HT_CONFIG
    ref = _rand((1, 8, 8, c.ch_src_intra), 1, -0.5, 0.5)
    feat = _rand((1, 8, 8, c.ch_d), 2)
    mem = _rand((1, 8, 8, c.ch_m), 3)
    with torch.inference_mode():
        got_i = tmodel.adaptor_i(torch.from_numpy(ref))
        got_m = tmodel.adaptor_m(torch.from_numpy(mem),
                                 torch.from_numpy(feat))
        got_r = tmodel.reset_feature(torch.from_numpy(feat))
    for got, want in zip(got_i, _j(jmodel, v, "adaptor_i", jnp.asarray(ref))):
        _close(got, want)
    for got, want in zip(got_m, _j(jmodel, v, "adaptor_m", jnp.asarray(mem),
                                   jnp.asarray(feat))):
        _close(got, want)
    _close(got_r, _j(jmodel, v, "reset_feature", jnp.asarray(feat)))


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_coding_stages_match_flax(models, h, w):
    jmodel, v, tmodel = models
    c = TINY_HT_CONFIG
    x = _rand((1, h, w, 3 * c.frame_delay), h, -0.5, 0.5)
    ctx = _rand((1, h // 8, w // 8, c.ch_d), h + 1)
    mem = _rand((1, h // 8, w // 8, c.ch_m), h + 2)

    y_j, z_j = _j(jmodel, v, "analysis", jnp.asarray(x), jnp.asarray(ctx),
                  QP)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x),
                                   torch.from_numpy(ctx), QP)
    _close(y_t, y_j)
    assert z_t.dtype == torch.int8
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))

    yh, yw = y_j.shape[1], y_j.shape[2]
    prior_j = _j(jmodel, v, "prior0", z_j, jnp.asarray(mem), QP, yh, yw)
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        prior_t = tmodel.prior0(torch.from_numpy(np.array(z_j)),
                                torch.from_numpy(mem), QP, yh, yw)
        spctx = torch.from_numpy(np.array(prior_j[4]))
        steps_t = [tmodel.prior_step(spctx, torch.from_numpy(y_hat), k)
                   for k in (1, 2, 3)]
        feat_t = tmodel.synthesis_feature(torch.from_numpy(y_hat),
                                          torch.from_numpy(ctx), QP)
        frames_t = tmodel.recon_frames(feat_t, QP, h, w)
    for got, want in zip(prior_t, prior_j):
        _close(got, want)
    for k, got in zip((1, 2, 3), steps_t):
        _close(got, _j(jmodel, v, "prior_step", prior_j[4],
                       jnp.asarray(y_hat), k))
    feat_j = _j(jmodel, v, "synthesis_feature", jnp.asarray(y_hat),
                jnp.asarray(ctx), QP)
    _close(feat_t, feat_j)
    # the JAX frames are packed rows (F, h, w * 3): the same bytes
    frames_j = np.asarray(_j(jmodel, v, "recon_frames", feat_j, QP, h, w))
    assert frames_t.shape == (c.frame_delay, h, w, 3)
    np.testing.assert_allclose(frames_t.numpy(),
                               frames_j.reshape(frames_t.shape), rtol=0,
                               atol=X_HAT_ATOL)


def test_separate_prior_video_infer_matches_jax():
    params = _rand((1, 3, 5, 3 * 8), 9, -2.0, 2.0)
    got = common.separate_prior_video_infer(torch.from_numpy(params))
    want = jax_separate_prior_video_infer(jnp.asarray(params))
    assert got[1].dtype == torch.float32
    assert float(got[1].min()) == 0.5        # the lower bound bites
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_init_is_seeded():
    a, b = DMCHT(TINY_HT_CONFIG), DMCHT(TINY_HT_CONFIG)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    dw = a.recon_head.conv1[0][0].dc[2].weight
    assert 0 < float(dw.std()) < 0.05          # N(0, 0.02), as in the JAX
    assert torch.all(a.q_feature == 1.0)
