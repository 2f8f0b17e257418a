"""Port parity, DMCI model: the stage methods of dcvc_tpu_torch's DMCI
against dcvc_tpu's flax DMCI at TINY_CONFIG, float32 on the CPU, on the
same weights (through the bridge) and inputs.

z_int8 must be exact.  Float outputs must agree within 1e-5 of each
tensor's largest magnitude: the same f32 sums taken in another order
through up to nine blocks, where random weights grow the prior's
activations to ~1e5-1e6 (the largest difference seen was ~6e-7 of that).
The reconstruction is a clamp to [-0.5, 0.5] of decoder activations far
larger than that range, so it is held to an absolute 1e-4 instead (0.03
of an 8-bit level; seen: 3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.common import q_ladder_init
from dcvc_tpu.models.dmci import DMCI as JaxDMCI
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax

REL = 1e-5
X_HAT_ATOL = 1e-4
QP = 3


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL * scale


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDMCI(cfg=JAX_TINY, dtype=jnp.float32)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(lambda r1, r2: jmodel.init({"params": r1}, x0, 0, r2))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"]
    tmodel = DMCI(TINY_CONFIG)
    tmodel.load_state_dict(dmci_params_from_jax(params))
    return jmodel, {"params": params}, tmodel.eval()


def test_state_dict_keys_match_bridge(models):
    _, variables, tmodel = models
    assert set(dmci_params_from_jax(variables["params"])) == \
        set(tmodel.state_dict())


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_stages_match_flax(models, h, w):
    jmodel, v, tmodel = models
    x = np.random.default_rng(h).uniform(-0.5, 0.5, (1, h, w, 3)).astype(
        np.float32)
    y_j, z_j = jmodel.apply(v, jnp.asarray(x), QP, method=JaxDMCI.analysis)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x), QP)
    _close(y_t, y_j)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    assert z_t.dtype == torch.int8

    yh, yw = y_j.shape[1], y_j.shape[2]
    s_j, m_j, ctx_j = jmodel.apply(v, z_j, yh, yw, method=JaxDMCI.prior0)
    z = torch.from_numpy(np.array(z_j))
    ctx = torch.from_numpy(np.array(ctx_j))
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        s_t, m_t, ctx_t = tmodel.prior0(z, yh, yw)
        steps = [tmodel.prior_step(ctx, torch.from_numpy(y_hat), k)
                 for k in (1, 2, 3)]
        x_t = tmodel.synthesis(torch.from_numpy(y_hat), QP, h, w)
    for got, want in ((s_t, s_j), (m_t, m_j), (ctx_t, ctx_j)):
        _close(got, want)
    for k, (s_t, m_t) in zip((1, 2, 3), steps):
        s_j, m_j = jmodel.apply(v, ctx_j, jnp.asarray(y_hat), k,
                                method=JaxDMCI.prior_step)
        _close(s_t, s_j)
        _close(m_t, m_j)
    x_j = jmodel.apply(v, jnp.asarray(y_hat), QP, h, w,
                       method=JaxDMCI.synthesis)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=X_HAT_ATOL)


def test_q_ladder_matches_jax():
    for lo, hi, inv in ((0.5, 2.0, False), (0.3, 3.0, True)):
        want = q_ladder_init(lo, hi, inverse=inv)(None, (8, 5))
        got = common.q_ladder_init(lo, hi, 8, 5, inverse=inv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_init_is_seeded():
    a, b = DMCI(TINY_CONFIG), DMCI(TINY_CONFIG)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    w = a.enc.enc_1.dc[0].weight.detach()
    assert 0 < float(w.std()) < 1
