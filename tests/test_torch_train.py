"""Port parity, training forwards and rate terms: dcvc_tpu_torch against
dcvc_tpu on the CPU in float32 at the TINY configs.

- core.quant: ste_round and lower_bound, forward and gradient, exactly
  as jax.grad of the JAX rules gives them;
- the rate terms (gaussian_prob_train, probs_to_bits, get_y_bits, the z
  prior's get_prob) within 1e-6 of the peak of JAX's, their input
  gradients within 1e-5;
- the DMCI training forward at a mixed-qp batch of 2: bits_y, bits_z,
  bpp, mse and x_hat within 1e-5 of the peak of the JAX model.apply's,
  given the uniform noise JAX draws from the same rng split;
- every parameter's gradient of the RD loss (mapped to the port's keys
  through the bridge) within GRAD_REL of that tensor's peak |gradient|
  in jax.grad: the same f32 products summed in another order, through
  the whole model and back.

The random weights are damped by SCALE (conv kernels x 0.7, as the video
codec tests damp theirs by 0.5): undamped, the TINY spatial prior's means
reach ~1e5, so y_q + means loses y to f32 cancellation and x_hat is
decided by rounding noise in both frameworks alike.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.core import quant as jquant
from dcvc_tpu.entropy import bit_estimator as jbe
from dcvc_tpu.entropy import gaussian as jgauss
from dcvc_tpu.models import common as jcommon
from dcvc_tpu.models.dmci import DMCI as JaxDMCI
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu_torch.core import quant
from dcvc_tpu_torch.entropy import bit_estimator as tbe
from dcvc_tpu_torch.entropy import gaussian as tgauss
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax

REL = 1e-5
RATE_REL = 1e-6
GRAD_REL = 1e-4
SCALE = 0.7
QP = np.array([1, 5], np.int32)
OUT_KEYS = ("bits_y", "bits_z", "bpp", "mse", "x_hat")


def close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def rand(shape, seed, lo=-0.5, hi=0.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def damp(params, scale=SCALE):
    """Conv kernels of a flax param tree x scale."""
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: leaf * scale if p[-1].key == "kernel" else leaf,
        params)


def jax_noise(rng, shapes):
    """The noise a JAX training forward draws from rng: split into y and
    z, each U(-0.5, 0.5) of its tensor's shape (core.quant.add_noise)."""
    rng_y, rng_z = jax.random.split(rng)
    return {k: np.asarray(jax.random.uniform(r, shapes[k], jnp.float32,
                                             -0.5, 0.5))
            for k, r in (("y", rng_y), ("z", rng_z))}


def to_torch(noise):
    return {k: torch.from_numpy(v.copy()) for k, v in noise.items()}


def grads_close(model, want_state, rel=GRAD_REL):
    """Every parameter's .grad against the bridged JAX gradient, within
    rel of the JAX tensor's peak; a parameter the loss does not reach has
    no gradient in the port and an exact 0 in JAX."""
    names = dict(model.named_parameters())
    assert set(names) == set(want_state)
    worst = 0.0
    for name, p in names.items():
        want = want_state[name].numpy()
        peak = float(np.abs(want).max())
        if p.grad is None:
            assert peak == 0.0, name
            continue
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= rel * peak or err == 0.0, (name, err, peak)
        worst = max(worst, err / peak if peak else 0.0)
    return worst


# ------------------------------------------------------------ quant

def test_ste_round_forward_and_gradient():
    x = rand((64,), 0, -4, 4)
    x[:4] = [0.5, 1.5, -2.5, 3.0]          # half to even, as jnp.round
    w = rand((64,), 1, -1, 1)
    want = jax.grad(lambda a: jnp.sum(jquant.ste_round(a) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = quant.ste_round(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jquant.ste_round(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("bound", [0.11, 0.5, 0.0])
def test_lower_bound_forward_and_gradient(bound):
    """The gradient passes where x >= bound or the upstream gradient is
    negative: both signs of the upstream gradient on both sides."""
    x = rand((256,), 2, -1, 1)
    x[0] = bound                            # x == bound passes
    w = rand((256,), 3, -1, 1)
    want = jax.grad(lambda a: jnp.sum(jquant.lower_bound(a, bound) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = quant.lower_bound(xt, bound)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jquant.lower_bound(x, bound)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    below = x < bound
    assert (xt.grad.numpy()[below & (w > 0)] == 0).all()
    assert (xt.grad.numpy()[below & (w < 0)] != 0).all()


def test_add_noise_takes_a_tensor_or_a_generator():
    x = torch.zeros(3, 5)
    noise = torch.full((3, 5), 0.25)
    assert torch.equal(quant.add_noise(x, noise), noise)
    a = quant.add_noise(x, torch.Generator().manual_seed(4))
    b = quant.add_noise(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5


# -------------------------------------------------------- rate terms

def test_gaussian_rate_terms_match_jax():
    """gaussian_prob_train, probs_to_bits and get_y_bits, and the input
    gradients of the bits (values, and scales across the 0.11 bound)."""
    v = rand((4, 6, 6, 16), 5, -6, 6)
    s = rand((4, 6, 6, 16), 6, 0.0, 3.0)
    s[0, 0, 0, :4] = 0.0                   # masked-out scales
    close(tgauss.gaussian_prob_train(torch.from_numpy(v),
                                     torch.from_numpy(s)),
          jgauss.gaussian_prob_train(v, s), RATE_REL)
    p = rand((1000,), 7, 0.0, 1.0)
    p[:3] = [0.0, 1e-7, 1.0]
    close(tgauss.probs_to_bits(torch.from_numpy(p)),
          jgauss.probs_to_bits(p), RATE_REL)

    def jbits(a, b):
        return jnp.sum(jcommon.get_y_bits(a, b))
    close(common.get_y_bits(torch.from_numpy(v), torch.from_numpy(s)),
          jcommon.get_y_bits(v, s), RATE_REL)
    gv, gs = jax.grad(jbits, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(s))
    vt = torch.from_numpy(v).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    common.get_y_bits(vt, st).sum().backward()
    close(vt.grad, gv)
    close(st.grad, gs)


@pytest.mark.parametrize("per_sample", [False, True])
def test_bit_estimator_prob_matches_jax(per_sample):
    """The z prior's get_prob at one qp and at per-sample qps, and its
    gradient with respect to the banks."""
    q, c = 8, 16
    bank = {k: rand((q, c, n), i, -1, 1) for i, (k, n) in
            enumerate((("h", 4), ("b", 4), ("a", 3)))}
    z = rand((3, 4, 4, c), 9, -5, 5)
    qp = np.array([0, 3, 7], np.int32) if per_sample else 4
    jbank = jbe.BitEstimator(q, c)
    want = jbank.get_prob(bank, z, jnp.asarray(qp))
    mod = common.BitEstimatorModule(q, c)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in bank.items()})
    tqp = torch.from_numpy(qp).long() if per_sample else qp
    got = mod.get_prob(torch.from_numpy(z), tqp)
    close(got, want, RATE_REL)
    close(tbe.bit_estimator_z_fwd(torch.from_numpy(z), *[
        common.select_qp(getattr(mod, k), tqp) for k in "hba"]), want,
        RATE_REL)
    gwant = jax.grad(lambda b: jnp.sum(jcommon.probs_to_bits(
        jbank.get_prob(b, z, jnp.asarray(qp)))))(bank)
    common.probs_to_bits(got).sum().backward()
    for k in "hba":
        close(getattr(mod, k).grad, gwant[k])


# ---------------------------------------------------------------- DMCI

@pytest.fixture(scope="module")
def dmci():
    jmodel = JaxDMCI(cfg=JAX_TINY, dtype=jnp.float32)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(lambda r1, r2: jmodel.init(
        {"params": r1}, x0, jnp.zeros((1,), jnp.int32), r2))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"]
    params = damp(params)
    tmodel = DMCI(TINY_CONFIG)
    tmodel.load_state_dict(dmci_params_from_jax(params))
    return jmodel, params, tmodel


def dmci_case(seed, b=2, h=64, w=64):
    x = rand((b, h, w, 3), seed)
    rng = jax.random.PRNGKey(100 + seed)
    noise = jax_noise(rng, common.noise_shapes(TINY_CONFIG, b, h, w))
    return x, rng, noise


def dmci_loss(out, lambdas, qp):
    return (lambdas[qp] * out["mse"] + out["bpp"]).mean()


@pytest.mark.parametrize("h,w", [(64, 64), (128, 64)])
def test_dmci_training_forward_matches_flax(dmci, h, w):
    jmodel, params, tmodel = dmci
    x, rng, noise = dmci_case(1, h=h, w=w)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(QP),
                        rng)
    got = tmodel(torch.from_numpy(x), torch.from_numpy(QP).long(),
                 to_torch(noise))
    for k in OUT_KEYS:
        close(got[k], want[k])
    # a forward that codes something: y symbols, a picture
    assert float(np.min(want["bits_y"])) > 10
    assert float(np.abs(want["x_hat"]).max()) > 0.1


def test_dmci_forward_at_one_qp_equals_per_sample(dmci):
    """An int qp and the same qp per sample select the same rows."""
    _, _, tmodel = dmci
    x, _, noise = dmci_case(2)
    with torch.no_grad():
        a = tmodel(torch.from_numpy(x), 3, to_torch(noise))
        b = tmodel(torch.from_numpy(x), torch.tensor([3, 3]),
                   to_torch(noise))
    for k in OUT_KEYS:
        assert torch.equal(a[k], b[k]), k


def test_dmci_gradients_match_jax(dmci):
    jmodel, params, tmodel = dmci
    x, rng, noise = dmci_case(3)
    lambdas = common.get_training_lambdas([8.0, 256.0], TINY_CONFIG.qp_num) \
        .astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(QP),
                           rng)
        return dmci_loss(out, jnp.asarray(lambdas), jnp.asarray(QP))
    want = dmci_params_from_jax(jax.jit(jax.grad(jloss))(params))
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(x), torch.from_numpy(QP).long(),
                 to_torch(noise))
    dmci_loss(out, torch.from_numpy(lambdas),
              torch.from_numpy(QP).long()).backward()
    grads_close(tmodel, want)
    tmodel.zero_grad(set_to_none=True)
