"""Port parity, the training steps: dcvc_tpu_torch.train against
dcvc_tpu.train on the CPU in float32 at the TINY configs, from the same
weights, batch and noise.

- the optimizer: optax.chain(clip_by_global_norm, adamw) against
  train.step.Optimizer on given gradients, over two updates, the clip
  taken and not taken;
- one image step (make_image_train_step, DMCI, uint8 batch of 2 at mixed
  qps) and one 2-chunk video step (make_video_train_step, DMC-LD here,
  DMC-HTS in tests/test_torch_train_step_ht.py), cascaded and not,
  rematerialised and not: loss, metrics and grad_norm within 1e-5 of
  JAX's (relative), and the parameters after the step within PARAM_TOL;
- the non-finite skip: a NaN in the batch leaves the parameters and
  AdamW's state (moments and step counts) as they were.

PARAM_TOL: at AdamW's first step an element moves by lr * g / (|g| +
eps), about lr * sign(g), whatever |g| is.  Where |g| (JAX's, clipped) is at least
SIGN_SHARE of its tensor's peak and 100 eps (below that, eps takes a
share of the step that depends on |g|), the two gradients agree in sign
and the
parameters must agree within 1e-6 of the tensor's peak |p| plus 1e-4 lr
(optax takes its bias corrections 1 - b**t in f32, 1.3e-5 off at t = 1);
below that share the signs may differ, and the parameters agree within
2 lr plus that.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvc_tpu.models.dmc_ld import DMCLD as JaxDMCLD
from dcvc_tpu.models.dmc_ld import TINY_LD_CONFIG as JAX_TINY_LD
from dcvc_tpu.models.dmci import DMCI as JaxDMCI
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu.runtime.video_codec import _init_both_branches
from dcvc_tpu.train.step import create_train_state, make_image_train_step, \
    make_optimizer
from dcvc_tpu.train.video_step import make_video_train_step
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.train.step import Optimizer, image_train_step
from dcvc_tpu_torch.train.video_step import video_train_step
from dcvc_tpu_torch.utils.jax_bridge import dmc_ld_params_from_jax, \
    dmci_params_from_jax
from test_torch_train import SCALE, damp, jax_noise, to_torch

LR = 1e-4
EPS = 1e-8          # AdamW's and optax's eps
SIGN_SHARE = 1e-3
QP = np.array([1, 6], np.int32)
METRIC_REL = 1e-5


def u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def metrics_close(got, want, keys):
    for k in keys:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= METRIC_REL * max(abs(w), 1e-6), (k, g, w)
    assert got["skipped"] is False and not bool(want["skipped"])


def clipped_grads(state, bridge):
    """JAX's clipped gradients of a first step, from AdamW's first moment
    (mu = (1 - b1) g after one update), in the port's keys."""
    return {k: v / (1 - 0.9) for k, v in bridge(state.opt_state[1][0].mu)
            .items()}


def params_close(model, want_state, grads, lr=LR):
    """The port's parameters against the bridged JAX params after a step
    (see PARAM_TOL in the module docstring); grads: JAX's clipped ones."""
    n_sign = 0
    for name, p in model.named_parameters():
        want = want_state[name].numpy()
        g = np.abs(grads[name].numpy())
        err = np.abs(p.detach().numpy() - want)
        tight = 1e-6 * float(np.abs(want).max()) + 1e-4 * lr
        sure = g >= max(SIGN_SHARE * g.max(), 100 * EPS)
        assert float(err[sure].max(initial=0)) <= tight, name
        assert float(err.max()) <= 2 * lr + tight, name
        n_sign += int((err > tight).sum())
    return n_sign


def test_optimizer_matches_optax():
    """Two updates with the clip taken (norm above max) and not."""
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: np.random.default_rng(i).standard_normal(s).astype(
        np.float32) for i, (k, s) in enumerate(shapes.items())}
    tx = make_optimizer(1e-3, clip_norm=0.5)
    state = tx.init(params)
    jp = dict(params)
    model = torch.nn.Module()
    for k, v in params.items():
        setattr(model, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = Optimizer(model, 1e-3, 0.5)
    for step, scale in enumerate([3.0, 0.01]):
        grads = {k: scale * np.random.default_rng(10 + step + i)
                 .standard_normal(s).astype(np.float32)
                 for i, (k, s) in enumerate(shapes.items())}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in shapes:
            getattr(model, k).grad = torch.from_numpy(grads[k].copy())
        norm, skipped = opt.step()
        assert not skipped
        assert abs(float(norm) - float(optax.global_norm(grads))) <= \
            1e-6 * float(norm)
        # within 2 f32 ulps of p plus 1e-4 of the step: optax takes its
        # bias corrections 1 - b**t in f32 (1 - 0.999**2 is off by 3e-5
        # of itself), AdamW in float64
        for k in shapes:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=2.5e-7,
                                       atol=1e-4 * 1e-3)


# ---------------------------------------------------------- image step

@pytest.fixture(scope="module")
def dmci():
    jmodel = JaxDMCI(cfg=JAX_TINY, dtype=jnp.float32)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(lambda r1, r2: jmodel.init(
        {"params": r1}, x0, jnp.zeros((1,), jnp.int32), r2))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"]
    return jmodel, damp(params)


def port_dmci(params):
    model = DMCI(TINY_CONFIG)
    model.load_state_dict(dmci_params_from_jax(params))
    return model


def test_image_step_matches_jax(dmci):
    jmodel, params = dmci
    lambdas = common.get_training_lambdas([8.0, 256.0], TINY_CONFIG.qp_num) \
        .astype(np.float32)
    x = u8((2, 64, 64, 3), 1)
    rng = jax.random.PRNGKey(7)
    tx = make_optimizer(LR, clip_norm=0.1)
    step = jax.jit(make_image_train_step(jmodel, tx, lambdas))
    state, want = step(create_train_state(params, tx), jnp.asarray(x),
                       jnp.asarray(QP), rng)
    model = port_dmci(params)
    opt = Optimizer(model, LR, 0.1)
    noise = to_torch(jax_noise(rng, common.noise_shapes(TINY_CONFIG, 2, 64,
                                                         64)))
    got = image_train_step(model, opt, torch.from_numpy(x),
                           torch.from_numpy(QP).long(),
                           torch.from_numpy(lambdas), noise)
    metrics_close(got, want, ("loss", "mse", "bpp", "bits_y", "bits_z",
                              "grad_norm"))
    assert float(got["grad_norm"]) > 0.1      # the clip was taken
    params_close(model, dmci_params_from_jax(state.params),
                 clipped_grads(state, dmci_params_from_jax))
    assert set(opt.adamw.state) and all(
        int(s["step"]) == 1 for s in opt.adamw.state.values())


def test_non_finite_step_is_skipped(dmci):
    """A NaN in the batch: skipped, and the parameters and AdamW's state
    (moments, step counts) untouched; the next finite step proceeds."""
    _, params = dmci
    lambdas = torch.from_numpy(common.get_training_lambdas(
        [8.0, 256.0], TINY_CONFIG.qp_num).astype(np.float32))
    model = port_dmci(params)
    opt = Optimizer(model, LR, 0.1)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(2, 64, 64, 3, generator=gen) - 0.5
    qp = torch.from_numpy(QP).long()
    image_train_step(model, opt, x, qp, lambdas, gen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in opt.adamw.state.items()}
    bad = x.clone()
    bad[1, 5, 7, 0] = float("nan")
    got = image_train_step(model, opt, bad, qp, lambdas, gen)
    assert got["skipped"] is True
    assert not torch.isfinite(got["grad_norm"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in opt.adamw.state.items():
        for k, v in s.items():
            assert torch.equal(v, state[id(p)][k]), k
    assert all(p.grad is None for p in model.parameters())
    got = image_train_step(model, opt, x, qp, lambdas, gen)
    assert got["skipped"] is False
    assert all(int(s["step"]) == 2 for s in opt.adamw.state.values())


# ----------------------------------------------------------- video step

def video_models(jcls, jcfg):
    jmodel = jcls(cfg=jcfg, dtype=jnp.float32)
    params = _init_both_branches(
        jmodel, jnp.zeros((1, 64, 64, 3 * jcfg.frame_delay), jnp.float32),
        jnp.zeros((1, 8, 8, 192), jnp.float32),
        jnp.zeros((1, 8, 8, jcfg.ch_d), jnp.float32),
        jnp.zeros((1, 8, 8, jcfg.ch_m), jnp.float32),
        jax.random.PRNGKey(0), init_scale=SCALE)
    return jmodel, params


def video_step_matches_jax(jmodel, params, tmodel, bridge, cascaded,
                           use_remat, n_chunks=2, b=2, h=64, w=64):
    """make_video_train_step against video_train_step on one batch: a
    seed frame in [-0.5, 0.5] and n uint8 chunks."""
    cfg = tmodel.cfg
    lambdas = common.get_training_lambdas([4.0, 64.0], cfg.qp_num) \
        .astype(np.float32)
    seed = np.random.default_rng(11).uniform(-0.5, 0.5, (b, h, w, 3)) \
        .astype(np.float32)
    chunks = u8((b, n_chunks, h, w, 3 * cfg.frame_delay), 12)
    rng = jax.random.PRNGKey(9)
    tx = make_optimizer(LR, clip_norm=0.2)
    step = make_video_train_step(jmodel, tx, lambdas, n_chunks,
                                 cascaded=cascaded, use_remat=use_remat)
    args = (jnp.asarray(seed), jnp.asarray(chunks), jnp.asarray(QP))
    state, want = jax.jit(step)(create_train_state(params, tx), *args, rng)

    tmodel.load_state_dict(bridge(params))
    opt = Optimizer(tmodel, LR, 0.2)
    noise = [to_torch(jax_noise(r, common.noise_shapes(cfg, b, h, w)))
             for r in jax.random.split(rng, n_chunks)]
    got = video_train_step(tmodel, opt, torch.from_numpy(seed),
                           torch.from_numpy(chunks),
                           torch.from_numpy(QP).long(),
                           torch.from_numpy(lambdas), noise,
                           cascaded=cascaded, use_remat=use_remat)
    metrics_close(got, want, ("loss", "mse", "bpp", "grad_norm"))
    params_close(tmodel, bridge(state.params), clipped_grads(state, bridge))


@pytest.fixture(scope="module")
def ld():
    return video_models(JaxDMCLD, JAX_TINY_LD)


@pytest.mark.parametrize("use_remat", [True, False])
@pytest.mark.parametrize("cascaded", [True, False])
def test_ld_video_step_matches_jax(ld, cascaded, use_remat):
    jmodel, params = ld
    video_step_matches_jax(jmodel, params, DMCLD(TINY_LD_CONFIG),
                           dmc_ld_params_from_jax, cascaded, use_remat)
