"""Port parity, EVC's mask-decay training: dcvc_tpu_torch.train.mask_decay
against dcvc_tpu.train.mask_decay at TINY_EVC_CONFIG, float32 on the CPU,
from the port's seeded weights (bridged to flax by evc_params_to_jax) and
numpy-seeded inputs and gates.  The conv kernels are damped by 0.7, as
tests/test_torch_evc.py's (at 1.0 the TINY x_hat reaches ~60 and the two
frameworks' float32 sums drift apart by ~4e-4), and the biases drawn
from N(0, 0.05^2): with the init's zero biases and a z_hat of zeros, the
hyper decoder's activations are exactly 0, where torch's leaky_relu
takes the slope as its gradient and flax's takes 1.

- the sites: the port's mask_sites are JAX's, key for key and width for
  width (against jax.eval_shape of the flax model's init);
- the folded forward of seeded gates: x_hat and bpp within
  atol = rtol = 2e-5 of the flax model's on fold_masks' params (the
  tolerance of tests/test_torch_evc.py's training forward);
- a zero gate is the hard-pruned channel: bit-exact against the model
  with that conv1 output channel's weights and bias zeroed;
- two steps of make_mask_decay_step against JAX's, each from the same
  state (the port's model, AdamW state and gates set to JAX's after the
  first, through utils/jax_status.load_into): loss within 1e-5
  (relative), the parameters by test_torch_train_step.params_close (its
  AdamW tolerance, the sign test on AdamW's new first moment) after each
  step, the gates within rtol 1e-5 + atol 1e-6;
- sparsity_report and prune_masks equal JAX's.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import evc as jevc
from dcvc_tpu.train import mask_decay as jmd
from dcvc_tpu.train.step import make_optimizer
from dcvc_tpu_torch.legacy.evc import EVC, TINY_EVC_CONFIG
from dcvc_tpu_torch.train import mask_decay as md
from dcvc_tpu_torch.utils.jax_bridge import evc_params_from_jax, \
    evc_params_to_jax
from dcvc_tpu_torch.utils.jax_status import load_into
from test_torch_train_step import params_close



@pytest.fixture(autouse=True)
def no_onednn():
    """torch 2.13.0+cpu's oneDNN convolution corrupts the heap (a glibc
    abort) in about half of the backward passes of EVC's strided residual
    block (enc.2, 8 -> 8 channels at 32x32) with several intra-op threads;
    torch's own convolutions do not."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield
TOL = 2e-5
LR = 1e-4
LAM, DECAY = 0.1, 3.0


@pytest.fixture(scope="module")
def models():
    model = EVC(TINY_EVC_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(0.7)
            elif name.endswith(".bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    # copies: a zero-copy jax array would alias the model's parameters
    params = jax.tree.map(lambda t: jnp.array(t.numpy()),
                          evc_params_to_jax(model.state_dict()))
    return model, jevc.EVC(cfg=jevc.TINY_EVC_CONFIG, dtype=jnp.float32), \
        params


def image(seed, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, 64, 64, 3)) \
        .astype(np.float32)


def seeded_masks(model, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.0, 1.5, c).astype(np.float32)
            for k, c in ((("/".join(p)), c) for p, c in
                         md.mask_sites(model))}


def test_sites_match_jax(models):
    model, jmodel, params = models
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3))))
    want = sorted(("/".join(p), c) for p, c in
                  jmd.mask_sites(shapes["params"]))
    got = [("/".join(p), c) for p, c in md.mask_sites(model)]
    assert sorted(got) == want
    # the bridged tree walks in the port's order
    assert [("/".join(p), c) for p, c in jmd.mask_sites(params)] == got
    assert len(got) >= 15
    assert set(md.init_masks(model)) == set(jmd.init_masks(params))


def test_folded_forward_matches_jax(models):
    model, jmodel, params = models
    masks = seeded_masks(model, 1)
    x = image(2)
    want = jmodel.apply({"params": jmd.fold_masks(
        params, {k: jnp.asarray(v) for k, v in masks.items()})},
        jnp.asarray(x))
    with torch.no_grad():
        got = md.folded_forward(model, {k: torch.from_numpy(v) for k, v in
                                        masks.items()}, torch.from_numpy(x))
    for key in ("x_hat", "bpp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL)
    # all-ones gates fold to the model itself
    with torch.no_grad():
        ones = md.folded_forward(model, md.init_masks(model),
                                 torch.from_numpy(x))
        plain = model(torch.from_numpy(x))
    assert torch.equal(ones["x_hat"], plain["x_hat"])


def test_zero_gate_is_the_hard_prune(models):
    model, _, _ = models
    x = torch.from_numpy(image(3))
    masks = md.init_masks(model)
    keys = md.conv1_keys(model)
    for site in sorted(masks)[:3]:
        masks[site][[0, 3]] = 0.0
    pruned = EVC(TINY_EVC_CONFIG)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for site in sorted(masks)[:3]:
        for key in keys[site]:
            if key is not None:
                state[key][[0, 3]] = 0.0
    pruned.load_state_dict(state)
    with torch.no_grad():
        got = md.folded_forward(model, masks, x)
        want = pruned(x)
    for key in ("x_hat", "bpp"):
        assert torch.equal(got[key], want[key]), key


def test_two_steps_match_jax(models):
    model, jmodel, params = models
    tmodel = EVC(TINY_EVC_CONFIG)
    tmodel.load_state_dict(model.state_dict())
    x = image(4)
    tx = make_optimizer(LR, clip_norm=0.1)
    state = jmd.create_mask_decay_state(params, tx)
    jmasks = jmd.init_masks(params)
    jstep = jax.jit(jmd.make_mask_decay_step(jmodel, tx, LAM, DECAY))
    opt = md.create_mask_decay_state(tmodel, LR, 0.1)
    step = md.make_mask_decay_step(tmodel, opt, LAM, DECAY)
    masks = md.init_masks(tmodel)
    for i in range(2):
        if i:   # from JAX's state after the first step
            load_into(tmodel, opt, {"epoch": 0, "params": state.params,
                                    "opt_state": flax.serialization
                                    .to_state_dict(state.opt_state)})
            masks = {k: torch.from_numpy(np.array(v)) for k, v in
                     jmasks.items()}
        state, jmasks, want = jstep(state, jmasks, jnp.asarray(x))
        masks, got = step(masks, torch.from_numpy(x))
        assert not got["skipped"]
        for k in ("loss", "mse", "bpp"):
            g, w = float(got[k]), float(want[k])
            assert abs(g - w) <= 1e-5 * abs(w), (k, g, w)
        # AdamW's new first moment, in gradient units: the step's sign
        mu = {k: v / 0.1 for k, v in evc_params_from_jax(
            state.opt_state[1][0].mu).items()}
        params_close(tmodel, evc_params_from_jax(state.params), mu)
        for k, m in masks.items():
            np.testing.assert_allclose(m.numpy(), np.asarray(jmasks[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # the decay moved every gate down
    assert all(float(m.max()) < 1.0 for m in masks.values())


def test_sparsity_report_and_prune_match_jax(models):
    model, _, _ = models
    masks = seeded_masks(model, 6)
    for thresh in (0.02, 0.4):
        want = jmd.sparsity_report({k: jnp.asarray(v) for k, v in
                                    masks.items()}, thresh)
        got = md.sparsity_report({k: torch.from_numpy(v) for k, v in
                                  masks.items()}, thresh)
        assert got == want
        pw = jmd.prune_masks({k: jnp.asarray(v) for k, v in masks.items()},
                             thresh)
        pg = md.prune_masks({k: torch.from_numpy(v) for k, v in
                             masks.items()}, thresh)
        for k in masks:
            assert np.array_equal(pg[k].numpy(), np.asarray(pw[k])), k
