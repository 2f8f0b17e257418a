"""Port parity, the DCVC-FM layer zoo and EVC's blocks: every layer of
dcvc_tpu_torch/legacy/fm_layers.py and the EVC blocks of legacy/evc.py
against dcvc_tpu's flax modules, float32 on the CPU, on the flax init's
weights (through the bridge) and seeded inputs, within atol = rtol =
2e-5.

UNet2's kernels are damped by 0.5: at flax's init its eleven blocks of
residual FFNs lift the output to ~1e2, where an element of ~1 is below
float32's rounding of the two frameworks' sums (as the codec tests damp
their kernels).

The grids are odd or not square where a layer pads: flax's SAME padding
of the strided 1x1 and 2x2 convs comes to 0 on one side and 1 on the
other there, and the k x k convs pad k // 2.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import evc as jevc
from dcvc_tpu.legacy import fm_layers as jfm
from dcvc_tpu_torch.legacy import evc, fm_layers as fm
from dcvc_tpu_torch.utils.jax_bridge import evc_params_from_jax, \
    intra_noar_params_from_jax

TOL = 2e-5

# name: (flax module, port module, input channels, (h, w))
MIRRORED = {
    "convk3": (lambda: jfm.ConvK(6), lambda: fm.ConvK(4, 6), 4, (7, 10)),
    "convk3_s2": (lambda: jfm.ConvK(6, stride=2),
                  lambda: fm.ConvK(4, 6, stride=2), 4, (7, 10)),
    "convk1": (lambda: jfm.ConvK(6, kernel=1), lambda: fm.ConvK(4, 6, 1),
               4, (5, 6)),
    "convk1_s2": (lambda: jfm.ConvK(6, kernel=1, stride=2),
                  lambda: fm.ConvK(4, 6, 1, 2), 4, (7, 9)),
    "convk5": (lambda: jfm.ConvK(3, kernel=5), lambda: fm.ConvK(4, 3, 5),
               4, (6, 9)),
    "subpel3": (lambda: jfm.SubpelConv(5), lambda: fm.SubpelConv(4, 5),
                4, (3, 5)),
    "subpel1_r4": (lambda: jfm.SubpelConv(3, r=4, kernel=1),
                   lambda: fm.SubpelConv(8, 3, r=4, kernel=1), 8, (3, 4)),
    "resblock": (lambda: jfm.ResBlockFM(8, slope=0.2),
                 lambda: fm.ResBlockFM(8, slope=0.2), 8, (6, 5)),
    "rbws_s2": (lambda: jfm.ResidualBlockWithStrideFM(8),
                lambda: fm.ResidualBlockWithStrideFM(4, 8), 4, (9, 6)),
    "rbws_s1": (lambda: jfm.ResidualBlockWithStrideFM(8, stride=1),
                lambda: fm.ResidualBlockWithStrideFM(4, 8, stride=1), 4,
                (5, 6)),
    "rbws_id": (lambda: jfm.ResidualBlockWithStrideFM(4, stride=1),
                lambda: fm.ResidualBlockWithStrideFM(4, 4, stride=1), 4,
                (5, 6)),
    "rbu": (lambda: jfm.ResidualBlockUpsampleFM(6),
            lambda: fm.ResidualBlockUpsampleFM(8, 6), 8, (4, 5)),
    "depthconv": (lambda: jfm.DepthConvFM(12), lambda: fm.DepthConvFM(8, 12),
                  8, (5, 7)),
    "depthconv_id": (lambda: jfm.DepthConvFM(8),
                     lambda: fm.DepthConvFM(8, 8), 8, (5, 7)),
    "convffn": (lambda: jfm.ConvFFNFM(), lambda: fm.ConvFFNFM(8), 8, (4, 6)),
    "convffn_capped": (lambda: jfm.ConvFFNFM(), lambda: fm.ConvFFNFM(320),
                       320, (2, 3)),
    "convffn3": (lambda: jfm.ConvFFN3FM(), lambda: fm.ConvFFN3FM(8), 8,
                 (4, 6)),
    "dcb": (lambda: jfm.DepthConvBlockFM(16),
            lambda: fm.DepthConvBlockFM(8, 16), 8, (6, 4)),
    "dcb4": (lambda: jfm.DepthConvBlock4FM(16),
             lambda: fm.DepthConvBlock4FM(8, 16), 8, (6, 4)),
    "unet2": (lambda: jfm.UNet2(8), lambda: fm.UNet2(6, 8), 6, (8, 12)),
}
DAMPED = {"unet2": 0.5}


def _x(ch, hw, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (2,) + hw + (ch,)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_layer_matches_flax(name):
    jctor, tctor, ch, hw = MIRRORED[name]
    x = _x(ch, hw, len(name))
    jm = jctor()
    params = jm.init({"params": jax.random.PRNGKey(len(name))},
                     jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: leaf * (DAMPED.get(name, 1.0)
                                if p[-1].key == "kernel" else 1.0), params)
    tm = tctor()
    tm.load_state_dict(intra_noar_params_from_jax(params))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply({"params": params},
                                                 jnp.asarray(x)))


@pytest.mark.parametrize("slope", [0.01, 0.1, 0.2])
def test_lrelu_matches_flax(slope):
    x = _x(3, (4, 5), 1)
    np.testing.assert_array_equal(
        fm.lrelu(torch.from_numpy(x), slope).numpy(),
        np.asarray(jfm.lrelu(jnp.asarray(x), slope)))


@pytest.mark.parametrize("hw", [(4, 6), (8, 2)])
def test_max_pool_matches_flax(hw):
    x = _x(5, hw, 2)
    np.testing.assert_array_equal(
        fm.max_pool_2x(torch.from_numpy(x)).numpy(),
        np.asarray(jfm.max_pool_2x(jnp.asarray(x))))


# EVC's blocks, named after key_fn_evc's keys: (flax module, port module,
# input channels, (h, w), the flax scope and key prefix they sit under)
EVC_BLOCKS = {
    "dcb": (lambda: jevc.EVCDepthConvBlock(12),
            lambda: evc.EVCDepthConvBlock(8, 12), 8, (5, 6),
            ("enc", "layers_1"), "enc.1."),
    "dcb_unwrapped": (lambda: jevc.EVCDepthConvBlock(8),
                      lambda: evc.EVCDepthConvBlock(8, 8, wrapped=False), 8,
                      (5, 6), ("encs_0", "layers_1"), "encs_0.1."),
    "dcb_stride2": (lambda: jevc.EVCDepthConvBlock(12, stride=2),
                    lambda: evc.EVCDepthConvBlock(8, 12, stride=2), 8,
                    (7, 10), ("enc", "layers_1"), "enc.1."),
    "rbws": (lambda: jevc.EVCResidualBlockWithStride(8),
             lambda: evc.EVCResidualBlockWithStride(3, 8), 3, (9, 6),
             ("enc", "layers_0"), "enc.0."),
    "rbu": (lambda: jevc.EVCResidualBlockUpsample(6),
            lambda: evc.EVCResidualBlockUpsample(8, 6), 8, (3, 5),
            ("dec", "layers_1"), "dec.1."),
    "hyper_dcb": (lambda: jevc.EVCHyperDCB(16),
                  lambda: evc.EVCHyperDCB(8, 16), 8, (4, 5),
                  ("y_prior_fusion", "layers_0"), "y_prior_fusion.0."),
    "hyper_up": (lambda: jevc.EVCHyperBlockUpsample(8),
                 lambda: evc.EVCHyperBlockUpsample(8, 8), 8, (3, 4),
                 ("hyper_dec", "layers_0"), "hyper_dec.0."),
}


@pytest.mark.parametrize("name", sorted(EVC_BLOCKS))
def test_evc_block_matches_flax(name):
    jctor, tctor, ch, hw, scope, prefix = EVC_BLOCKS[name]
    x = _x(ch, hw, len(name) + 10)
    jm = jctor()
    params = jm.init({"params": jax.random.PRNGKey(len(name))},
                     jnp.asarray(x))["params"]
    state = evc_params_from_jax({scope[0]: {scope[1]: params}})
    assert all(k.startswith(prefix) for k in state)
    tm = tctor()
    tm.load_state_dict({k[len(prefix):]: t for k, t in state.items()})
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply({"params": params},
                                                 jnp.asarray(x)))
