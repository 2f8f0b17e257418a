"""The vendored CompressAI image codecs of the DCVC / TCM baseline I-frame
path, cheng2020-anchor and bmshj2018-hyperprior (counterpart of
dcvc_tpu/legacy/compressai_zoo.py; reference DCVC-family/DCVC/src/models/
waseda.py:28-95, priors.py:200-488, layers.py:50-152).  RGB in [0, 1]
(the CompressAI convention), NHWC.

The module tree mirrors the flax one: the transforms' list entries are
the children `g_a_layers_{i}`, `g_s_layers_{i}`, `h_a_layers_{i}`,
`h_s_layers_{i}` (cheng2020 also `ep_layers_{i}`), residual blocks hold
`conv1` / `conv2` / `gdn` / `downsample` / `subpel_conv` / `conv` /
`igdn` / `upsample`, and cheng2020's masked context conv is the two
explicit leaves `context_prediction_kernel` (5, 5, N, 2N, the flax
layout) and `context_prediction_bias`, which runtime/compressai_codec.py
hands to its host AR.  Transposed convs are legacy/dcvc_net.py's Deconv
(torch ConvTranspose2d's layout).  Each model also holds its
EntropyBottleneck's parameters (`entropy_bottleneck.matrix_0`, ...,
`quantiles`: the JAX codec's eb_params, beside the model's parameters),
so that a state_dict carries the whole codec; utils/jax_bridge.py maps
the pair to the JAX params.v1 tree {"params", "eb_params"}.  A reference
.pth.tar loads through from_reference (key_fn_hyperprior /
key_fn_cheng2020 and import_entropy_bottleneck, utils/keys.py).

The stage methods (g_a, h_a, h_s, g_s, entropy_parameters, _masked_conv)
are the codecs'; forward() is the estimation forward on rounded
latents.
"""

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.compressai import eb_init_params
from ..utils.keys import import_entropy_bottleneck, key_fn_cheng2020, \
    key_fn_hyperprior
from .dcvc_net import Deconv, SubpelConv3x3, _conv, init_legacy_, \
    type_a_mask
from .fm_layers import lrelu
from .gdn import GDN


class ResidualBlock(nn.Module):
    """layers.py:128-152: conv3-lrelu-conv3-lrelu + identity."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3)
        self.conv2 = _conv(ch, ch, 3)

    def forward(self, x):
        return x + lrelu(self.conv2(lrelu(self.conv1(x))))


class ResidualBlockWithStride(nn.Module):
    """layers.py:68-100: conv3s2-lrelu-conv3-GDN + 1x1s2 shortcut."""

    def __init__(self, in_ch, out_ch, stride=2):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3, stride)
        self.conv2 = _conv(out_ch, out_ch, 3)
        self.gdn = GDN(out_ch)
        self.downsample = _conv(in_ch, out_ch, 1, stride) if stride != 1 \
            else None

    def forward(self, x):
        h = self.gdn(self.conv2(lrelu(self.conv1(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + h


class ResidualBlockUpsample(nn.Module):
    """layers.py:102-126: subpel-lrelu-conv3-IGDN + subpel shortcut."""

    def __init__(self, in_ch, out_ch, r=2):
        super().__init__()
        self.subpel_conv = SubpelConv3x3(in_ch, out_ch, r)
        self.conv = _conv(out_ch, out_ch, 3)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = SubpelConv3x3(in_ch, out_ch, r)

    def forward(self, x):
        h = self.igdn(self.conv(lrelu(self.subpel_conv(x))))
        return self.upsample(x) + h


class EntropyBottleneck(nn.Module):
    """The EntropyBottleneck's parameters (entropy_models.py:221-265) in
    the torch shapes, named as the JAX codec's eb_params: matrix_i,
    bias_i, factor_i, quantiles (C, 1, 3).  The codec builds its CDF bank
    from them on the host (entropy/compressai.py eb_bank)."""

    def __init__(self, channels, filters=(3, 3, 3, 3)):
        super().__init__()
        self.channels, self.filters = channels, filters
        for k, v in eb_init_params(channels, filters).items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v)))

    @torch.no_grad()
    def reset_parameters(self):
        """eb_init_params's values (its own numpy seed)."""
        for k, v in eb_init_params(self.channels, self.filters).items():
            getattr(self, k).copy_(torch.from_numpy(v))

    def params(self):
        """The eb_params dict: float32 numpy arrays."""
        return {k: p.detach().float().cpu().numpy()
                for k, p in self.named_parameters()}


@dataclasses.dataclass(frozen=True)
class HyperpriorConfig:
    N: int = 128
    M: int = 192


# quality 1-5 use (128, 192); 6-8 use (192, 320) (CompressAI zoo)
BMSHJ2018_Q1_5 = HyperpriorConfig(128, 192)
BMSHJ2018_Q6_8 = HyperpriorConfig(192, 320)
TINY_HYPERPRIOR = HyperpriorConfig(16, 24)


@dataclasses.dataclass(frozen=True)
class Cheng2020Config:
    N: int = 128


CHENG2020_Q1_3 = Cheng2020Config(128)
CHENG2020_Q4_6 = Cheng2020Config(192)
TINY_CHENG2020 = Cheng2020Config(16)


class _CompressAIModel(nn.Module):
    """The transforms as named list children `{scope}_layers_{i}` and the
    EntropyBottleneck; _run's `act(x, i, n)` is the activation after
    entry i of n (None: none)."""

    def _add(self, scope, layers):
        for i, layer in enumerate(layers):
            setattr(self, f"{scope}_layers_{i}", layer)
        setattr(self, f"_{scope}_n", len(layers))

    def _run(self, scope, x, act=None):
        n = getattr(self, f"_{scope}_n")
        for i in range(n):
            x = getattr(self, f"{scope}_layers_{i}")(x)
            if act is not None:
                x = act(x, i, n)
        return x

    def g_a(self, x):
        return self._run("g_a", x)

    def g_s(self, y):
        return self._run("g_s", y)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model
        (dcvc_net.init_legacy_: lecun-normal kernels, zero biases, GDN at
        its own init), the EntropyBottleneck at eb_init_params (its own
        seed, as the JAX codec's init_random).  Draws from `generator`."""
        init_legacy_(self, generator)
        self.entropy_bottleneck.reset_parameters()

    def _from_reference(self, state, key_fn):
        """A reference state_dict -> this model's: each flax path's
        reference key (key_fn; conv and ConvTranspose2d weights keep their
        torch layouts), the EntropyBottleneck by import_entropy_bottleneck;
        the reference's other EntropyBottleneck / GaussianConditional
        tensors (coder tables, reparametrizers) and `.mask` buffers are
        dropped.  Keys no parameter maps from are left for the caller to
        report."""
        state = dict(state)
        out = {f"entropy_bottleneck.{k}": torch.from_numpy(v.copy())
               for k, v in import_entropy_bottleneck(state).items()}
        for key in self.state_dict():
            segs = key.split(".")
            if segs[0] == "entropy_bottleneck":
                continue
            path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(
                segs[-1], segs[-1]),)
            ref = key_fn(path)
            if isinstance(ref, tuple):           # ("deconv", key)
                ref = ref[1]
            if ref in state:
                out[key] = state.pop(ref)
        if "context_prediction_kernel" in out:   # (2N, N, 5, 5) -> flax
            out["context_prediction_kernel"] = \
                out["context_prediction_kernel"].permute(2, 3, 1, 0)
        out.update({k: v for k, v in state.items()
                    if not k.startswith(("entropy_bottleneck.",
                                         "gaussian_conditional."))
                    and "reparam" not in k and not k.endswith(".mask")})
        return out


class ScaleHyperprior(_CompressAIModel):
    """bmshj2018-hyperprior (priors.py:200-349): a scales-only gaussian
    conditional over a factorized hyper-latent."""

    def __init__(self, cfg=BMSHJ2018_Q1_5):
        super().__init__()
        self.cfg = cfg
        N, M = cfg.N, cfg.M
        self._add("g_a", [_conv(3, N, 5, 2), GDN(N), _conv(N, N, 5, 2),
                          GDN(N), _conv(N, N, 5, 2), GDN(N),
                          _conv(N, M, 5, 2)])
        self._add("g_s", [Deconv(M, N, 5, 2), GDN(N, inverse=True),
                          Deconv(N, N, 5, 2), GDN(N, inverse=True),
                          Deconv(N, N, 5, 2), GDN(N, inverse=True),
                          Deconv(N, 3, 5, 2)])
        self._add("h_a", [_conv(M, N, 3, 1), _conv(N, N, 5, 2),
                          _conv(N, N, 5, 2)])
        self._add("h_s", [Deconv(N, N, 5, 2), Deconv(N, N, 5, 2),
                          _conv(N, M, 3, 1)])
        self.entropy_bottleneck = EntropyBottleneck(N)

    def from_reference(self, state):
        return self._from_reference(state, key_fn_hyperprior)

    def h_a(self, y):
        return self._run("h_a", torch.abs(y),
                         lambda x, i, n: torch.relu(x) if i < n - 1 else x)

    def h_s(self, z_hat):
        return self._run("h_s", z_hat, lambda x, i, n: torch.relu(x))

    def forward(self, x):
        """The estimation forward on rounded latents (priors.py:256-267):
        x_hat and the y / z values and the scales."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, y_hat = torch.round(z), torch.round(y)
        return {"x_hat": self.g_s(y_hat), "y": y, "y_hat": y_hat, "z": z,
                "z_hat": z_hat, "scales_hat": self.h_s(z_hat)}


def _lrelu_between(x, i, n):
    return lrelu(x) if i < n - 1 else x


class Cheng2020Anchor(_CompressAIModel):
    """cheng2020-anchor (waseda.py:28-95): residual-block transforms and
    the joint autoregressive hierarchical prior (priors.py:421-488).  The
    masked context conv is evaluated densely here; the serial AR of the
    bitstream runs on the host (runtime/compressai_codec.py)."""

    def __init__(self, cfg=CHENG2020_Q1_3):
        super().__init__()
        self.cfg = cfg
        N = cfg.N
        self._add("g_a", [
            ResidualBlockWithStride(3, N), ResidualBlock(N),
            ResidualBlockWithStride(N, N), ResidualBlock(N),
            ResidualBlockWithStride(N, N), ResidualBlock(N),
            _conv(N, N, 3, 2)])
        self._add("h_a", [_conv(N, N, 3, 1), _conv(N, N, 3, 1),
                          _conv(N, N, 3, 2), _conv(N, N, 3, 1),
                          _conv(N, N, 3, 2)])
        self._add("h_s", [
            _conv(N, N, 3, 1), SubpelConv3x3(N, N, 2),
            _conv(N, N * 3 // 2, 3, 1), SubpelConv3x3(N * 3 // 2,
                                                      N * 3 // 2, 2),
            _conv(N * 3 // 2, N * 2, 3, 1)])
        self._add("g_s", [
            ResidualBlock(N), ResidualBlockUpsample(N, N),
            ResidualBlock(N), ResidualBlockUpsample(N, N),
            ResidualBlock(N), ResidualBlockUpsample(N, N),
            ResidualBlock(N), SubpelConv3x3(N, 3, 2)])
        # context_prediction: the 5x5 type-A masked conv N -> 2N, its
        # kernel in the flax layout for the host AR
        self.context_prediction_kernel = nn.Parameter(
            torch.zeros(5, 5, N, 2 * N))
        self.context_prediction_bias = nn.Parameter(torch.zeros(2 * N))
        self._add("ep", [_conv(N * 4, N * 10 // 3, 1),
                         _conv(N * 10 // 3, N * 8 // 3, 1),
                         _conv(N * 8 // 3, N * 2, 1)])
        self.entropy_bottleneck = EntropyBottleneck(N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """As _CompressAIModel's, the context kernel drawn last
        (lecun-normal over fan_in 5 * 5 * N), its bias zero."""
        super().reset_parameters(generator)
        k = self.context_prediction_kernel
        std = float(np.sqrt(1.0 / (25 * k.shape[2]))) / 0.87962566103423978
        nn.init.trunc_normal_(k, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.context_prediction_bias.zero_()

    def from_reference(self, state):
        return self._from_reference(state, key_fn_cheng2020)

    def h_a(self, y):
        return self._run("h_a", y, _lrelu_between)

    def h_s(self, z_hat):
        return self._run("h_s", z_hat, _lrelu_between)

    def entropy_parameters(self, v):
        return self._run("ep", v, _lrelu_between)

    def _masked_conv(self, y_hat):
        """The dense type-A masked 5x5 conv (layers.py:21-47): only
        already-decoded neighbours contribute."""
        k = self.context_prediction_kernel
        w = (k * type_a_mask(5).to(k)[:, :, None, None]).permute(3, 2, 0, 1)
        y = F.conv2d(y_hat.permute(0, 3, 1, 2), w, padding=2)
        return y.permute(0, 2, 3, 1) + self.context_prediction_bias

    def forward(self, x):
        """The estimation forward on rounded latents (priors.py:488-510)."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, y_hat = torch.round(z), torch.round(y)
        params = self.h_s(z_hat)
        gp = self.entropy_parameters(torch.cat(
            [params, self._masked_conv(y_hat)], dim=-1))
        scales_hat, means_hat = gp.chunk(2, dim=-1)
        return {"x_hat": self.g_s(y_hat), "y": y, "y_hat": y_hat, "z": z,
                "z_hat": z_hat, "scales_hat": scales_hat,
                "means_hat": means_hat}
