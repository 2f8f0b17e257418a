"""Bitstream runtimes of the vendored CompressAI I-frame codecs,
cheng2020-anchor and bmshj2018-hyperprior, the DCVC / TCM baseline intra
path (counterpart of dcvc_tpu/runtime/compressai_codec.py; reference
DCVC-family/DCVC/src/models/priors.py:327-418, 546-680).

The split is the JAX codec's:
  * every CNN transform (g_a, h_a, h_s, g_s) runs on the codec's device,
    shared by the encoder and the decoder; only integer latents (y, z)
    cross from one to the other, so both derive the same priors (on the
    card set_deterministic() turns TF32 off and makes cuDNN
    deterministic; the latents enter the shared transforms with their
    shapes' default strides, dcvc_codec.canonical);
  * entropy coding runs on the host through the indexed rANS coder, in
    the reference's dense CHW symbol order (entropy_models.py:89-121):
    z under the EntropyBottleneck's per-channel bank (symbols round(z -
    medians), channel-id indexes), y under the 64-level gaussian bank
    (entropy/compressai.py);
  * cheng2020's joint AR context model runs as the serial HostAR loop on
    the host (runtime/dcvc_codec.py; the reference's own documented slow
    path, priors.py:546-552), y symbols in raster order, channel-minor.

Streams are the reference's two strings {y_string, z_string}; the
containers wrap them (bitstream/legacy_container.py dcvc_encode_i).
Frames are RGB in [0, 1], padded to 64 by edge replication.
"""

import numpy as np
import torch

from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.compressai import build_indexes, compressai_gaussian_bank, \
    compressai_scale_table, eb_bank
from ..legacy.compressai_zoo import CHENG2020_Q1_3, BMSHJ2018_Q1_5, \
    Cheng2020Anchor, Cheng2020Config, HyperpriorConfig, ScaleHyperprior
from .dcvc_codec import HostAR, canonical, flax_kernel
from .image_codec import set_deterministic


def _chw(x):
    """(1, H, W, C) tensor -> its CHW flatten as float32 numpy (the
    reference's order)."""
    return x[0].permute(2, 0, 1).reshape(-1).float().cpu().numpy()


class _CompressAIBase:
    """The z path (EntropyBottleneck), the gaussian bank and the host
    coders.

    params: a state_dict of the class's MODEL_CLS at `cfg` (a CONFIG_CLS),
    the EntropyBottleneck's parameters included.  The model runs in
    `dtype` (float32 by default, as the JAX codec) on `device`."""

    MODEL_CLS = None
    CONFIG_CLS = None
    DEFAULT_CFG = None

    def __init__(self, params, cfg=None, dtype=torch.float32,
                 device="cuda"):
        set_deterministic()
        self.cfg = cfg or self.DEFAULT_CFG
        self.device = torch.device(device)
        self.dtype = dtype
        # the host coder builds its library with g++ on first import
        from .. import rans
        model = self.MODEL_CLS(self.cfg)
        model.load_state_dict(params)
        self.eb_params = model.entropy_bottleneck.params()
        z_cdf, z_len, z_off, self.z_medians = eb_bank(self.eb_params)
        self.scale_table = compressai_scale_table()
        y_cdf, y_len, y_off = compressai_gaussian_bank(self.scale_table)
        self.encoder = rans.IndexedRansEncoder()
        self.decoder = rans.IndexedRansDecoder()
        for coder in (self.encoder, self.decoder):
            self.g_y = coder.add_cdf(y_cdf, y_len, y_off)
            self.g_z = coder.add_cdf(z_cdf, z_len, z_off)
        self._host_init(model)
        self.model = model.to(self.device, dtype).eval()
        self._plans = {}

    def _host_init(self, model):
        """Host state derived from the model's weights (cheng2020's AR)."""

    @classmethod
    def init_random(cls, generator=None, cfg=None, dtype=torch.float32,
                    device="cuda"):
        """Codec with seeded random weights drawn from `generator` (a CPU
        torch.Generator; seed 0 when None; the model's reset_parameters),
        undamped, as the JAX codec's init_random draws them."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = cfg or cls.DEFAULT_CFG
        model = cls.MODEL_CLS(cfg)
        model.reset_parameters(generator)
        return cls(model.state_dict(), cfg=cfg, dtype=dtype, device=device)

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            pad_r, pad_b = get_padding_size(h, w, 64)
            ph, pw = h + pad_b, w + pad_r
            self._plans[(h, w)] = {"h": h, "w": w, "pad": (pad_b, pad_r),
                                   "y": (ph // 16, pw // 16),
                                   "z": (ph // 64, pw // 64)}
        return self._plans[(h, w)]

    def _analysis(self, x, h, w):
        """-> (plan, y float32, z float32) of x (1, H, W, 3)."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        y = self.model.g_a(pad_replicate_nhwc(x, *p["pad"]).to(self.dtype))
        return p, y.float(), self.model.h_a(y).float()

    def _prior(self, z_hat):
        """h_s of z_hat, float32: the scales (hyperprior) or the params
        (cheng2020)."""
        return self.model.h_s(z_hat.to(self.dtype)).float()

    def _synthesis(self, p, y_hat):
        x_hat = self.model.g_s(y_hat.to(self.dtype))
        return torch.clamp(x_hat.float(), 0.0, 1.0)[:, :p["h"], :p["w"]]

    def _to_device(self, arr):
        return canonical(torch.from_numpy(arr[None]).to(self.device))

    def _encode_z(self, z):
        """EntropyBottleneck.compress (entropy_models.py:377-381): symbols
        round(z - medians) per channel, channel-id indexes.  Returns
        (z_string, z_hat on the device)."""
        zc = z[0].permute(2, 0, 1).cpu().numpy()        # (C, zh, zw)
        c, zh, zw = zc.shape
        med = self.z_medians[:, None, None]
        symbols = np.round(zc - med).astype(np.int16)
        idx = np.repeat(np.arange(c, dtype=np.int16), zh * zw)
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(symbols.reshape(-1), idx, self.g_z)
        enc.flush()
        z_hat = (symbols.astype(np.float32) + med).transpose(1, 2, 0)
        return enc.get_encoded_stream(), self._to_device(z_hat)

    def _decode_z(self, z_string, p):
        (zh, zw), c = p["z"], self.z_medians.shape[0]
        idx = np.repeat(np.arange(c, dtype=np.int16), zh * zw)
        self.decoder.set_stream(z_string)
        symbols = self.decoder.decode_stream(idx, self.g_z)
        z_hat = symbols.reshape(c, zh, zw).astype(np.float32) \
            + self.z_medians[:, None, None]
        return self._to_device(z_hat.transpose(1, 2, 0))


class HyperpriorCodec(_CompressAIBase):
    """bmshj2018-hyperprior (priors.py:327-349): scales-only dense
    gaussian coding of y, factorized z."""

    MODEL_CLS = ScaleHyperprior
    CONFIG_CLS = HyperpriorConfig
    DEFAULT_CFG = BMSHJ2018_Q1_5

    def _indexes(self, scales):
        return build_indexes(_chw(scales), self.scale_table).astype(
            np.int16)

    @torch.inference_mode()
    def compress(self, x, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor.  Returns dict(y_string, z_string, x_hat); x_hat is a
        float32 tensor on the codec's device."""
        p, y, z = self._analysis(x, h, w)
        y_round = canonical(torch.round(y))
        z_string, z_hat = self._encode_z(z)
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(_chw(y_round).astype(np.int16),
                                self._indexes(self._prior(z_hat)), self.g_y)
        enc.flush()
        return {"y_string": enc.get_encoded_stream(), "z_string": z_string,
                "x_hat": self._synthesis(p, y_round)}

    @torch.inference_mode()
    def decompress(self, y_string, z_string, h, w):
        p = self._plan(h, w)
        (yh, yw), m = p["y"], self.cfg.M
        idx = self._indexes(self._prior(self._decode_z(z_string, p)))
        self.decoder.set_stream(y_string)
        symbols = self.decoder.decode_stream(idx, self.g_y)
        y_hat = symbols.astype(np.float32).reshape(m, yh, yw) \
            .transpose(1, 2, 0)
        return {"x_hat": self._synthesis(p, self._to_device(y_hat))}


class Cheng2020Codec(_CompressAIBase):
    """cheng2020-anchor (priors.py:546-680): factorized z and the serial
    masked-conv AR gaussian coding of y on the host."""

    MODEL_CLS = Cheng2020Anchor
    CONFIG_CLS = Cheng2020Config
    DEFAULT_CFG = CHENG2020_Q1_3

    def _host_init(self, model):
        def f32(t):
            return t.detach().float().cpu().numpy()
        ep = {f"layers_{i * 2}": {
            "kernel": flax_kernel(getattr(model, f"ep_layers_{i}")),
            "bias": f32(getattr(model, f"ep_layers_{i}").bias)}
            for i in range(3)}
        adapter = {"ar": {"kernel": f32(model.context_prediction_kernel),
                          "bias": f32(model.context_prediction_bias)},
                   "ep": ep}
        self.ar = HostAR(adapter, "ar", "ep", scales_first=True)

    @torch.inference_mode()
    def compress(self, x, h=None, w=None):
        """As HyperpriorCodec.compress."""
        p, y, z = self._analysis(x, h, w)
        z_string, z_hat = self._encode_z(z)
        y_q, scales, y_hat = self.ar.encode(
            y[0].cpu().numpy(), self._prior(z_hat)[0].cpu().numpy())
        idx = build_indexes(scales, self.scale_table).astype(np.int16)
        enc = self.encoder
        enc.reset()
        # the reference's symbol order: raster scan, channel-minor
        # (priors.py:595-609 extends per-position channel vectors)
        enc.encode_with_indexes(y_q.reshape(-1), idx.reshape(-1), self.g_y)
        enc.flush()
        return {"y_string": enc.get_encoded_stream(), "z_string": z_string,
                "x_hat": self._synthesis(p, self._to_device(y_hat))}

    @torch.inference_mode()
    def decompress(self, y_string, z_string, h, w):
        p = self._plan(h, w)
        prior = self._prior(self._decode_z(z_string, p))
        dec = self.decoder
        dec.set_stream(y_string)

        def decode_vec(sc):
            idx = build_indexes(sc, self.scale_table).astype(np.int16)
            return dec.decode_stream(idx, self.g_y)

        y_hat = self.ar.decode(prior[0].cpu().numpy(), decode_vec)
        return {"x_hat": self._synthesis(p, self._to_device(y_hat))}
