"""DCVC (NeurIPS'21 baseline) P-frame codec runtime with the serial AR
coding on the host (counterpart of dcvc_tpu/runtime/dcvc_codec.py;
reference DCVC-family/DCVC/src/models/DCVC_net.py:257-414).

The model's entropy model is a PixelCNN-style masked-conv autoregression:
each latent position's Laplace parameters depend on the already-decoded
neighbours, so the coding is serial.  The split is the JAX codec's:

  * every CNN stage (flow, encoders, priors, motion compensation,
    synthesis) runs on the codec's device, the encoder and the decoder
    calling the same stage code;
  * the AR loop runs on the HOST in float32 numpy (HostAR, a verbatim
    copy of the JAX package's, pinned by tests/test_torch_dcvc_codec.py)
    -- the reference's documented slow path (DCVC_net.py:257-330).  The
    encoder and the decoder run the same host code on the same inputs
    (the priors the device computed from the same integer latents; on the
    card set_deterministic() turns TF32 off and makes cuDNN
    deterministic; every tensor that enters the shared stages has its
    shape's default strides, `canonical`), so a round trip is bit-exact.

Streams: four rANS strings (mv_z, mv_y, z, y) from the host's indexed
coder, as the reference's compress result (DCVC_net.py:372-385): z and
mv_z under their one-row bitparm banks in CHW order, y and mv_y under
the 256-level laplace table in the reference's channel-last (h, w, c)
order, the CDF row of each position's scales from build_indexes_np on
the host.  Frames are RGB in [0, 1], padded to 64 by edge replication;
the reference frame is the previous reconstruction, re-padded.
"""

import numpy as np
import torch

from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.legacy import LegacyGaussianTable, build_z_indexes, \
    legacy_bitparm_bank
from ..legacy.dcvc_net import DCVC_CONFIG, DCVCNet
from .image_codec import set_deterministic


def _lrelu(x, slope=0.01):
    return np.where(x >= 0, x, slope * x)


class HostAR:
    """Serial masked-conv AR over one latent plane (host, float32).

    Mirrors DCVC_net.compress_ar/decompress_ar: per position, a type-A
    5x5 masked conv over the padded y_hat window feeds the 1x1
    entropy-parameter chain together with the (temporal+hyper) prior
    params; means/scales follow."""

    def __init__(self, params, ar_scope, ep_scope, scales_first=False):
        """scales_first: the cheng2020 prior emits (scales, means) halves
        (priors.py:501 chunk order) where DCVC emits (means, scales)."""
        ar = params[ar_scope]
        k = np.asarray(ar["kernel"], np.float32)        # (5, 5, C, 2C)
        mask = np.ones(k.shape[:2] + (1, 1), np.float32)
        mask[k.shape[0] // 2, k.shape[1] // 2:] = 0
        mask[k.shape[0] // 2 + 1:] = 0
        self.kernel = k * mask
        self.bias = np.asarray(ar["bias"], np.float32)
        ep = params[ep_scope]
        self.ep = [(np.asarray(ep[f"layers_{i}"]["kernel"], np.float32)
                    .reshape(ep[f"layers_{i}"]["kernel"].shape[-2:]),
                    np.asarray(ep[f"layers_{i}"]["bias"], np.float32))
                   for i in (0, 2, 4)]
        self.ksize = k.shape[0]
        self.scales_first = scales_first

    def _params_at(self, window, prior_vec):
        """window: (5, 5, C) padded y_hat crop; prior_vec: (Cp,)."""
        ctx = np.einsum("ijc,ijcd->d", window, self.kernel) + self.bias
        v = np.concatenate([prior_vec, ctx])
        for i, (w, b) in enumerate(self.ep):
            v = v @ w + b
            if i < 2:
                v = _lrelu(v)
        c = v.shape[0] // 2
        if self.scales_first:
            return v[c:], v[:c]  # means, scales
        return v[:c], v[c:]  # means, scales

    def encode(self, y, prior):
        """y, prior: (H, W, C*) f32.  Returns (y_q int16 (H,W,C),
        scales (H,W,C), y_hat (H,W,C))."""
        hh, ww, cc = y.shape
        pad = self.ksize // 2
        y_hat = np.zeros((hh + 2 * pad, ww + 2 * pad, cc), np.float32)
        y_q = np.zeros((hh, ww, cc), np.int16)
        scales = np.zeros((hh, ww, cc), np.float32)
        for h in range(hh):
            for w in range(ww):
                means, sc = self._params_at(
                    y_hat[h:h + self.ksize, w:w + self.ksize], prior[h, w])
                q = np.round(y[h, w] - means).astype(np.float32)
                y_hat[h + pad, w + pad] = q + means
                y_q[h, w] = np.clip(q, -30000, 30000).astype(np.int16)
                scales[h, w] = sc
        return y_q, scales, y_hat[pad:pad + hh, pad:pad + ww]

    def decode(self, prior, decode_vec):
        """decode_vec(scales (C,)) -> decoded residual ints (C,)."""
        hh, ww = prior.shape[:2]
        cc = self.bias.shape[0] // 2
        pad = self.ksize // 2
        y_hat = np.zeros((hh + 2 * pad, ww + 2 * pad, cc), np.float32)
        for h in range(hh):
            for w in range(ww):
                means, sc = self._params_at(
                    y_hat[h:h + self.ksize, w:w + self.ksize], prior[h, w])
                q = decode_vec(sc).astype(np.float32)
                y_hat[h + pad, w + pad] = q + means
        return y_hat[pad:pad + hh, pad:pad + ww]


def canonical(t):
    """t with the default strides of its shape.  A size-1 dimension's
    stride is free in torch, and a conv may take another algorithm (and
    round otherwise) by it, so every tensor the encoder or the decoder
    hands to the shared stages is made so."""
    return t.clone(memory_format=torch.contiguous_format)


def flax_kernel(conv):
    """A conv's weight (O, I, kh, kw) as the flax kernel (kh, kw, I, O),
    float32 numpy in C order (as the JAX codec's arrays are: numpy's
    product rounds by the operands' layout)."""
    return np.ascontiguousarray(
        conv.weight.detach().float().cpu().permute(2, 3, 1, 0).numpy())


def host_ar_params(ar, ep):
    """{"ar": {kernel, bias}, "ep": {layers_0 / _2 / _4: {kernel, bias}}}
    of a masked conv `ar` (a MaskedConv2d) and a 1x1 entropy-parameter
    chain `ep` (its convs at indexes 0, 2, 4), in the flax layout HostAR
    reads."""
    def leaf(conv):
        return {"kernel": flax_kernel(conv),
                "bias": conv.bias.detach().float().cpu().numpy()}
    return {"ar": leaf(ar),
            "ep": {f"layers_{i}": leaf(getattr(ep, f"layers_{i}"))
                   for i in (0, 2, 4)}}


class DCVCCodec:
    """Holds the model, the CDF banks, the host coders and the reference
    frame; compress / decompress one P frame against it.

    params: a state_dict of DCVCNet at `cfg`.  The model runs in `dtype`
    (float32 by default, as the JAX codec) on `device`."""

    def __init__(self, params, cfg=None, dtype=torch.float32,
                 device="cuda"):
        set_deterministic()
        self.cfg = cfg or DCVC_CONFIG
        self.device = torch.device(device)
        self.dtype = dtype
        # the host coder builds its library with g++ on first import
        from .. import rans
        model = DCVCNet(self.cfg)
        model.load_state_dict(params)
        self.gauss = LegacyGaussianTable("laplace")
        y_cdf, y_len, y_off = self.gauss.compute_cdf_bank()
        z_bank = legacy_bitparm_bank(model.bit_estimator_z.bank(), 1,
                                     self.cfg.ch_n)
        zmv_bank = legacy_bitparm_bank(model.bit_estimator_z_mv.bank(), 1,
                                       self.cfg.ch_n)
        self.encoder = rans.IndexedRansEncoder()
        self.decoder = rans.IndexedRansDecoder()
        for coder in (self.encoder, self.decoder):
            self.g_y = coder.add_cdf(y_cdf, y_len, y_off)
            self.g_z = coder.add_cdf(*z_bank)
            self.g_zmv = coder.add_cdf(*zmv_bank)
        self.ar_y = HostAR(host_ar_params(model.auto_regressive,
                                          model.entropy_parameters),
                           "ar", "ep")
        self.ar_mv = HostAR(host_ar_params(model.auto_regressive_mv,
                                           model.entropy_parameters_mv),
                            "ar", "ep")
        self.model = model.to(self.device, dtype).eval()
        self._plans = {}
        self.ref_frame = None

    @classmethod
    def init_random(cls, generator=None, cfg=None, dtype=torch.float32,
                    init_scale=1.0, device="cuda"):
        """Codec with seeded random weights drawn from `generator` (a CPU
        torch.Generator; seed 0 when None; DCVCNet.reset_parameters), every
        conv, deconv and masked-conv kernel times init_scale, as the JAX
        codec damps its kernels."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = cfg or DCVC_CONFIG
        model = DCVCNet(cfg)
        model.reset_parameters(generator)
        model.damp_(init_scale)
        return cls(model.state_dict(), cfg=cfg, dtype=dtype, device=device)

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            pad_r, pad_b = get_padding_size(h, w, 64)
            ph, pw = h + pad_b, w + pad_r
            self._plans[(h, w)] = {"h": h, "w": w, "pad": (pad_b, pad_r),
                                   "z": (ph // 64, pw // 64)}
        return self._plans[(h, w)]

    @staticmethod
    def _pad_x(p, x):
        return pad_replicate_nhwc(x, *p["pad"])

    def set_ref_frame(self, frame, h=None, w=None):
        """The reference frame: an intra reconstruction (1, H, W, 3) in
        [0, 1] (a numpy array or a tensor), padded to 64."""
        frame = torch.as_tensor(frame).to(self.device, torch.float32)
        h = frame.shape[1] if h is None else h
        w = frame.shape[2] if w is None else w
        self.ref_frame = canonical(self._pad_x(self._plan(h, w), frame))

    def _synthesis(self, p, y_hat, context):
        x_hat = self.model.synthesis(y_hat, context)[:, :p["h"], :p["w"]]
        self.ref_frame = canonical(self._pad_x(p, x_hat))
        return x_hat

    def _to_device(self, arr):
        return canonical(torch.from_numpy(arr[None]).to(self.device))

    def _encode_plane(self, ar, y, prior):
        y_q, scales, y_hat = ar.encode(y[0].cpu().numpy(),
                                       prior[0].cpu().numpy())
        idx = self.gauss.build_indexes_np(scales).astype(np.int16)
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(y_q.reshape(-1), idx.reshape(-1), self.g_y)
        enc.flush()
        return enc.get_encoded_stream(), self._to_device(y_hat)

    def _encode_z(self, z_int, group):
        zh, zw = z_int.shape[1:3]
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(
            z_int[0].permute(2, 0, 1).reshape(-1).cpu().numpy(),
            build_z_indexes(0, self.cfg.ch_n, zh, zw), group)
        enc.flush()
        return enc.get_encoded_stream()

    def _decode_z(self, string, group, p):
        (zh, zw), ch = p["z"], self.cfg.ch_n
        self.decoder.set_stream(string)
        z = self.decoder.decode_stream(build_z_indexes(0, ch, zh, zw), group)
        return self._to_device(z.reshape(ch, zh, zw).transpose(1, 2, 0))

    def _decode_plane(self, ar, string, prior):
        dec, g_y = self.decoder, self.g_y
        dec.set_stream(string)

        def decode_vec(sc):
            idx = self.gauss.build_indexes_np(sc).astype(np.int16)
            return dec.decode_stream(idx, g_y)
        return self._to_device(ar.decode(prior[0].cpu().numpy(), decode_vec))

    # -------------------------------------------------------------- encode

    @torch.inference_mode()
    def compress(self, x, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor.  Returns dict(mv_z_string, mv_y_string, z_string,
        y_string, x_hat); x_hat is a float32 tensor on the codec's device,
        and the next reference frame."""
        if self.ref_frame is None:
            raise RuntimeError("DCVCCodec: no reference frame")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        m = self.model
        xp = self._pad_x(p, x)

        mv_y, mv_z_int = m.mv_analysis(xp, self.ref_frame)
        mv_z_int = canonical(mv_z_int)
        mv_z_str = self._encode_z(mv_z_int, self.g_zmv)
        mv_y_str, mv_y_hat = self._encode_plane(self.ar_mv, mv_y,
                                                m.mv_prior(mv_z_int))
        context, temporal = m.mv_synthesis(mv_y_hat, self.ref_frame)
        y, z_int = m.ctx_analysis(xp, context)
        z_int = canonical(z_int)
        z_str = self._encode_z(z_int, self.g_z)
        y_str, y_hat = self._encode_plane(
            self.ar_y, y, torch.cat([temporal, m.ctx_prior(z_int)], dim=-1))
        return {"mv_z_string": mv_z_str, "mv_y_string": mv_y_str,
                "z_string": z_str, "y_string": y_str,
                "x_hat": self._synthesis(p, y_hat, context)}

    # -------------------------------------------------------------- decode

    @torch.inference_mode()
    def decompress(self, mv_y_string, mv_z_string, y_string, z_string,
                   h, w):
        """Returns dict(x_hat): (1, h, w, 3) float32 in [0, 1], a tensor on
        the codec's device, and the next reference frame."""
        if self.ref_frame is None:
            raise RuntimeError("DCVCCodec: no reference frame")
        p = self._plan(h, w)
        m = self.model
        mv_z_int = self._decode_z(mv_z_string, self.g_zmv, p)
        mv_y_hat = self._decode_plane(self.ar_mv, mv_y_string,
                                      m.mv_prior(mv_z_int))
        context, temporal = m.mv_synthesis(mv_y_hat, self.ref_frame)
        z_int = self._decode_z(z_string, self.g_z, p)
        y_hat = self._decode_plane(
            self.ar_y, y_string,
            torch.cat([temporal, m.ctx_prior(z_int)], dim=-1))
        return {"x_hat": self._synthesis(p, y_hat, context)}
