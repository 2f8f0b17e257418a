"""DCVC-TCM P-frame codec runtime (counterpart of dcvc_tpu/runtime/
tcm_codec.py; reference DCVC-family/DCVC-TCM/src/models/video_net_dmc.py:
315-380): one-shot dense coding, no spatial steps.

Stream order z_mv, mv_y, z, y, one bitstream from the host's indexed rANS
coder (rans.IndexedRans*), every grid coded whole in CHW order: z and
z_mv under their one-row bitparm banks, y and mv_y under the 256-level
laplace table, each position's CDF row from the device's build_indexes
(a bucketize against the f32 thresholds of entropy/legacy.py).  Every
tensor a symbol decision or the reconstruction depends on comes from the
model's stages shared by the encoder and the decoder (mv_prior,
mv_synthesis, mc, ctx_prior, synthesis); only integer tensors (z and the
y residuals, int16) cross from one to the other, each with its shape's
default strides (dcvc_codec.canonical: torch's convs pick their
algorithm, and round, by strides).  On the card set_deterministic() turns
TF32 off and makes cuDNN deterministic.  Frames are RGB in [0, 1], padded
to a multiple of 64 by edge replication; the DPB is a dict {ref_frame,
ref_feature}, ref_frame the cropped reconstruction padded again, and
ref_feature None until the first P frame after an intra frame is coded.
"""

import numpy as np
import torch

from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.legacy import LegacyGaussianTable, build_z_indexes, \
    legacy_bitparm_bank
from ..legacy.dcvc_tcm import DMCTCM, DMCTCMConfig
from .dcvc_codec import canonical
from .image_codec import set_deterministic


def _to_chw(t):
    """(1, H, W, C) tensor -> flat CHW numpy."""
    return t[0].permute(2, 0, 1).reshape(-1).cpu().numpy()


class DMCTCMCodec:
    """Holds the model, the CDF banks, the host coders and the DPB;
    compress / decompress one P frame against the DPB.

    params: a state_dict of DMCTCM at `cfg`.  The model runs in `dtype`
    (float32 by default, as the JAX codec) on `device`."""

    MODEL_CLS = DMCTCM
    CONFIG_CLS = DMCTCMConfig

    def __init__(self, params, cfg=None, dtype=torch.float32,
                 device="cuda"):
        set_deterministic()
        self.cfg = cfg or self.CONFIG_CLS()
        self.device = torch.device(device)
        self.dtype = dtype
        # the host coder builds its library with g++ on first import
        from .. import rans
        model = self.MODEL_CLS(self.cfg)
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
        self.model = model.to(self.device, dtype).eval()
        self._plans = {}
        self.clear_dpb()

    @classmethod
    def init_random(cls, generator=None, cfg=None, dtype=torch.float32,
                    init_scale=1.0, device="cuda"):
        """Codec with seeded random weights drawn from `generator` (a CPU
        torch.Generator; seed 0 when None; DMCTCM.reset_parameters), every
        conv and deconv kernel times init_scale, as the JAX codec damps
        its kernels."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = cfg or cls.CONFIG_CLS()
        model = cls.MODEL_CLS(cfg)
        model.reset_parameters(generator)
        model.damp_(init_scale)
        return cls(model.state_dict(), cfg=cfg, dtype=dtype, device=device)

    # ---------------------------------------------------------- DPB state

    def clear_dpb(self):
        self.dpb = {"ref_frame": None, "ref_feature": None}

    def set_ref_frame(self, frame, h=None, w=None):
        """Seed the DPB with an intra reconstruction (1, H, W, 3) in
        [0, 1] (a numpy array or a tensor); the feature is cleared."""
        frame = torch.as_tensor(frame).to(self.device, torch.float32)
        h = frame.shape[1] if h is None else h
        w = frame.shape[2] if w is None else w
        self.dpb = {"ref_frame": canonical(self._pad_x(self._plan(h, w),
                                                       frame)),
                    "ref_feature": None}

    # -------------------------------------------------------------- stages

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            pad_r, pad_b = get_padding_size(h, w, 64)
            ph, pw = h + pad_b, w + pad_r
            self._plans[(h, w)] = {"h": h, "w": w, "pad": (pad_b, pad_r),
                                   "y": (ph // 16, pw // 16),
                                   "z": (ph // 64, pw // 64)}
        return self._plans[(h, w)]

    @staticmethod
    def _pad_x(p, x):
        return pad_replicate_nhwc(x, *p["pad"])

    def _idx(self, scales):
        return self.gauss.build_indexes(scales.contiguous()).to(
            torch.uint8)

    @staticmethod
    def _quant(y, means):
        """Encoder-only: round(y - means) clipped to +-30000, int16."""
        return canonical(torch.clamp(torch.round(y - means), -30000,
                                     30000).to(torch.int16))

    def _motion(self, mv_y_q, mv_means):
        """Shared: mv synthesis and motion compensation -> (c1, c2, c3)."""
        mv_hat = self.model.mv_synthesis(mv_y_q.float() + mv_means)
        return self.model.mc(self.dpb["ref_frame"], self.dpb["ref_feature"],
                             mv_hat)

    def _finish(self, p, y_q, means, ctx):
        """Shared: synthesis and the DPB update; returns x_hat (1, h, w,
        3)."""
        x_hat, feature = self.model.synthesis(y_q.float() + means, *ctx)
        x_hat = x_hat[:, :p["h"], :p["w"]]
        self.dpb = {"ref_frame": canonical(self._pad_x(p, x_hat)),
                    "ref_feature": feature}
        return x_hat

    # -------------------------------------------------------------- encode

    @torch.inference_mode()
    def compress(self, x, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor.  Returns dict(bit_stream, x_hat); x_hat is a float32
        tensor on the codec's device, and the DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        m = self.model
        xp = self._pad_x(p, x)

        mv_y, mv_z_int = m.mv_analysis(xp, self.dpb["ref_frame"])
        mv_z_int = canonical(mv_z_int)
        mv_scales, mv_means = m.mv_prior(mv_z_int)
        mv_y_q = self._quant(mv_y, mv_means)
        ctx = self._motion(mv_y_q, mv_means)
        y, z_int = m.ctx_analysis(xp, *ctx)
        z_int = canonical(z_int)
        scales, means = m.ctx_prior(z_int, *ctx)
        y_q = self._quant(y, means)
        x_hat = self._finish(p, y_q, means, ctx)

        # stream order: z_mv, mv_y, z, y (video_net_dmc.py:321-341)
        zh, zw = p["z"]
        z_idx = build_z_indexes(0, self.cfg.ch_n, zh, zw)
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(_to_chw(mv_z_int), z_idx, self.g_zmv)
        enc.encode_with_indexes(
            _to_chw(mv_y_q), _to_chw(self._idx(mv_scales)).astype(np.int16),
            self.g_y)
        enc.encode_with_indexes(_to_chw(z_int), z_idx, self.g_z)
        enc.encode_with_indexes(
            _to_chw(y_q), _to_chw(self._idx(scales)).astype(np.int16),
            self.g_y)
        enc.flush()
        return {"bit_stream": enc.get_encoded_stream(), "x_hat": x_hat}

    # -------------------------------------------------------------- decode

    @torch.inference_mode()
    def decompress(self, bit_stream, h, w):
        """Returns dict(x_hat): (1, h, w, 3) float32 in [0, 1], a tensor on
        the codec's device; the DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        p = self._plan(h, w)
        (yh, yw), (zh, zw) = p["y"], p["z"]
        cfg, m, dec = self.cfg, self.model, self.decoder
        z_idx = build_z_indexes(0, cfg.ch_n, zh, zw)
        dec.set_stream(bit_stream)

        def grid(flat, gh, gw, ch):
            """Decoded CHW symbols -> a (1, gh, gw, ch) int16 tensor."""
            arr = np.asarray(flat, np.int16).reshape(ch, gh, gw)
            return canonical(torch.from_numpy(
                arr.transpose(1, 2, 0)[None].copy()).to(self.device))

        def decode_y(scales, ch):
            idx = _to_chw(self._idx(scales)).astype(np.int16)
            return grid(dec.decode_stream(idx, self.g_y), yh, yw, ch)

        mv_z_int = grid(dec.decode_stream(z_idx, self.g_zmv), zh, zw,
                        cfg.ch_n)
        mv_scales, mv_means = m.mv_prior(mv_z_int)
        ctx = self._motion(decode_y(mv_scales, cfg.ch_mv), mv_means)
        z_int = grid(dec.decode_stream(z_idx, self.g_z), zh, zw, cfg.ch_n)
        scales, means = m.ctx_prior(z_int, *ctx)
        y_q = decode_y(scales, cfg.ch_m)
        return {"x_hat": self._finish(p, y_q, means, ctx)}
