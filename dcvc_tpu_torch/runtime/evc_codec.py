"""EVC and IntraNoAR image-codec runtime (counterpart of
dcvc_tpu/runtime/evc_codec.py; reference DCVC-family/EVC/src/models/
image_model.py:131-200): the dual cross-checkerboard prior.

One stream: z, then y part 0, then y part 1, coded by the host's indexed
rANS coder (rans.IndexedRansEncoder / IndexedRansDecoder) with the
256-level gaussian scale table for y and the model's factorized z bank.
The write grids are the 2x phase terms (core/masks.py phase_terms_2x),
and a step's symbols go in the reference's dense CHW order
(runtime/fm_codec.py cand_to_chw).

The encoder and decoder call the same stage code (`_prior`, `_step0`,
`_step1`, `_synthesis`) on the same device and dtype, and only integer
tensors (z int16, y_q int16, uint8 CDF indexes) cross from one to the
other, so the decoder reproduces the encoder's priors bit for bit; on the
card set_deterministic() turns TF32 off and makes cuDNN deterministic.
The scale -> CDF row map is a compare against f32 thresholds
(entropy/legacy.py), exact on every device.  Frames are RGB in [0, 1],
padded to 64 by edge replication.
"""

import numpy as np
import torch

from ..core.masks import phase_merge, phase_split, phase_terms_2x
from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.legacy import LegacyGaussianTable, build_z_indexes, \
    legacy_bitparm_bank
from ..legacy.evc import EVC, EVCConfig
from ..legacy.fm_layers import damp_kernels_
from ..legacy.hem_intra import IntraNoAR, IntraNoARConfig
from .fm_codec import cand_to_chw, chw_to_cand
from .image_codec import set_deterministic


class EVCCodec:
    """Holds the model, the CDF banks and the host coders; compress /
    decompress one image.

    params: a state_dict of the class's MODEL_CLS at `cfg` (a
    CONFIG_CLS).  The model runs in `dtype` (float32 by default, as the
    JAX codec) on `device`."""

    MODEL_CLS = EVC
    CONFIG_CLS = EVCConfig

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
        self.gauss = LegacyGaussianTable("gaussian")  # image_model.py:18
        y_cdf, y_len, y_off = self.gauss.compute_cdf_bank()
        z_cdf, z_len, z_off = legacy_bitparm_bank(
            model.bit_estimator_z.bank(), 1, self.cfg.n)
        self.encoder = rans.IndexedRansEncoder()
        self.decoder = rans.IndexedRansDecoder()
        for coder in (self.encoder, self.decoder):
            self.g_y = coder.add_cdf(y_cdf, y_len, y_off)
            self.g_z = coder.add_cdf(z_cdf, z_len, z_off)
        self.model = model.to(self.device, dtype).eval()
        self._plans = {}

    @classmethod
    def init_random(cls, generator=None, cfg=None, dtype=torch.float32,
                    init_scale=1.0, device="cuda"):
        """Codec with seeded random weights drawn from `generator` (a CPU
        torch.Generator; seed 0 when None), every conv and Dense kernel
        times init_scale, as the JAX codec damps its kernels."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = cfg or cls.CONFIG_CLS()
        model = cls.MODEL_CLS(cfg)
        model.reset_parameters(generator)
        damp_kernels_(model, init_scale)
        return cls(model.state_dict(), cfg=cfg, dtype=dtype, device=device)

    # -------------------------------------------------------------- stages

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            pad_r, pad_b = get_padding_size(h, w, 64)
            ph, pw = h + pad_b, w + pad_r
            self._plans[(h, w)] = {
                "pad": (pad_b, pad_r), "y": (ph // 16, pw // 16),
                "z": (ph // 64, pw // 64),
                "terms": phase_terms_2x(self.cfg.n)}
        return self._plans[(h, w)]

    def _idx(self, scales, terms):
        """Candidate-domain CDF row indexes (uint8) of a step."""
        return self.gauss.build_indexes(
            phase_split(scales, terms).float()).to(torch.uint8)

    def _prior(self, p, z_int):
        """Shared enc+dec: the hyper prior and part 0's indexes."""
        q_step, scales, means = self.model.prior(z_int)
        return q_step, scales, means, self._idx(scales, p["terms"][0])

    def _step0(self, p, y_q0, q_step, scales, means):
        """Shared enc+dec: y_hat part 0, then part 1's means and
        indexes."""
        terms = p["terms"][0]
        m_c = phase_split(means, terms).float()
        y_hat0 = phase_merge(y_q0.float() + m_c, terms, self.cfg.n)
        scales1, means1 = self.model.spatial(y_hat0, q_step, scales, means)
        return y_hat0, means1, self._idx(scales1, p["terms"][1])

    def _step1(self, p, y_q1, means1, y_hat0, q_step):
        """Shared enc+dec: y_hat of both parts times the quant step."""
        terms = p["terms"][1]
        m_c = phase_split(means1, terms).float()
        y_hat1 = phase_merge(y_q1.float() + m_c, terms, self.cfg.n)
        return (y_hat0 + y_hat1) * q_step.float()

    def _synthesis(self, y_hat_acc, qs, h, w):
        return self.model.synthesis(y_hat_acc, qs)[:, :h, :w, :]

    @staticmethod
    def _enc_quant(y, q_step, means, terms):
        """Encoder-only: round(y / q_step - means) in the candidate domain,
        clipped to +-30000, int16."""
        y_c = phase_split(y / q_step.float(), terms)
        m_c = phase_split(means, terms).float()
        return torch.clamp(torch.round(y_c - m_c), -30000, 30000).to(
            torch.int16)

    def _q_scale(self, q_scale):
        return torch.tensor(float(q_scale), dtype=torch.float32,
                            device=self.device)

    # -------------------------------------------------------------- encode

    @torch.inference_mode()
    def compress(self, x, q_scale, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor.  Returns dict(bit_stream, x_hat); x_hat is a float32 tensor
        on the codec's device."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        qs = self._q_scale(q_scale)
        terms = p["terms"]

        y, z_int = self.model.analysis(pad_replicate_nhwc(x, *p["pad"]), qs)
        q_step, scales, means, idx0 = self._prior(p, z_int)
        y_q0 = self._enc_quant(y, q_step, means, terms[0])
        y_hat0, means1, idx1 = self._step0(p, y_q0, q_step, scales, means)
        y_q1 = self._enc_quant(y, q_step, means1, terms[1])
        y_hat_acc = self._step1(p, y_q1, means1, y_hat0, q_step)
        x_hat = self._synthesis(y_hat_acc, qs, h, w)

        zh, zw = p["z"]
        enc = self.encoder
        enc.reset()
        enc.encode_with_indexes(
            z_int[0].permute(2, 0, 1).reshape(-1).cpu().numpy(),
            build_z_indexes(0, self.cfg.n, zh, zw), self.g_z)
        for y_q, idx, k in ((y_q0, idx0, 0), (y_q1, idx1, 1)):
            enc.encode_with_indexes(
                cand_to_chw(y_q.cpu().numpy(), terms[k]),
                cand_to_chw(idx.cpu().numpy(), terms[k]).astype(np.int16),
                self.g_y)
        enc.flush()
        return {"bit_stream": enc.get_encoded_stream(), "x_hat": x_hat}

    # -------------------------------------------------------------- decode

    @torch.inference_mode()
    def decompress(self, bit_stream, q_scale, h, w):
        """Returns dict(x_hat): (1, h, w, 3) float32 in [0, 1], a tensor on
        the codec's device."""
        p = self._plan(h, w)
        qs = self._q_scale(q_scale)
        n, (yh, yw), (zh, zw) = self.cfg.n, p["y"], p["z"]
        dec = self.decoder
        dec.set_stream(bit_stream)

        z_np = dec.decode_stream(build_z_indexes(0, n, zh, zw), self.g_z)
        z_int = torch.from_numpy(
            z_np.reshape(n, zh, zw).transpose(1, 2, 0)[None].copy()).to(
            self.device)
        q_step, scales, means, idx0 = self._prior(p, z_int)

        def dec_part(idx, k):
            terms = p["terms"][k]
            ind = cand_to_chw(idx.cpu().numpy(), terms).astype(np.int16)
            sym = dec.decode_stream(ind, self.g_y)
            cand = chw_to_cand(sym, terms, yh // 2, yw // 2)
            return torch.from_numpy(cand[None]).to(self.device)

        y_q0 = dec_part(idx0, 0)
        y_hat0, means1, idx1 = self._step0(p, y_q0, q_step, scales, means)
        y_q1 = dec_part(idx1, 1)
        y_hat_acc = self._step1(p, y_q1, means1, y_hat0, q_step)
        return {"x_hat": self._synthesis(y_hat_acc, qs, h, w)}


class IntraNoARCodec(EVCCodec):
    """The HEM / DC / FM family intra codec (IntraNoAR,
    DCVC-HEM/src/models/image_model.py:15-200) under the same
    dual-checkerboard runtime; its reconstruction seeds the P codecs'
    DPBs."""

    MODEL_CLS = IntraNoAR
    CONFIG_CLS = IntraNoARConfig
