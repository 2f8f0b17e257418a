"""DCVC-HEM P-frame codec runtime (counterpart of dcvc_tpu/runtime/
hem_codec.py; reference DCVC-family/DCVC-HEM/src/models/video_model.py:
259-372 and common_model.py:102-200, compress / decompress_dual_prior):
two streams, mv then contextual, each a hyper prior plus the dual
cross-checkerboard spatial prior, coded into one bitstream by the host's
indexed rANS coder (rans.IndexedRans*).

The dual prior's two write grids are the 2x phase terms (core/masks.py
phase_terms_2x): step 0 codes the first channel half at the (0,0)/(1,1)
checkerboard and the second at (0,1)/(1,0), step 1 the other phases.
Every tensor a symbol decision or the reconstruction depends on comes
from stage code shared by the encoder and the decoder (`_run_side`, the
model's prior / spatial / synthesis stages); only integer tensors (z
int16, the per-step y_q int16 candidates and uint8 CDF indexes) cross
from one to the other.  On the card set_deterministic() turns TF32 off
and makes cuDNN deterministic.  The CDF groups are the reference's: the
laplace scale table (video_model.py:133) and one-row bitparm banks for z
and z_mv; the symbol order is z_mv, mv parts 0 and 1, z, y parts 0 and 1
(video_model.py:303-309), each part in the reference's dense CHW order
(fm_codec.cand_to_chw).  Frames are RGB in [0, 1], padded to 64 by edge
replication, and the DPB holds four tensors (the re-padded
reconstruction, the feature, y_hat and mv_y_hat); the latents of an
empty DPB are zeros.  Rate control: the continuous q scales are float32
scalars, so one model serves the whole rate range
(video_model.py:251-257).
"""

import numpy as np
import torch

from ..core.masks import phase_merge, phase_split, phase_terms_2x
from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.legacy import LegacyGaussianTable, build_z_indexes, \
    legacy_bitparm_bank
from ..legacy.dcvc_hem import DMCHEM, DMCHEMConfig, empty_dpb
from .fm_codec import cand_to_chw, chw_to_cand
from .image_codec import set_deterministic


class DMCHEMCodec:
    """Holds the model, the CDF banks, the host coders and the DPB;
    compress / decompress one P frame against the DPB.

    params: a state_dict of DMCHEM at `cfg`.  The model runs in `dtype`
    (float32 by default, as the JAX codec) on `device`."""

    MODEL_CLS = DMCHEM
    CONFIG_CLS = DMCHEMConfig

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
        torch.Generator; seed 0 when None; DMCHEM.reset_parameters), every
        conv and Dense kernel times init_scale, as the JAX codec damps
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
        self.dpb = empty_dpb(None)

    def set_ref_frame(self, frame, h=None, w=None):
        """Seed the DPB with an intra reconstruction (1, H, W, 3) in
        [0, 1] (a numpy array or a tensor)."""
        frame = torch.as_tensor(frame).to(self.device, torch.float32)
        h = frame.shape[1] if h is None else h
        w = frame.shape[2] if w is None else w
        self.dpb = empty_dpb(self._pad_x(self._plan(h, w), frame))

    # -------------------------------------------------------------- stages

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            pad_r, pad_b = get_padding_size(h, w, 64)
            ph, pw = h + pad_b, w + pad_r
            self._plans[(h, w)] = {
                "h": h, "w": w, "pad": (pad_b, pad_r),
                "y": (ph // 16, pw // 16), "z": (ph // 64, pw // 64),
                "terms": {"mv": phase_terms_2x(self.cfg.ch_mv),
                          "ctx": phase_terms_2x(self.cfg.ch_m)}}
        return self._plans[(h, w)]

    @staticmethod
    def _pad_x(p, x):
        return pad_replicate_nhwc(x, *p["pad"])

    def _q_scale(self, q_scale):
        return torch.tensor(float(q_scale), dtype=torch.float32,
                            device=self.device)

    def _idx(self, scales, terms):
        """Candidate-domain CDF row indexes (uint8) of a step."""
        return self.gauss.build_indexes(
            phase_split(scales, terms).float()).to(torch.uint8)

    @staticmethod
    def _enc_quant(y, q_step, means, terms):
        """Encoder-only: round(y / q_step - means) in the candidate domain,
        clipped to +-30000, int16."""
        y_c = phase_split(y / q_step.float(), terms)
        m_c = phase_split(means, terms).float()
        return torch.clamp(torch.round(y_c - m_c), -30000, 30000).to(
            torch.int16)

    def _zeros_ref(self, which, p):
        """The DPB's ref_y / ref_mv_y, or zeros of its shape when the DPB
        has none (video_model.py:271-276)."""
        ref = self.dpb[which]
        if ref is not None:
            return ref
        ch = {"ref_y": self.cfg.ch_m, "ref_mv_y": self.cfg.ch_mv}[which]
        return torch.zeros(1, *p["y"], ch, dtype=torch.float32,
                           device=self.device)

    def _run_side(self, p, side, z_int, ref_y, extra, y=None,
                  decode_fn=None):
        """One coding side's dual-prior ladder, shared by the encoder (y
        given: returns (y_hat_acc, [(y_q, idx) per step])) and the decoder
        (decode_fn(idx, step) -> the step's y_q candidate)."""
        m = self.model
        terms = p["terms"][side]
        ch = self.cfg.ch_mv if side == "mv" else self.cfg.ch_m
        if side == "mv":
            q_step, scales, means = m.mv_prior(z_int, ref_y)
            spatial = m.mv_spatial
        else:
            q_step, scales, means = m.ctx_prior(z_int, extra, ref_y)
            spatial = m.ctx_spatial
        idx = self._idx(scales, terms[0])
        outs, y_hat = [], None
        for k in range(2):
            if decode_fn is None:
                y_q = self._enc_quant(y, q_step, means, terms[k])
                outs.append((y_q, idx))
            else:
                y_q = decode_fn(idx, k)
            m_c = phase_split(means, terms[k]).float()
            part = phase_merge(y_q.float() + m_c, terms[k], ch)
            if k == 0:
                y_hat = part
                scales, means = spatial(y_hat, q_step, scales, means)
                idx = self._idx(scales, terms[1])
            else:
                y_hat = (y_hat + part) * q_step.float()
        return y_hat, outs

    def _motion(self, p, mv_y_hat_acc, qs_mv):
        """Shared: mv synthesis and motion compensation -> (mv_y_hat, c1,
        c2, c3)."""
        m, dpb = self.model, self.dpb
        mv_y_hat, mv_hat = m.mv_synthesis(mv_y_hat_acc, qs_mv)
        c1, c2, c3 = m.mc(dpb["ref_frame"], dpb["ref_feature"], mv_hat)
        return mv_y_hat, c1, c2, c3

    def _finish(self, p, y_hat_acc, mv, qs_y):
        """Shared: synthesis and the DPB update; returns x_hat (1, h, w,
        3)."""
        mv_y_hat, c1, c2, c3 = mv
        y_hat, x_hat, feature = self.model.synthesis(y_hat_acc, c1, c2, c3,
                                                     qs_y)
        x_hat = x_hat[:, :p["h"], :p["w"]]
        self.dpb = {"ref_frame": self._pad_x(p, x_hat),
                    "ref_feature": feature, "ref_y": y_hat,
                    "ref_mv_y": mv_y_hat}
        return x_hat

    # -------------------------------------------------------------- encode

    @torch.inference_mode()
    def compress(self, x, mv_y_q_scale, y_q_scale, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor; the q scales floats.  Returns dict(bit_stream, x_hat); the
        DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        m, dpb = self.model, self.dpb
        qs_mv, qs_y = self._q_scale(mv_y_q_scale), self._q_scale(y_q_scale)
        xp = self._pad_x(p, x)

        mv_y, mv_z_int = m.mv_analysis(xp, dpb["ref_frame"], qs_mv)
        mv_acc, mv_outs = self._run_side(
            p, "mv", mv_z_int, self._zeros_ref("ref_mv_y", p), None, y=mv_y)
        mv = self._motion(p, mv_acc, qs_mv)
        c1, c2, c3 = mv[1:]
        y, z_int = m.ctx_analysis(xp, c1, c2, c3, qs_y)
        y_acc, y_outs = self._run_side(p, "ctx", z_int,
                                       self._zeros_ref("ref_y", p), c3, y=y)
        x_hat = self._finish(p, y_acc, mv, qs_y)

        # the host entropy coder, in the reference's order
        # (video_model.py:303-309): z_mv, mv parts, z, y parts
        zh, zw = p["z"]
        z_idx = build_z_indexes(0, self.cfg.ch_n, zh, zw)
        enc = self.encoder
        enc.reset()
        for z, g, side, outs in ((mv_z_int, self.g_zmv, "mv", mv_outs),
                                 (z_int, self.g_z, "ctx", y_outs)):
            enc.encode_with_indexes(
                z[0].permute(2, 0, 1).reshape(-1).cpu().numpy(), z_idx, g)
            terms = p["terms"][side]
            for k, (y_q, idx) in enumerate(outs):
                enc.encode_with_indexes(
                    cand_to_chw(y_q.cpu().numpy(), terms[k]),
                    cand_to_chw(idx.cpu().numpy(), terms[k]).astype(
                        np.int16), self.g_y)
        enc.flush()
        return {"bit_stream": enc.get_encoded_stream(), "x_hat": x_hat}

    # -------------------------------------------------------------- decode

    @torch.inference_mode()
    def decompress(self, bit_stream, mv_y_q_scale, y_q_scale, h, w):
        """Returns dict(x_hat): (1, h, w, 3) float32 in [0, 1], a tensor on
        the codec's device; the DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        p = self._plan(h, w)
        (yh, yw), (zh, zw) = p["y"], p["z"]
        n = self.cfg.ch_n
        qs_mv, qs_y = self._q_scale(mv_y_q_scale), self._q_scale(y_q_scale)
        dec = self.decoder
        dec.set_stream(bit_stream)

        def decode_z(g):
            z_np = dec.decode_stream(build_z_indexes(0, n, zh, zw), g)
            return torch.from_numpy(z_np.reshape(n, zh, zw).transpose(
                1, 2, 0)[None].copy()).to(self.device)

        def decode_fn(side):
            terms = p["terms"][side]

            def fn(idx, k):
                ind = cand_to_chw(idx.cpu().numpy(), terms[k]).astype(
                    np.int16)
                sym = dec.decode_stream(ind, self.g_y)
                cand = chw_to_cand(sym, terms[k], yh // 2, yw // 2)
                return torch.from_numpy(cand[None]).to(self.device)
            return fn

        mv_acc, _ = self._run_side(
            p, "mv", decode_z(self.g_zmv), self._zeros_ref("ref_mv_y", p),
            None, decode_fn=decode_fn("mv"))
        mv = self._motion(p, mv_acc, qs_mv)
        y_acc, _ = self._run_side(
            p, "ctx", decode_z(self.g_z), self._zeros_ref("ref_y", p), mv[3],
            decode_fn=decode_fn("ctx"))
        return {"x_hat": self._finish(p, y_acc, mv, qs_y)}
