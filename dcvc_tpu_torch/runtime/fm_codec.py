"""DCVC-FM P-frame codec runtime (counterpart of dcvc_tpu/runtime/
fm_codec.py; reference DCVC-family/DCVC-FM/src/models/video_model.py:
396-500 and common_model.py:231-325): two streams, mv then contextual,
each a hyper prior plus a quadtree 4-part spatial prior, coded into one
bitstream by the host's indexed rANS coder (rans.IndexedRans*).

Every tensor a symbol decision or the reconstruction depends on comes
from stage code shared by the encoder and the decoder (`_run_side`, the
model's prior / synthesis stages); only integer tensors (z int16, the
per-step y_q int16 candidates and uint8 CDF indexes) cross from one to
the other, and the encoder's y_hat is rebuilt from its own symbols plus
the means.  On the card set_deterministic() turns TF32 off and makes
cuDNN deterministic.  The CDF groups are the reference's: the laplace
scale table (rows from entropy/legacy.py's float32 thresholds) and the
two z bitparm banks (Z_QP_NUM rows each); the symbol order is mv_z, z,
mv parts 0-3, y parts 0-3, each part in the reference's dense CHW order
(`cand_to_chw`, the four write grids being core/masks.py's 4x phase
terms).  Frames are RGB in [0, 1], padded to 32 by edge replication (so
the /16 latent grid is even), and the DPB holds the re-padded
reconstruction.  Z_QP_NUM, DISTRIBUTION and _z_channels() are the hooks
a subclass of the same two-stream family overrides.

`cand_to_chw` and `chw_to_cand` are numpy and verbatim copies of the JAX
package's (whose module imports jax), pinned by tests/test_torch_evc.py.
"""

import numpy as np
import torch

from ..core.masks import phase_merge, phase_split, phase_terms_4x
from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.legacy import LegacyGaussianTable, build_z_indexes, \
    legacy_bitparm_bank
from ..legacy.dcvc_fm import DMCFM, DMCFMConfig, empty_dpb
from .image_codec import set_deterministic


def cand_to_chw(cand, terms):
    """Candidate (H/2, W/2, sum-of-term-widths) -> the reference's dense
    CHW write order (Cw*H*W,), Cw = per-term channel width.

    Candidate channels are laid out SEQUENTIALLY in term order
    (core/masks.py phase_split); every spatial phase of the write grid is
    covered by exactly one term (combine_for_writing /
    compress_dual_prior write grids)."""
    h2, w2, c = cand.shape[-3:]
    cand = np.asarray(cand).reshape(h2, w2, c)
    cw = terms[0][2] - terms[0][1]
    out = np.empty((cw, 2 * h2, 2 * w2), cand.dtype)
    off = 0
    for ((py, px), lo, hi) in terms:
        n = hi - lo
        assert n == cw, "write-grid terms must share one channel width"
        out[:, py::2, px::2] = cand[:, :, off:off + n].transpose(2, 0, 1)
        off += n
    return out.reshape(-1)


def chw_to_cand(flat, terms, h2, w2, dtype=np.int16):
    """Inverse of cand_to_chw."""
    cw = terms[0][2] - terms[0][1]
    grid = np.asarray(flat, dtype).reshape(cw, 2 * h2, 2 * w2)
    cand = np.empty((h2, w2, cw * len(terms)), dtype)
    off = 0
    for ((py, px), lo, hi) in terms:
        cand[:, :, off:off + cw] = grid[:, py::2, px::2].transpose(1, 2, 0)
        off += cw
    return cand


class DMCFMCodec:
    """Holds the model, the CDF banks, the host coders and the DPB;
    compress / decompress one P frame against the DPB (reference
    DMC.compress, video_model.py:396-453).

    params: a state_dict of DMCFM at `cfg`.  The model runs in `dtype`
    (float32 by default, as the JAX codec) on `device`."""

    MODEL_CLS = DMCFM
    CONFIG_CLS = DMCFMConfig
    Z_QP_NUM = 2        # the FM bitparm banks carry 2 qp rows
    DISTRIBUTION = "laplace"

    def _z_channels(self):
        """(mv_z channels, contextual z channels)."""
        return self.cfg.ch_mv_z, self.cfg.ch_z

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
        self.ch_mv_z, self.ch_z = self._z_channels()
        self.gauss = LegacyGaussianTable(self.DISTRIBUTION)
        y_cdf, y_len, y_off = self.gauss.compute_cdf_bank()
        z_bank = legacy_bitparm_bank(model.bit_estimator_z.bank(),
                                     self.Z_QP_NUM, self.ch_z)
        zmv_bank = legacy_bitparm_bank(model.bit_estimator_z_mv.bank(),
                                       self.Z_QP_NUM, self.ch_mv_z)
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
        torch.Generator; seed 0 when None; DMCFM.reset_parameters, which
        clones feature_adaptor_1 into slots 0 and 2 as the JAX codec's
        init does), every conv kernel and the fusion kernel times
        init_scale."""
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
            # the reference pads to 16; 32 keeps the /16 grid even for the
            # quadtree's 2x2 phases (dcvc_tpu's fm_codec.py:192)
            pad_r, pad_b = get_padding_size(h, w, 32)
            yh, yw = (h + pad_b) // 16, (w + pad_r) // 16
            self._plans[(h, w)] = {
                "h": h, "w": w, "pad": (pad_b, pad_r), "y": (yh, yw),
                "z": ((yh + 3) // 4, (yw + 3) // 4),
                "terms": {"mv": phase_terms_4x(self.cfg.ch_mv),
                          "ctx": phase_terms_4x(self.cfg.ch_16x)}}
        return self._plans[(h, w)]

    @staticmethod
    def _pad_x(p, x):
        return pad_replicate_nhwc(x, *p["pad"])

    def _idx(self, scales, terms):
        """Candidate-domain CDF row indexes (uint8) of a step."""
        return self.gauss.build_indexes(
            phase_split(scales, terms).float()).to(torch.uint8)

    @staticmethod
    def _enc_quant(y, q_enc, means, terms):
        """Encoder-only: round(y * q_enc - means) in the candidate domain,
        clipped to +-30000, int16."""
        y_c = phase_split(y * q_enc.float(), terms)
        m_c = phase_split(means, terms).float()
        return torch.clamp(torch.round(y_c - m_c), -30000, 30000).to(
            torch.int16)

    def _run_side(self, p, side, z_int, ref_y, extra, y=None,
                  decode_fn=None):
        """One coding side's four-part ladder, shared by the encoder (y
        given: returns (y_hat_so_far, q_dec, [(y_q, idx) per step])) and
        the decoder (decode_fn(idx, step) -> the step's y_q candidate)."""
        m = self.model
        terms = p["terms"][side]
        ch = self.cfg.ch_mv if side == "mv" else self.cfg.ch_16x
        yh, yw = p["y"]
        if side == "mv":
            q_enc, q_dec, scales, means, spctx = m.mv_prior0(z_int, ref_y,
                                                             yh, yw)
            prior_step = m.mv_prior_step
        else:
            q_enc, q_dec, scales, means, spctx = m.ctx_prior0(
                z_int, ref_y, extra, yh, yw)
            prior_step = m.ctx_prior_step
        idx = self._idx(scales, terms[0])
        y_hat = torch.zeros(1, yh, yw, ch, dtype=torch.float32,
                            device=self.device)
        outs = []
        for k in range(4):
            if decode_fn is None:
                y_q = self._enc_quant(y, q_enc, means, terms[k])
                outs.append((y_q, idx))
            else:
                y_q = decode_fn(idx, k)
            m_c = phase_split(means, terms[k]).float()
            y_hat = y_hat + phase_merge(y_q.float() + m_c, terms[k], ch)
            if k < 3:
                scales, means = prior_step(spctx, y_hat, k + 1)
                idx = self._idx(scales, terms[k + 1])
        return y_hat, q_dec, outs

    # -------------------------------------------------------------- encode

    def _synthesize_mv(self, p, mv_y_hat_acc, mv_q_dec, q_index, fa_idx):
        """Shared: mv synthesis and motion compensation -> (mv_y_hat,
        mv_feature, c1, c2, c3)."""
        m, dpb = self.model, self.dpb
        mv_y_hat = mv_y_hat_acc * mv_q_dec.float()
        mv_hat, mv_feature = m.mv_synthesis(mv_y_hat, q_index)
        c1, c2, c3 = m.mc(dpb["ref_frame"], dpb["ref_feature"], fa_idx,
                          mv_hat)
        return mv_y_hat, mv_feature, c1, c2, c3

    def _finish(self, p, y_hat_acc, q_dec, mv, q_index):
        """Shared: synthesis and the DPB update; returns x_hat (1, h, w,
        3)."""
        mv_y_hat, mv_feature, c1, c2, c3 = mv
        y_hat = y_hat_acc * q_dec.float()
        x_hat, feature = self.model.synthesis(y_hat, c1, c2, c3, q_index)
        x_hat = x_hat[:, :p["h"], :p["w"]]
        self.dpb = {"ref_frame": self._pad_x(p, x_hat),
                    "ref_feature": feature, "ref_mv_feature": mv_feature,
                    "ref_y": y_hat, "ref_mv_y": mv_y_hat}
        return x_hat

    @torch.inference_mode()
    def compress(self, x, q_index, fa_idx=0, h=None, w=None):
        """x: (1, H, W, 3) RGB float32 in [0, 1], a numpy array or a
        tensor.  Returns dict(bit_stream, x_hat); the DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h = x.shape[1] if h is None else h
        w = x.shape[2] if w is None else w
        p = self._plan(h, w)
        m, dpb = self.model, self.dpb
        xp = self._pad_x(p, x)

        mv_y, mv_z_int = m.mv_analysis(xp, dpb["ref_frame"],
                                       dpb["ref_mv_feature"], q_index)
        mv_acc, mv_q_dec, mv_outs = self._run_side(
            p, "mv", mv_z_int, dpb["ref_mv_y"], None, y=mv_y)
        mv = self._synthesize_mv(p, mv_acc, mv_q_dec, q_index, fa_idx)
        c1, c2, c3 = mv[2:]
        y, z_int = m.ctx_analysis(xp, c1, c2, c3, q_index)
        y_acc, q_dec, y_outs = self._run_side(p, "ctx", z_int, dpb["ref_y"],
                                              c3, y=y)
        x_hat = self._finish(p, y_acc, q_dec, mv, q_index)

        # the host entropy coder, in the reference's order
        # (video_model.py:427-437): mv_z, z, mv parts 0-3, y parts 0-3
        zh, zw = p["z"]
        enc = self.encoder
        enc.reset()
        for z, ch, g in ((mv_z_int, self.ch_mv_z, self.g_zmv),
                         (z_int, self.ch_z, self.g_z)):
            enc.encode_with_indexes(
                z[0].permute(2, 0, 1).reshape(-1).cpu().numpy(),
                build_z_indexes(0, ch, zh, zw), g)
        for side, outs in (("mv", mv_outs), ("ctx", y_outs)):
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
    def decompress(self, bit_stream, q_index, h, w, fa_idx=0):
        """Returns dict(x_hat): (1, h, w, 3) float32 in [0, 1], a tensor on
        the codec's device; the DPB is updated."""
        if self.dpb["ref_frame"] is None:
            raise ValueError("DPB empty: set_ref_frame first")
        p = self._plan(h, w)
        (yh, yw), (zh, zw) = p["y"], p["z"]
        dpb = self.dpb
        dec = self.decoder
        dec.set_stream(bit_stream)
        z_ints = []
        for ch, g in ((self.ch_mv_z, self.g_zmv), (self.ch_z, self.g_z)):
            z_np = dec.decode_stream(build_z_indexes(0, ch, zh, zw), g)
            z_ints.append(torch.from_numpy(
                z_np.reshape(ch, zh, zw).transpose(1, 2, 0)[None].copy())
                .to(self.device))

        def decode_fn(side):
            terms = p["terms"][side]

            def fn(idx, k):
                ind = cand_to_chw(idx.cpu().numpy(), terms[k]).astype(
                    np.int16)
                sym = dec.decode_stream(ind, self.g_y)
                cand = chw_to_cand(sym, terms[k], yh // 2, yw // 2)
                return torch.from_numpy(cand[None]).to(self.device)
            return fn

        mv_acc, mv_q_dec, _ = self._run_side(
            p, "mv", z_ints[0], dpb["ref_mv_y"], None,
            decode_fn=decode_fn("mv"))
        mv = self._synthesize_mv(p, mv_acc, mv_q_dec, q_index, fa_idx)
        y_acc, q_dec, _ = self._run_side(
            p, "ctx", z_ints[1], dpb["ref_y"], mv[4],
            decode_fn=decode_fn("ctx"))
        return {"x_hat": self._finish(p, y_acc, q_dec, mv, q_index)}
