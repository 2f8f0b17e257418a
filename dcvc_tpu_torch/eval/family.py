"""Legacy-family end-to-end evaluation (counterpart of
dcvc_tpu/eval/family.py): encode -> one NAL stream file -> decode from
disk -> metrics, for the pre-UF models.

The port runs every model of the JAX runner:
  - DCVC-RT (`model="rt"`): its intra codec and P-frame codec, its NAL
    container (bitstream/legacy_container.py: the SPS carries the size
    and a 1-bit lane flag, each frame's IP NAL its qp), the qp_shift
    schedule over INDEX_MAP (DCVC-RT/test_video.py:164-203), the
    sequence-level lane pin (2 lanes at 1280x720 and above), and the DPB
    reseeded from each intra frame;
  - DCVC-FM (`model="fm"`, DCVC-FM/src/utils/test_helper.py:205-280):
    IntraNoAR at INTRA_NOAR_CONFIG (N 192, as the JAX runner builds it)
    for the intra frames, DMCFMCodec for the P frames (both at
    init_scale 0.4), one FM NAL file per sequence (the SPS carries
    height, width, qp and fa_idx; FMSPSHelper), each P frame's fa_idx
    from INDEX_MAP_FM, the intra q_scale from the i_q_scales ladder at
    the q index, and per-frame bits the file's total / n, as the
    reference's single-file format has no per-frame split;
  - DCVC-HEM and DCVC-DC (`model="hem"`, `"dc"`; DCVC-HEM / DCVC-DC
    test_video.py and stream_helper.py): the same intra codec, and one
    container file per frame (`{seq}_q{q}_{i}.bin`: hem_encode_i / _p,
    dc_encode_i / _p with q_in_ckpt False), so that each frame has its
    own bits.  HEM's P frames take the continuous q scales
    mv_q_scales[q] / y_q_scales[q] and their file carries q twice; DC's
    take the q index and the feature adaptor INDEX_MAP_DC[i % 4], their
    file the frame's i % 4;
  - DCVC-2021 (`model="dcvc"`, DCVC/test_video.py:73-176): Cheng2020Codec
    (cheng2020-anchor at CHENG2020_Q1_3, the JAX runner's init) for the
    intra frames and DCVCCodec (init_scale 0.4) for the P frames, both
    fixed-rate, one file per frame: the two-string intra container and the
    four-string P container (dcvc_encode_i / _p); both codecs run their
    masked-conv AR on the host (runtime/dcvc_codec.py HostAR);
  - DCVC-TCM (`model="tcm"`, DCVC-TCM/test_video.py): HyperpriorCodec
    (bmshj2018-hyperprior at HyperpriorConfig(), the JAX runner's init)
    for the intra frames, in DCVC's two-string intra container, and
    DMCTCMCodec (init_scale 0.4) for the P frames, one single-string
    file per frame (tcm_encode_p), decoded at the sequence's size.
The estimated-bits fast mode (run_sequence_fast, the reference's
test_helper.py:134) codes the intra frames for real and takes the P
frames' rates from the P model's forward on rounded latents (FM: on
INDEX_MAP_FM's adaptors; HEM: at the q scales, its x_hat the clipped DPB
frame; DCVC: DCVCNet's forward against the previous clipped recon; TCM:
DMCTCM's training forward against the previous clipped recon and the
carried feature, its bpp over the padded frame's pixels as the model
computes it), frames edge-padded to a multiple of 64, the intra frames'
bpp over the original pixels.  The fast mode raises for rt and dc, as in
the JAX runner.

All legacy models work on RGB in [0, 1].  The codecs run in float32 on
every device, as dcvc_tpu's runner builds them (its RT codecs in f32 on
every backend, eval/family.py:157-167; the other legacy codecs default
to f32); bfloat16 only when the caller asks for it (`dtype`,
family_main --dtype bf16).  In float32 the RT intra trunk's
DepthConvBlocks take the plain PyTorch block on the card too
(layers/blocks.py kernel_path), as the reference's do; FM's, HEM's,
DC's, DCVC's and TCM's blocks are not K1's and they decode on the host,
so their paths launch no kernel.
"""

import math
import os
import time

import numpy as np
import torch

from ..bitstream import legacy_container as lc
from ..legacy import dcvc_hem
from ..legacy.compressai_zoo import Cheng2020Anchor, Cheng2020Config, \
    HyperpriorConfig, ScaleHyperprior, TINY_CHENG2020, TINY_HYPERPRIOR
from ..legacy.dcvc_dc import DC_CONFIG, DMCDC, DMCDCConfig, TINY_DC_CONFIG
from ..legacy.dcvc_fm import DMCFM, DMCFMConfig, FM_CONFIG, \
    TINY_FM_CONFIG, empty_dpb
from ..legacy.dcvc_net import DCVC_CONFIG, DCVCConfig, DCVCNet, \
    TINY_DCVC_CONFIG
from ..legacy.dcvc_hem import DMCHEM, DMCHEMConfig, HEM_CONFIG, \
    TINY_HEM_CONFIG
from ..legacy.dcvc_rt import DMCRT, DMCRTCodec, DMCRTConfig, \
    INDEX_MAP as RT_INDEX_MAP, TINY_RT_CONFIG, shift_qp
from ..legacy.dcvc_tcm import DMCTCM, DMCTCMConfig, TCM_CONFIG, \
    TINY_TCM_CONFIG
from ..legacy.hem_intra import INTRA_NOAR_CONFIG, IntraNoAR, \
    IntraNoARConfig, TINY_INTRA_NOAR_CONFIG
from ..legacy.rt_intra import DMCIRT, DMCIRTConfig, TINY_RT_INTRA_CONFIG
from ..runtime.compressai_codec import Cheng2020Codec, HyperpriorCodec
from ..runtime.dc_codec import DMCDCCodec
from ..runtime.dcvc_codec import DCVCCodec
from ..runtime.evc_codec import IntraNoARCodec
from ..runtime.fm_codec import DMCFMCodec
from ..runtime.hem_codec import DMCHEMCodec
from ..runtime.rt_image_codec import RTIntraCodec
from ..runtime.tcm_codec import DMCTCMCodec
from ..utils.jax_bridge import load_into, native_config
from ..utils.metrics import calc_psnr

MODELS = ("rt", "fm", "hem", "dc", "dcvc", "tcm")
NOT_PORTED = ()
# the JAX runner's fast mode covers fm, dcvc, tcm and hem
FAST_MODELS = ("fm", "hem", "dcvc", "tcm")
INDEX_MAP_DC = [0, 1, 0, 2]                  # DC's feature adaptors
INDEX_MAP_FM = [0, 1, 0, 2, 0, 2, 0, 2]     # FM test_helper.py:146
# (model file class, its default config) of each codec, by model
MODEL_FILES = {"rt": ((DMCIRT, DMCIRTConfig()), (DMCRT, DMCRTConfig())),
               "fm": ((IntraNoAR, IntraNoARConfig()),
                      (DMCFM, DMCFMConfig())),
               "hem": ((IntraNoAR, IntraNoARConfig()),
                       (DMCHEM, DMCHEMConfig())),
               "dc": ((IntraNoAR, IntraNoARConfig()),
                      (DMCDC, DMCDCConfig())),
               "dcvc": ((Cheng2020Anchor, Cheng2020Config()),
                        (DCVCNet, DCVCConfig())),
               "tcm": ((ScaleHyperprior, HyperpriorConfig()),
                       (DMCTCM, DMCTCMConfig()))}
# each legacy P codec: (its class, its config, its TINY config)
P_CODECS = {"fm": (DMCFMCodec, FM_CONFIG, TINY_FM_CONFIG),
            "hem": (DMCHEMCodec, HEM_CONFIG, TINY_HEM_CONFIG),
            "dc": (DMCDCCodec, DC_CONFIG, TINY_DC_CONFIG),
            "dcvc": (DCVCCodec, DCVC_CONFIG, TINY_DCVC_CONFIG),
            "tcm": (DMCTCMCodec, TCM_CONFIG, TINY_TCM_CONFIG)}


def interpolate_log(min_val, max_val, num=64, decreasing=True):
    """Reference interpolate_log (DCVC-HEM/src/utils/common.py): num
    log-spaced values; index 0 = max (highest rate) when decreasing.  The
    q-scale ladders of the models that code a q index (HEM, DC, FM); RT
    codes integer QPs."""
    grid = np.exp(np.linspace(math.log(min_val), math.log(max_val), num))
    return grid[::-1].copy() if decreasing else grid


def _psnr_rgb(x_hat, rgb_org):
    """x_hat (1,h,w,3) f32 [0,1]; rgb_org (3,h,w) uint8-valued."""
    rec = np.clip(np.round(np.asarray(x_hat)[0] * 255), 0, 255)
    return calc_psnr(rgb_org.transpose(1, 2, 0).astype(np.float64), rec)


def _numpy(x):
    return x.detach().float().cpu().numpy()


def _with_params(codec, path, cls, default_cfg):
    """A codec of codec's type around the weights of a model file: a
    dcvc_tpu.params.v1 file (its embedded config wins, so a full-size
    file loads into a runner built with --tiny) or a reference .pth.tar
    at codec's config.  A fresh codec, since the CDF banks come from the
    weights."""
    cfg = native_config(path, type(default_cfg), codec.cfg)
    model = load_into(cls(cfg), path)
    extra = {"skip_thres": codec.skip_thres} \
        if hasattr(codec, "skip_thres") else {}
    return type(codec)(model.state_dict(), cfg=cfg, dtype=codec.dtype,
                       device=codec.device, **extra)


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def family_dtype(device, dtype=None):
    """The dtype the runner builds its codecs in: float32 on every device
    (`device` does not change it: the CPU and a card alike), unless
    `dtype` ("f32" / "bf16", or a torch dtype) asks for another."""
    del device
    return torch.float32 if dtype is None else DTYPES.get(dtype, dtype)


class FamilyRunner:
    """Per-model adapter: builds the codecs, encodes and decodes a sequence
    through the model's own container format.

    device: the codecs' torch device; dtype: family_dtype's (float32
    unless "bf16" is asked for).  Seeded random weights unless
    model_path_i / model_path_p name model files (dcvc_tpu.params.v1, as
    the JAX runner takes them, or reference .pth.tar)."""

    def __init__(self, model, stream_dir, rate_num=1, tiny=False,
                 seed=0, verify_bitexact=True,
                 model_path_i=None, model_path_p=None, device="cuda",
                 dtype=None):
        if model not in MODELS:
            raise ValueError(f"model {model!r}: unknown (the port runs "
                             f"{MODELS})")
        self.model = model
        self.stream_dir = stream_dir
        self.rate_num = rate_num
        self.verify = verify_bitexact
        self.device = torch.device(device)
        self.dtype = family_dtype(self.device, dtype)
        os.makedirs(stream_dir, exist_ok=True)
        self._build(seed, tiny)
        files_i, files_p = MODEL_FILES[model]
        if model_path_i:
            self.i_codec = _with_params(self.i_codec, model_path_i, *files_i)
        if model_path_p:
            self.p_codec = _with_params(self.p_codec, model_path_p, *files_p)
        # 64-level q ladders of the models that code a q index (anchor
        # values stand in for the per-checkpoint anchors the reference
        # reads from trained checkpoints); HEM's P frames take the mv and
        # y ones
        self.i_q_scales = interpolate_log(0.3, 3.0)
        self.mv_q_scales = interpolate_log(0.5, 2.0)
        self.y_q_scales = interpolate_log(0.3, 3.0)

    def _build(self, seed, tiny):
        kw = {"dtype": self.dtype, "device": self.device}
        gen_i = torch.Generator().manual_seed(seed)
        gen_p = torch.Generator().manual_seed(seed + 1)
        if self.model == "rt":
            self.i_codec = RTIntraCodec.init_random(
                gen_i, cfg=TINY_RT_INTRA_CONFIG if tiny else None, **kw)
            self.p_codec = DMCRTCodec.init_random(
                gen_p, cfg=TINY_RT_CONFIG if tiny else None, init_scale=0.4,
                **kw)
        else:
            if self.model == "dcvc":
                # the JAX runner's cheng2020 at its own init (no damping)
                self.i_codec = Cheng2020Codec.init_random(
                    gen_i, cfg=TINY_CHENG2020 if tiny else Cheng2020Config(),
                    **kw)
            elif self.model == "tcm":
                # bmshj2018-hyperprior, likewise
                self.i_codec = HyperpriorCodec.init_random(
                    gen_i, cfg=TINY_HYPERPRIOR if tiny
                    else HyperpriorConfig(), **kw)
            else:
                self.i_codec = IntraNoARCodec.init_random(
                    gen_i, cfg=TINY_INTRA_NOAR_CONFIG if tiny
                    else INTRA_NOAR_CONFIG, init_scale=0.4, **kw)
            codec, cfg, tiny_cfg = P_CODECS[self.model]
            self.p_codec = codec.init_random(
                gen_p, cfg=tiny_cfg if tiny else cfg, init_scale=0.4, **kw)

    def run(self, frames_rgb, rate_indices, gop, seq_name="seq"):
        return {f"rate_{r}": self.run_sequence(frames_rgb, r, gop,
                                               f"{seq_name}_r{r}")
                for r in rate_indices}

    def run_sequence(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """frames_rgb: list of (3, h, w) uint8-valued arrays.  Returns a
        per-sequence result dict (bits / psnr per frame + averages)."""
        if self.model == "rt":
            return self.run_sequence_rt(frames_rgb, rate_idx, gop, seq_name)
        if self.model == "fm":
            return self.run_sequence_fm(frames_rgb, rate_idx, gop, seq_name)
        return self.run_sequence_files(frames_rgb, rate_idx, gop, seq_name)

    def _q_index(self, rate_idx):
        """The rate point's q index: round(linspace(12, 51)) over the
        rates, as the JAX runner picks it."""
        return int(np.round(np.linspace(12, 51, max(self.rate_num, 2))
                            [min(rate_idx, self.rate_num - 1)]))

    def _summary(self, result, frames_rgb, recons, enc_time, dec_time):
        """result (frame_bpp, frame_type, bitexact) completed with the
        PSNRs of `recons` against frames_rgb and the averages."""
        n = len(frames_rgb)
        result["frame_psnr"] = [_psnr_rgb(recons[i], frames_rgb[i])
                                for i in range(n)]
        result["avg_bpp"] = float(np.mean(result["frame_bpp"]))
        result["avg_psnr"] = float(np.mean(result["frame_psnr"]))
        i_mask = [t == 0 for t in result["frame_type"]]
        result["avg_psnr_i"] = float(np.mean(
            [p for p, m in zip(result["frame_psnr"], i_mask) if m]))
        p_ps = [p for p, m in zip(result["frame_psnr"], i_mask) if not m]
        result["avg_psnr_p"] = float(np.mean(p_ps)) if p_ps else 0.0
        result["avg_frame_encoding_time"] = enc_time / n
        result["avg_frame_decoding_time"] = dec_time / n
        return result

    @staticmethod
    def _frames01(frames_rgb):
        return [np.ascontiguousarray(
            f.transpose(1, 2, 0).astype(np.float32) / 255.0)[None]
            for f in frames_rgb]

    @staticmethod
    def _is_intra(i, gop):
        return i % gop == 0 if gop > 0 else i == 0

    # ------------------------------------------- DCVC-HEM, DC, DCVC, TCM

    def run_sequence_files(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """DCVC-HEM / DCVC-DC / DCVC / DCVC-TCM end-to-end (dcvc_tpu's
        run_sequence for hem, dc, dcvc and tcm): each frame into its own
        container file, decoded back from disk, the decode held bit-exact
        against the encode."""
        h, w = frames_rgb[0].shape[1:]
        q = self._q_index(rate_idx)
        frames = self._frames01(frames_rgb)
        paths = [os.path.join(self.stream_dir, f"{seq_name}_q{q}_{i}.bin")
                 for i in range(len(frames))]
        t0 = time.time()
        enc_recons, types = [], []
        for i, x in enumerate(frames):
            types.append(0 if self._is_intra(i, gop) else 1)
            enc_recons.append(self._encode_file(i, x, q, h, w, paths[i],
                                                types[-1] == 0))
        enc_time = time.time() - t0
        t0 = time.time()
        dec_recons = [self._decode_file(i, h, w, path, types[i] == 0)
                      for i, path in enumerate(paths)]
        dec_time = time.time() - t0
        result = {"frame_bpp": [os.path.getsize(path) * 8 / (h * w)
                                for path in paths],
                  "frame_type": types,
                  "bitexact": not self.verify or all(
                      np.array_equal(a, b)
                      for a, b in zip(enc_recons, dec_recons))}
        result = self._summary(result, frames_rgb, dec_recons, enc_time,
                               dec_time)
        result["q_index"] = q
        return result

    def _encode_file(self, i, x, q, h, w, path, is_i):
        if self.model in ("dcvc", "tcm"):
            return self._encode_file_dcvc(x, h, w, path, is_i)
        if is_i:
            res = self.i_codec.compress(x, float(self.i_q_scales[q]), h, w)
            if self.model == "hem":
                lc.hem_encode_i(h, w, q, res["bit_stream"], path)
            else:
                lc.dc_encode_i(h, w, False, q, res["bit_stream"], path)
            self.p_codec.set_ref_frame(res["x_hat"], h, w)
        elif self.model == "hem":
            res = self.p_codec.compress(x, float(self.mv_q_scales[q]),
                                        float(self.y_q_scales[q]), h=h, w=w)
            lc.hem_encode_p(res["bit_stream"], q, q, path)
        else:
            res = self.p_codec.compress(x, q, fa_idx=INDEX_MAP_DC[i % 4],
                                        h=h, w=w)
            lc.dc_encode_p(res["bit_stream"], False, q, i % 4, path)
        return _numpy(res["x_hat"])

    def _encode_file_dcvc(self, x, h, w, path, is_i):
        """DCVC's and TCM's fixed-rate codecs: the two-string intra
        container, DCVC's four-string P container, TCM's one-string P
        file."""
        if is_i:
            res = self.i_codec.compress(x, h, w)
            lc.dcvc_encode_i(h, w, res["y_string"], res["z_string"], path)
            self.p_codec.set_ref_frame(res["x_hat"], h, w)
        elif self.model == "tcm":
            res = self.p_codec.compress(x, h, w)
            lc.tcm_encode_p(res["bit_stream"], path)
        else:
            res = self.p_codec.compress(x, h, w)
            lc.dcvc_encode_p(h, w, res["mv_y_string"], res["mv_z_string"],
                             res["y_string"], res["z_string"], path)
        return _numpy(res["x_hat"])

    def _decode_file(self, i, h, w, path, is_i):
        """One frame from its file; an intra frame reseeds the DPB."""
        if self.model in ("dcvc", "tcm"):
            if is_i:
                hh, ww, y_s, z_s = lc.dcvc_decode_i(path)
                x_hat = self.i_codec.decompress(y_s, z_s, hh, ww)["x_hat"]
                self.p_codec.set_ref_frame(x_hat, h, w)
            elif self.model == "tcm":
                x_hat = self.p_codec.decompress(lc.tcm_decode_p(path), h,
                                                w)["x_hat"]
            else:
                hh, ww, *strings = lc.dcvc_decode_p(path)
                x_hat = self.p_codec.decompress(*strings, hh, ww)["x_hat"]
        elif is_i:
            if self.model == "hem":
                hh, ww, q, stream = lc.hem_decode_i(path)
            else:
                hh, ww, _, q, stream = lc.dc_decode_i(path)
            x_hat = self.i_codec.decompress(
                stream, float(self.i_q_scales[q]), hh, ww)["x_hat"]
            self.p_codec.set_ref_frame(x_hat, h, w)
        elif self.model == "hem":
            mv_q, y_q, stream = lc.hem_decode_p(path)
            x_hat = self.p_codec.decompress(
                stream, float(self.mv_q_scales[mv_q]),
                float(self.y_q_scales[y_q]), h, w)["x_hat"]
        else:
            _, q, fi, stream = lc.dc_decode_p(path)
            if fi != i % 4:
                raise ValueError(f"{path}: frame {i} carries frame index "
                                 f"{fi}")
            x_hat = self.p_codec.decompress(stream, q, h, w,
                                            fa_idx=INDEX_MAP_DC[fi])["x_hat"]
        return _numpy(x_hat)

    # -------------------------------------------------------------- DCVC-FM

    def run_sequence_fm(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """DCVC-FM end-to-end (dcvc_tpu's run_sequence for fm): every frame
        into one FM NAL file, decoded back from disk, the decode held
        bit-exact against the encode."""
        h, w = frames_rgb[0].shape[1:]
        q = self._q_index(rate_idx)
        frames = self._frames01(frames_rgb)
        n = len(frames)
        path = os.path.join(self.stream_dir, f"{seq_name}_q{q}.bin")
        t0 = time.time()
        enc_recons, types = self._encode_fm(frames, q, gop, h, w, path)
        enc_time = time.time() - t0
        t0 = time.time()
        dec_recons = self._decode_fm(n, gop, path)
        dec_time = time.time() - t0
        total_bits = os.path.getsize(path) * 8
        bits = [total_bits / n] * n   # no per-frame split in the format
        result = {"frame_bpp": [b / (h * w) for b in bits],
                  "frame_type": types,
                  "bitexact": not self.verify or all(
                      np.array_equal(a, b)
                      for a, b in zip(enc_recons, dec_recons))}
        result = self._summary(result, frames_rgb, dec_recons, enc_time,
                               dec_time)
        result["q_index"] = q
        return result

    def _encode_fm(self, frames, q, gop, h, w, path):
        recons, types = [], []
        sps_helper = lc.FMSPSHelper()
        with open(path, "wb") as f:
            for i, x in enumerate(frames):
                is_i = self._is_intra(i, gop)
                types.append(0 if is_i else 1)
                # the intra frame's SPS carries fa_idx 0
                fa = 0 if is_i else INDEX_MAP_FM[i % len(INDEX_MAP_FM)]
                if is_i:
                    res = self.i_codec.compress(
                        x, float(self.i_q_scales[q]), h, w)
                    self.p_codec.set_ref_frame(res["x_hat"], h, w)
                else:
                    res = self.p_codec.compress(x, q, fa_idx=fa, h=h, w=w)
                sps = {"height": h, "width": w, "qp": q, "fa_idx": fa}
                sps_id, is_new = sps_helper.get_sps_id(sps)
                if is_new:
                    lc.fm_write_sps(f, {**sps, "sps_id": sps_id})
                lc.fm_write_ip(f, is_i, sps_id, res["bit_stream"])
                recons.append(_numpy(res["x_hat"]))
        return recons, types

    def _decode_fm(self, n, gop, path):
        recons = []
        sps_helper = lc.FMSPSHelper()
        with open(path, "rb") as f:
            while len(recons) < n:
                header = lc.fm_read_header(f)
                if header["nal_type"] == lc.FM_NAL_SPS:
                    sps_helper.add_sps_by_id(
                        lc.fm_read_sps_remaining(f, header["sps_id"]))
                    continue
                sps = sps_helper.get_sps_by_id(header["sps_id"])
                stream = lc.fm_read_ip_remaining(f)
                i = len(recons)
                is_i = header["nal_type"] == lc.FM_NAL_I
                if is_i != self._is_intra(i, gop):
                    raise ValueError(f"{path}: frame {i}'s NAL type does "
                                     f"not follow the gop")
                hh, ww = sps["height"], sps["width"]
                if is_i:
                    x_hat = self.i_codec.decompress(
                        stream, float(self.i_q_scales[sps["qp"]]), hh,
                        ww)["x_hat"]
                    self.p_codec.set_ref_frame(x_hat, hh, ww)
                else:
                    x_hat = self.p_codec.decompress(
                        stream, sps["qp"], hh, ww,
                        fa_idx=sps["fa_idx"])["x_hat"]
                recons.append(_numpy(x_hat))
        return recons

    @torch.inference_mode()
    def run_sequence_fast(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """The estimated-bits mode without entropy coding (dcvc_tpu's
        run_sequence_fast; the reference's test_helper.py:134): intra
        frames through the real intra codec, P frames' rates from the P
        model's forward on rounded latents (FM: DMCFM.forward on
        INDEX_MAP_FM's adaptors; HEM: DMCHEM.forward at the q scales, its
        x_hat the clipped DPB frame; DCVC: DCVCNet.forward against the
        previous reconstruction, its x_hat the clipped recon_image; TCM:
        DMCTCM.forward against the previous clipped recon_image and the
        carried feature, its bpp the model's own, over the padded
        frame's pixels).  Frames are edge-padded to a multiple of 64 (the
        reference's replicate pad), the intra frames' bpp is over the
        original pixels and the PSNR over the cropped reconstruction."""
        if self.model not in FAST_MODELS:
            raise ValueError(f"--fast: no estimated-bits mode for "
                             f"{self.model} (the JAX runner's covers "
                             f"{FAST_MODELS})")
        del seq_name
        h, w = frames_rgb[0].shape[1:]
        ph, pw = (64 - h % 64) % 64, (64 - w % 64) % 64
        hp, wp = h + ph, w + pw
        q = self._q_index(rate_idx)
        frames = [np.pad(x[0], ((0, ph), (0, pw), (0, 0)), mode="edge")[None]
                  for x in self._frames01(frames_rgb)]
        model = self.p_codec.model
        result = {"frame_bpp": [], "frame_type": [], "bitexact": True}
        recons = []
        t0 = time.time()
        dpb = None
        for i, x in enumerate(frames):
            is_i = self._is_intra(i, gop)
            result["frame_type"].append(0 if is_i else 1)
            if is_i and self.model in ("dcvc", "tcm"):
                res = self.i_codec.compress(x, hp, wp)
                x_hat = res["x_hat"]
                dpb = x_hat if self.model == "dcvc" else (x_hat, None)
                bpp = (len(res["y_string"]) + len(res["z_string"])) * 8 \
                    / (h * w)
            elif is_i:
                res = self.i_codec.compress(x, float(self.i_q_scales[q]),
                                            hp, wp)
                x_hat = res["x_hat"]
                dpb = (dcvc_hem.empty_dpb if self.model == "hem"
                       else empty_dpb)(x_hat)
                bpp = len(res["bit_stream"]) * 8 / (h * w)
            else:
                x_t = torch.from_numpy(x).to(self.device)
                if self.model == "dcvc":
                    res = model(dpb, x_t)
                    dpb = x_hat = torch.clamp(res["recon_image"], 0.0, 1.0)
                elif self.model == "tcm":
                    res = model(x_t, *dpb)
                    x_hat = torch.clamp(res["recon_image"], 0.0, 1.0)
                    dpb = (x_hat, res["feature"])
                elif self.model == "hem":
                    scales = [torch.tensor(float(v[q]), device=self.device)
                              for v in (self.mv_q_scales, self.y_q_scales)]
                    res, dpb = model(x_t, dpb, *scales)
                    x_hat = torch.clamp(dpb["ref_frame"], 0.0, 1.0)
                else:
                    res, dpb = model(x_t, dpb, q,
                                     INDEX_MAP_FM[i % len(INDEX_MAP_FM)])
                    x_hat = dpb["ref_frame"]
                bpp = float(res["bpp"][0])
            result["frame_bpp"].append(bpp)
            recons.append(_numpy(x_hat[:, :h, :w]))
        elapsed = time.time() - t0
        result = self._summary(result, frames_rgb, recons, elapsed, 0.0)
        result["q_index"] = q
        result["fast"] = True
        return result

    # -------------------------------------------------------------- DCVC-RT

    def run_sequence_rt(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """DCVC-RT end-to-end: its NAL container (qp in the IP NAL), the RT
        intra codec, qp_shift = [0, 8, 4] over the fa schedule
        (DCVC-RT/test_video.py:164-203) and the SPS-pinned 1-bit
        entropy-coder parallelism."""
        h, w = frames_rgb[0].shape[1:]
        qp_num = self.p_codec.cfg.qp_num
        q = int(round(self._q_index(rate_idx) * (qp_num - 1) / 63))
        frames = self._frames01(frames_rgb)
        n = len(frames)
        path = os.path.join(self.stream_dir, f"{seq_name}_rt_q{q}.bin")

        # sequence-level lane pin (reference set_use_two_entropy_coders,
        # DCVC-RT/test_video.py:152-153): 2 lanes at >=720p
        ec = 2 if h * w >= 1280 * 720 else 1
        self.i_codec.force_ec = ec
        self.p_codec.force_ec = ec

        sps = {"height": h, "width": w, "use_ada_i": 0, "ec_part": ec - 1}
        sps_helper = lc.RTSPSHelper()
        enc_recons, types = [], []
        t0 = time.time()
        with open(path, "wb") as f:
            for i, x in enumerate(frames):
                is_i = self._is_intra(i, gop)
                types.append(0 if is_i else 1)
                sps_id, is_new = sps_helper.get_sps_id(sps)
                if is_new:
                    lc.rt_write_sps(f, {**sps, "sps_id": sps_id})
                if is_i:
                    res = self.i_codec.compress(x, q)
                    lc.rt_write_ip(f, True, sps_id, q, res["bit_stream"])
                    self.p_codec.clear_dpb()
                    self.p_codec.add_ref_feature_from_frame(res["x_hat"])
                else:
                    fa = RT_INDEX_MAP[i % len(RT_INDEX_MAP)]
                    curr_qp = shift_qp(q, fa, qp_num)
                    res = self.p_codec.compress(x, curr_qp, recon=True)
                    lc.rt_write_ip(f, False, sps_id, curr_qp,
                                   res["bit_stream"])
                enc_recons.append(_numpy(res["x_hat"]))
        enc_time = time.time() - t0

        t0 = time.time()
        dec_recons = []
        sps_helper = lc.RTSPSHelper()
        with open(path, "rb") as f:
            while len(dec_recons) < n:
                header = lc.rt_read_header(f)
                if header["nal_type"] == lc.RT_NAL_SPS:
                    sps_helper.add_sps_by_id(
                        lc.rt_read_sps_remaining(f, header["sps_id"]))
                    continue
                got = sps_helper.get_sps_by_id(header["sps_id"])
                ec_dec = got["ec_part"] + 1
                qp_f, stream = lc.rt_read_ip_remaining(f)
                if header["nal_type"] == lc.RT_NAL_I:
                    out = self.i_codec.decompress(
                        stream, qp_f, got["height"], got["width"], ec_dec)
                    self.p_codec.clear_dpb()
                    self.p_codec.add_ref_feature_from_frame(out["x_hat"])
                else:
                    out = self.p_codec.decompress(
                        stream, qp_f, got["height"], got["width"], ec_dec)
                dec_recons.append(_numpy(out["x_hat"]))
        dec_time = time.time() - t0

        total_bits = os.path.getsize(path) * 8
        result = {"frame_bpp": [total_bits / n / (h * w)] * n,
                  "frame_type": types,
                  "bitexact": not self.verify or all(
                      np.array_equal(a, b)
                      for a, b in zip(enc_recons, dec_recons))}
        result = self._summary(result, frames_rgb, dec_recons, enc_time,
                               dec_time)
        result["q_index"] = q
        return result
