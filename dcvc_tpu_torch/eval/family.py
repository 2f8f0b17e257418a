"""Legacy-family end-to-end evaluation (counterpart of
dcvc_tpu/eval/family.py): encode -> one NAL stream file -> decode from
disk -> metrics, for the pre-UF models.

The port runs DCVC-RT (`model="rt"`): its intra codec and P-frame codec,
its NAL container (bitstream/legacy_container.py: the SPS carries the
size and a 1-bit lane flag, each frame's IP NAL its qp), the qp_shift
schedule over INDEX_MAP (DCVC-RT/test_video.py:164-203), the
sequence-level lane pin (2 lanes at 1280x720 and above), and the DPB
reseeded from each intra frame.  The other models of the JAX runner (FM,
DC, HEM, TCM, DCVC) are not ported yet (ROADMAP.md §1 item 7) and raise.
The JAX runner's estimated-bits fast mode (run_sequence_fast) is not
ported: it never takes RT.

All legacy models work on RGB in [0, 1].  The codecs run in float32 on
every device, as dcvc_tpu's runner builds them (its RT codecs in f32 on
every backend, eval/family.py:157-167; the other legacy codecs default
to f32); bfloat16 only when the caller asks for it (`dtype`,
family_main --dtype bf16).  In float32 the RT intra trunk's
DepthConvBlocks take the plain PyTorch block on the card too
(layers/blocks.py kernel_path), as the reference's do.
"""

import math
import os
import time

import numpy as np
import torch

from ..bitstream import legacy_container as lc
from ..legacy.dcvc_rt import DMCRT, DMCRTCodec, DMCRTConfig, \
    INDEX_MAP as RT_INDEX_MAP, TINY_RT_CONFIG, shift_qp
from ..legacy.rt_intra import DMCIRT, DMCIRTConfig, TINY_RT_INTRA_CONFIG
from ..runtime.rt_image_codec import RTIntraCodec
from ..utils.jax_bridge import load_into, native_config
from ..utils.metrics import calc_psnr

MODELS = ("rt",)
NOT_PORTED = ("dcvc", "tcm", "hem", "dc", "fm")


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
    return type(codec)(model.state_dict(), cfg=cfg,
                       skip_thres=codec.skip_thres, dtype=codec.dtype,
                       device=codec.device)


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
            raise ValueError(
                f"model {model!r}: the port runs {MODELS}; "
                + (f"{model} is not ported yet (ROADMAP.md §1 item 7)"
                   if model in NOT_PORTED else "unknown model"))
        self.model = model
        self.stream_dir = stream_dir
        self.rate_num = rate_num
        self.verify = verify_bitexact
        self.device = torch.device(device)
        self.dtype = family_dtype(self.device, dtype)
        os.makedirs(stream_dir, exist_ok=True)
        self._build(seed, tiny)
        if model_path_i:
            self.i_codec = _with_params(self.i_codec, model_path_i, DMCIRT,
                                        DMCIRTConfig())
        if model_path_p:
            self.p_codec = _with_params(self.p_codec, model_path_p, DMCRT,
                                        DMCRTConfig())

    def _build(self, seed, tiny):
        kw = {"dtype": self.dtype, "device": self.device}
        self.i_codec = RTIntraCodec.init_random(
            torch.Generator().manual_seed(seed),
            cfg=TINY_RT_INTRA_CONFIG if tiny else None, **kw)
        self.p_codec = DMCRTCodec.init_random(
            torch.Generator().manual_seed(seed + 1),
            cfg=TINY_RT_CONFIG if tiny else None, init_scale=0.4, **kw)

    def run(self, frames_rgb, rate_indices, gop, seq_name="seq"):
        return {f"rate_{r}": self.run_sequence(frames_rgb, r, gop,
                                               f"{seq_name}_r{r}")
                for r in rate_indices}

    def run_sequence(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """frames_rgb: list of (3, h, w) uint8-valued arrays.  Returns a
        per-sequence result dict (bits / psnr per frame + averages)."""
        return self.run_sequence_rt(frames_rgb, rate_idx, gop, seq_name)

    # -------------------------------------------------------------- DCVC-RT

    def run_sequence_rt(self, frames_rgb, rate_idx, gop, seq_name="seq"):
        """DCVC-RT end-to-end: its NAL container (qp in the IP NAL), the RT
        intra codec, qp_shift = [0, 8, 4] over the fa schedule
        (DCVC-RT/test_video.py:164-203) and the SPS-pinned 1-bit
        entropy-coder parallelism."""
        h, w = frames_rgb[0].shape[1:]
        qp_num = self.p_codec.cfg.qp_num
        q64 = int(np.round(np.linspace(12, 51, max(self.rate_num, 2))
                           [min(rate_idx, self.rate_num - 1)]))
        q = int(round(q64 * (qp_num - 1) / 63))
        frames = [np.ascontiguousarray(
            f.transpose(1, 2, 0).astype(np.float32) / 255.0)[None]
            for f in frames_rgb]
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
                is_i = i % gop == 0 if gop > 0 else i == 0
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
                  "frame_psnr": [], "frame_type": types, "bitexact": True}
        for i in range(n):
            if self.verify and not np.array_equal(enc_recons[i],
                                                  dec_recons[i]):
                result["bitexact"] = False
            result["frame_psnr"].append(
                _psnr_rgb(dec_recons[i], frames_rgb[i]))
        result["avg_bpp"] = float(np.mean(result["frame_bpp"]))
        result["avg_psnr"] = float(np.mean(result["frame_psnr"]))
        i_mask = [t == 0 for t in types]
        result["avg_psnr_i"] = float(np.mean(
            [p for p, m in zip(result["frame_psnr"], i_mask) if m]))
        p_ps = [p for p, m in zip(result["frame_psnr"], i_mask) if not m]
        result["avg_psnr_p"] = float(np.mean(p_ps)) if p_ps else 0.0
        result["avg_frame_encoding_time"] = enc_time / n
        result["avg_frame_decoding_time"] = dec_time / n
        result["q_index"] = q
        return result
