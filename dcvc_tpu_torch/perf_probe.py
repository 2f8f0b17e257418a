"""Measurements of the port on the card, and the helpers chip_smoke.py
shares with them.

    python3 -m dcvc_tpu_torch.perf_probe shapes [--iters 50]
    python3 -m dcvc_tpu_torch.perf_probe profile [--runs 2]
    python3 -m dcvc_tpu_torch.perf_probe k2 [--symbols N] [--lanes n]
                                            [--clocks]
    python3 -m dcvc_tpu_torch.perf_probe tiles [--iters 50]
    python3 -m dcvc_tpu_torch.perf_probe train [--runs 1]
    python3 -m dcvc_tpu_torch.perf_probe legacy [--runs 2]
    python3 -m dcvc_tpu_torch.perf_probe fm|hem|dc|tcm [--runs 2]
    python3 -m dcvc_tpu_torch.perf_probe mask [--runs 2]
    python3 -m dcvc_tpu_torch.perf_probe pipeline [--runs 2]

`shapes` codes a warm 1080p DMCI frame (encode, decode) and, for each
video codec the checkout has (HTS, HTL, LD), a warm later 1080p chunk
(LD: frame; encode without recon, decode with it), all at qp 32 with
seeded random weights in bf16; where the checkout has the
device-entropy decode, every decode also runs through it.
A LaunchLog records the shape of every K1 launch these calls make; then
K1 and its plain version are timed at each distinct shape on random bf16
inputs (CUDA events, median of `iters` after 3 warm-ups).  It prints one
line per shape and K1's device time per call (sum of per-shape medians x
launches), then a JSON line of both.  To compare two checkouts in one
session on the card, copy this file into the other checkout's package and
run it from each root in turn: parent, change, change, parent.

`k2` times K2 on a synthetic stream coded by the host encoder (see
run_k2) against the host decoder's symbols, with its plain version's
time and its latency bound.  With --clocks it also runs K2's
cycle-counting build (-DK2_CLOCKS) on that stream and on every K2 call of
a recorded 1080p DMCI device decode, and prints where the cycles of a
symbol go (row fetch and CDF search, state update and renorm, escape
path, output store), the cycles per escape, and the SM clock under load
(cycles over %globaltimer ns).

`tiles` times each launch of K1's chain (torch.profiler) at the heaviest
main-path shapes under every GEMM tile the core has, and K1's host time
per call (run_tiles).

`profile` runs torch.profiler over the same warm calls, `runs` times
each.  Per call it prints the wall time (host clock around the call,
synchronised, profiler on), the device busy time (the union of the
intervals of every kernel, copy and memset the profiler saw on the card),
the device idle share (1 - busy / wall), the host time of the program's
entropy.* spans (utils/profiling.py: the host rANS coder, the lanes'
upload, K2's dispatch; null for a call that records no program span, as
the legacy codecs' and training's), and the kernels with the most device
time.

`legacy` profiles the legacy intra codecs, EVC and IntraNoAR at their
published widths in float32 (chip_smoke.py's weights), a warm encode and
decode at 1080p and 720p each, printing `profile`'s line per call
(run_legacy).

`fm`, `hem`, `dc` and `tcm` profile DCVC-FM's, DCVC-HEM's, DCVC-DC's and
DCVC-TCM's P-frame codecs at their published widths in float32
(chip_smoke.py's weights: lifted_fm, lifted_hem, lifted_dc, lifted_tcm):
a warm 1080p P frame's encode and decode, the DPB full, printing
`profile`'s line per call (run_p_frame).  These legacy codecs launch no
kernel of the port: float32, no K1Block, no K2 path
(tests/test_torch_layers.py::test_legacy_models_launch_no_kernel).

`train` builds each full-width training cell of TRAIN_CELLS (DMCI, LD,
HTS, HTL at their published widths in float32, TF32 off), takes one warm
step and then profiles `runs` steps, printing per step the JSON line of
`profile` (wall, device busy, idle share, top device operations).
chip_smoke.py times the same cells without the profiler.

`pipeline` times the codecs' pipelined calls against their serial
ones at 1080p, qp 32, in bf16 (pipeline_codecs: chip_smoke.py's seeded
weights): DMCI compress_many / decompress_many (host coder and K2) over
8 images, RT intra's over 4, and compress_sequence / decompress_sequence
(host coder and K2) of HTS over a DMCI frame + 6 chunks of 8 frames, HTL
over 3 chunks and LD over 8 frames, a reset in each (pipeline_cases).
Every compress_async and every K2 decode runs with host syncs an error,
and every run must give the encoder's bytes, frames and DPB.  Per job it
prints a JSON line (time_pipeline): the warm wall per unit of each form
(`runs` runs each, in turns), their ratio, and from one torch.profiler
run of each the device busy time and idle share.

`mask` profiles `runs` warm steps of EVC's mask decay at EVC_LL_CONFIG
(chip_smoke.py's weights and batch of 2 256x256 images, float32, TF32
off), printing `profile`'s line per step (run_mask_decay).

Needs one CUDA device; prints the card's name and power limit first.
"""

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import time
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .kernels import fused_dcb as K1
from .models.dmci import DMCIConfig
from .runtime.image_codec import DMCICodec
from .utils import profiling

QP = 32
H, W = 1080, 1920


class Launch(NamedTuple):
    """The shape of one K1 launch.  kind is 'fused_dcb' (s = 1) or
    'fused_dcb_stacked' (s entries); bcast: the stacked x is one tensor
    for every entry (a stack stride of 0); planes: the FFN's chunk-add
    sums `planes` planes of ffn_inner = 4 * inner / planes (UF's block 4,
    DCVC-RT's two-way block 2)."""
    kind: str
    s: int
    h: int
    w: int
    cin: int
    c: int
    inner: int
    adaptor: bool
    shortcut: bool
    bcast: bool
    planes: int = 4

    @property
    def ffn_inner(self):
        return 4 * self.inner // self.planes

    def __str__(self):
        stack = "" if self.kind == "fused_dcb" else f" S={self.s}"
        planes = "" if self.planes == 4 else f" planes={self.planes}"
        return (f"{self.kind}{stack} {self.h}x{self.w} {self.cin}->{self.c} "
                f"I={self.inner} adaptor={int(self.adaptor)} "
                f"shortcut={int(self.shortcut)} broadcast_x={int(self.bcast)}"
                f"{planes}")


class LaunchLog:
    """Inside `with log:`, records the Launch of every K1 launch, per
    labelled call (`with log.call(label):`; a launch outside a call
    raises).  It wraps the wrappers' launch functions and leaves the
    launch counts to them."""

    def __init__(self):
        self.calls = []                # (label, Counter of Launch)
        self._cur = None

    def __enter__(self):
        self._saved = {}
        for name, kind in (("fused_dcb_launch", "fused_dcb"),
                           ("fused_dcb_stacked_launch", "fused_dcb_stacked")):
            fn = getattr(K1, name, None)   # an older checkout has no stack
            if fn is not None:
                self._saved[name] = fn
                setattr(K1, name, self._recorder(fn, kind))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(K1, name, fn)

    def _recorder(self, fn, kind):
        def launch(x, ops, *args):
            # K-major operands: w2 (..., C, I), w1 (..., I, C), w3 (..., P,
            # I_ffn, C)
            c, inner = ops["w2"].shape[-2], ops["w1"].shape[-2]
            planes = ops["w3"].shape[-3]
            if kind == "fused_dcb":
                shortcut = bool(args[0]) if args else False
                key = Launch(kind, 1, *x.shape[1:], c, inner, "wa" in ops,
                             shortcut, False, planes)
            else:
                s = x.shape[0]
                key = Launch(kind, s, *x.shape[2:], c, inner, "wa" in ops,
                             False, s > 1 and x.stride(0) == 0, planes)
            if self._cur is None:
                raise AssertionError(f"K1 launched outside a labelled call: "
                                     f"{key}")
            self._cur[key] += 1
            return fn(x, ops, *args)
        return launch

    @contextlib.contextmanager
    def call(self, label):
        self._cur = collections.Counter()
        self.calls.append((label, self._cur))
        try:
            yield self._cur
        finally:
            self._cur = None

    def totals(self):
        """Counter of every Launch over every call."""
        total = collections.Counter()
        for _, counts in self.calls:
            total.update(counts)
        return total


@contextlib.contextmanager
def meta_launches():
    """Inside, K1's launch functions return an empty tensor of the
    launch's output shape instead of launching, so a model on the meta
    device runs its stages with no memory and no compute; a LaunchLog
    entered inside records the launches the card would make."""
    saved = K1.fused_dcb_launch, K1.fused_dcb_stacked_launch

    def launch(x, ops, shortcut=False):
        return x.new_empty(x.shape[:-1] + (ops["w2"].shape[-2],))

    def launch_stacked(x, ops):
        return x.new_empty(x.shape[:-1] + (ops["w2"].shape[-2],))
    K1.fused_dcb_launch, K1.fused_dcb_stacked_launch = launch, launch_stacked
    try:
        yield
    finally:
        K1.fused_dcb_launch, K1.fused_dcb_stacked_launch = saved


def ld_stage_launches(cfg, h, w):
    """The K1 launches of each stage of a DMC-LD codec call on an (h, w)
    frame, from the model itself: its stage methods run on the meta
    device, in the order the codec calls them.  Returns {stage: Counter
    of Launch} for the stages adaptor_i, adaptor_m, analysis, prior0,
    prior_step, synthesis_feature, reset_feature, recon_frames."""
    from .core.padding import get_padding_size
    from .models.dmc_ld import DMCLD
    pad_r, pad_b = get_padding_size(h, w, 16)
    ph, pw = h + pad_b, w + pad_r
    log = LaunchLog()
    with torch.device("meta"), meta_launches(), log:
        m = DMCLD(cfg).to(torch.bfloat16)

        def feat(ch):
            return torch.empty(1, ph // 8, pw // 8, ch, dtype=torch.bfloat16)

        def stage(name, fn, *args):
            with log.call(name):
                return fn(*args)
        memory, ctx = stage("adaptor_i", m.adaptor_i, feat(cfg.ch_src))
        stage("adaptor_m", m.adaptor_m, memory, feat(cfg.ch_d))
        x = torch.empty(1, ph, pw, 3, dtype=torch.bfloat16)
        y, z = stage("analysis", m.analysis, x, ctx, 0)
        yh, yw = y.shape[1], y.shape[2]
        params = stage("prior0", m.prior0, z, memory, 0, yh, yw)[4]
        y_hat = torch.empty(1, yh, yw, cfg.ch_y)
        stage("prior_step", m.prior_step, params, y_hat)
        feature = stage("synthesis_feature", m.synthesis_feature, y_hat,
                        ctx, 0)
        stage("reset_feature", m.reset_feature, feature)
        stage("recon_frames", m.recon_frames, feature, 0, h, w)
    return dict(log.calls)


def ht_stage_launches(cfg, h, w):
    """The K1 launches of each stage of a DMCHTCodec (HTS or HTL) call on
    an (h, w) chunk in bfloat16, from the model itself (its stage methods
    on the meta device, in the codec's order): adaptor_i, analysis,
    prior0, prior_step 1-3, synthesis_feature, adaptor_m, reset_feature,
    recon_frames.  Returns {stage: Counter of Launch}."""
    from .core.padding import get_padding_size
    from .models.dmc_ht import DMCHT
    pad_r, pad_b = get_padding_size(h, w, 16)
    ph, pw = h + pad_b, w + pad_r
    yh, yw = ph // 16, pw // 16
    log = LaunchLog()
    bf = torch.bfloat16

    def stage(name, fn, *args):
        with log.call(name):
            return fn(*args)
    with torch.device("meta"), meta_launches(), log:
        m = DMCHT(cfg).to(bf)
        seed = torch.empty(1, ph // 8, pw // 8, cfg.ch_src_intra, dtype=bf)
        memory, ctx = stage("adaptor_i", m.adaptor_i, seed)
        x = torch.empty(1, ph, pw, 3 * cfg.frame_delay, dtype=bf)
        _, z = stage("analysis", m.analysis, x, ctx, 0)
        spctx = stage("prior0", m.prior0, z, memory, 0, yh, yw)[4]
        y_hat = torch.empty(1, yh, yw, cfg.ch_y)
        for k in (1, 2, 3):
            stage(f"prior_step {k}", m.prior_step, spctx, y_hat, k)
        feature = stage("synthesis_feature", m.synthesis_feature, y_hat,
                        ctx, 0)
        stage("adaptor_m", m.adaptor_m, memory, feature)
        stage("reset_feature", m.reset_feature, feature)
        stage("recon_frames", m.recon_frames, feature, 0, h, w)
    return dict(log.calls)


def uf_call_launches(name, cfg, h, w):
    """K1 launches per codec call of a DCVC-UF codec at (h, w), from
    spatial_dmci_launches in one tile (the unsplit codec's) /
    ht_stage_launches: {"encode", "decode"} (S = 1) for DMCI ("dmci"); for
    HT ("hts" / "htl") also "first_encode" /
    "first_decode" (right after the intra frame or a reset: adaptor_i in
    adaptor_m's place) and "recon", the recon heads' (S = 1, stacked).
    Each entry is an int but recon's; "shapes" is the set of their
    Launches."""
    if name == "dmci":
        stages = spatial_dmci_launches(cfg, h, w, 1)
    else:
        stages = ht_stage_launches(cfg, h, w)
    n = {k: sum(v.values()) for k, v in stages.items()}
    shapes = set()
    for v in stages.values():
        shapes.update(v)
    steps = sum(n[f"prior_step {k}"] for k in (1, 2, 3))
    if name == "dmci":
        decode = n["prior0"] + steps + n["synthesis"]
        return {"encode": n["analysis"] + decode, "decode": decode,
                "shapes": shapes}
    trunk = n["prior0"] + steps + n["synthesis_feature"]
    recon = collections.Counter()
    for key, k in stages["recon_frames"].items():
        recon[key.kind] += k
    return {"encode": n["adaptor_m"] + n["analysis"] + trunk,
            "decode": n["adaptor_m"] + trunk,
            "first_encode": n["adaptor_i"] + n["analysis"] + trunk,
            "first_decode": n["adaptor_i"] + trunk,
            "recon": (recon["fused_dcb"], recon["fused_dcb_stacked"]),
            "shapes": shapes}


def spatial_dmci_launches(cfg, h, w, tiles):
    """The K1 launches of each stage of a DMCICodec split into `tiles` row
    tiles (parallel/spatial.SpatialSplit) on an (h, w) frame in bfloat16,
    from the model itself: the split analysis and synthesis over their
    tile shapes and the whole prior0 / prior_step 1-3, on the meta device.
    Returns {stage: Counter of Launch}; an encode runs every stage, a
    decode all but the analysis."""
    from .core.padding import get_padding_size
    from .models.dmci import DMCI
    from .parallel.spatial import SpatialSplit
    pad_r, pad_b = get_padding_size(h, w, 16)
    ph, pw = h + pad_b, w + pad_r
    yh, yw = ph // 16, pw // 16
    log = LaunchLog()

    def stage(name, fn, *args):
        with log.call(name):
            return fn(*args)
    with torch.device("meta"), meta_launches(), log:
        m = DMCI(cfg).to(torch.bfloat16)
        split = SpatialSplit(m, ["meta"] * tiles)
        x = torch.empty(1, ph, pw, 3, dtype=torch.bfloat16)
        _, z = stage("analysis", split.analysis, x, 0)
        ctx = stage("prior0", m.prior0, z, yh, yw)[2]
        y_hat = torch.empty(1, yh, yw, cfg.ch_y)
        for k in (1, 2, 3):
            stage(f"prior_step {k}", m.prior_step, ctx, y_hat, k)
        stage("synthesis", split.synthesis, y_hat, 0, h, w)
    return dict(log.calls)


def rt_stage_launches(intra_cfg, p_cfg, h, w, dtype=torch.bfloat16):
    """The K1 launches of each stage of DCVC-RT's codecs on an (h, w)
    frame, from the models themselves (their stage methods on the meta
    device, in the codecs' order): the intra model's analysis, prior0,
    prior_step 1-3 and synthesis (RTIntraCodec), and the P model's
    adaptor_i, adaptor_m, analysis, prior0, prior_step, synthesis_feature,
    reset_feature and recon_frames (DMCRTCodec; its two-way DCBs launch
    K1's two-plane form, planes=2, wherever their channel counts are
    multiples of 16).  Returns {stage: Counter of Launch}, the P stages
    prefixed `p.`.  dtype: the codecs' (in float32 every
    DCB takes the plain block, as layers/blocks.py kernel_path says)."""
    from .core.padding import get_padding_size
    from .legacy.dcvc_rt import DMCRT
    from .legacy.rt_intra import DMCIRT
    pad_r, pad_b = get_padding_size(h, w, 16)
    ph, pw = h + pad_b, w + pad_r
    yh, yw = ph // 16, pw // 16
    log = LaunchLog()
    bf = dtype

    def stage(name, fn, *args):
        with log.call(name):
            return fn(*args)
    with torch.device("meta"), meta_launches(), log:
        m = DMCIRT(intra_cfg).to(bf)
        x = torch.empty(1, ph, pw, 3, dtype=bf)
        _, z = stage("analysis", m.analysis, x, 0)
        ctx, q_dec = stage("prior0", m.prior0, z, yh, yw)[2::2]
        y_hat = torch.empty(1, yh, yw, intra_cfg.ch_y)
        for k in (1, 2, 3):
            stage(f"prior_step {k}", m.prior_step, ctx, y_hat, k)
        stage("synthesis", m.synthesis, y_hat, q_dec, 0, h, w)

        p = DMCRT(p_cfg).to(bf)
        ref = torch.empty(1, ph // 8, pw // 8, p_cfg.ch_src_d, dtype=bf)
        feature = stage("p.adaptor_i", p.adaptor_i, ref)[0]
        stage("p.adaptor_m", p.adaptor_m, feature, feature)
        _, z = stage("p.analysis", p.analysis, x, feature, 0)
        spctx = stage("p.prior0", p.prior0, z, feature, 0, yh, yw)[4]
        y_hat = torch.empty(1, yh, yw, p_cfg.ch_y)
        stage("p.prior_step", p.prior_step, spctx, y_hat)
        out = stage("p.synthesis_feature", p.synthesis_feature, y_hat,
                    feature, 0)
        stage("p.reset_feature", p.reset_feature, out)
        stage("p.recon_frames", p.recon_frames, out, 0, h, w)
    return dict(log.calls)


# ----------------------------------------------- the legacy codecs' weights

# The legacy intra codecs' seeded random weights on the card: the JAX
# runner's init_scale 0.4, under which y and z are ~0.05 at full width
# and every symbol codes as 0; so y is lifted 50x (EVC: q_basic / 50, which
# synthesis multiplies back; IntraNoAR, whose q_basic is bounded below at
# 0.5: the encoder's last conv x 50), the hyper encoder's last conv is
# lifted (EVC 8x, IntraNoAR 400x: its hyper encoder has five damped convs)
# and the scale parts of the prior outputs' last biases by 2, so that z
# and y symbols spread over the CDF rows (~2.3 bpp at 256x256).
LEGACY_INIT_SCALE = 0.4
LEGACY_Y_GAIN = 50.0
LEGACY_Z_GAIN = {"EVC": 8.0, "IntraNoAR": 400.0}


def lifted_legacy_intra(model_cls, cfg, seed):
    """The float32 legacy intra model (EVC or IntraNoAR, on the CPU) of the
    smoke: seeded random weights at LEGACY_INIT_SCALE, lifted as above."""
    from .legacy.evc import EVC
    from .legacy.fm_layers import damp_kernels_
    model = model_cls(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    damp_kernels_(model, LEGACY_INIT_SCALE)
    n = cfg.n
    with torch.no_grad():
        if isinstance(model, EVC):
            model.q_basic.div_(LEGACY_Y_GAIN)
            model.hyper_enc[3].weight.mul_(LEGACY_Z_GAIN["EVC"])
            fusion = model.y_prior_fusion[1].block[1].conv[2].bias
            spatial = model.y_spatial_prior[2].block[1].conv[2].bias
        else:
            model.enc.layers_6.conv.weight.mul_(LEGACY_Y_GAIN)
            model.hyper_enc.layers_8.conv.weight.mul_(
                LEGACY_Z_GAIN["IntraNoAR"])
            fusion = model.y_prior_fusion.layers_4.conv.bias
            spatial = model.y_spatial_prior.layers_4.conv.bias
        fusion[n:2 * n] += 2.0
        spatial[:n // 2] += 2.0
        spatial[n:n + n // 2] += 2.0
    return model


# DCVC-FM's seeded random weights on the card: at the codec's init_scale
# 0.4 and q anchors at one every y and mv symbol codes as 0 and every
# q_index gives q = 1.  So the kernels are damped by `init_scale`, the
# last convs of the contextual and mv encoders are lifted (y_gain,
# mv_gain), and those of the two hyper encoders (z_gain, mv_z_gain), the
# scale parts of the prior fusions' and spatial priors' last biases by
# scale_bias, and the q anchors spread (q_enc: min, max of the encoders'
# scalars; q_dec: the decoders'), so that y, mv and z symbols are coded
# and each q_index has its own quant scalars; the reconstruction's last
# conv is lifted (recon_gain, recon_bias), whose output is ~1e-5 at 0.4,
# so that x_hat spreads over [0, 1] instead of clamping to 0.
FM_LIFT = {"init_scale": LEGACY_INIT_SCALE, "y_gain": 300.0,
           "mv_gain": 1000.0, "z_gain": 5.0, "mv_z_gain": 10.0,
           "scale_bias": 2.0, "q_enc": (0.5, 2.0), "q_dec": (2.0, 0.5),
           "recon_gain": 1e4, "recon_bias": 0.5}


def lifted_fm(cfg, seed, lift=None, model_cls=None):
    """A float32 DMCFM, or a DMCDC (`model_cls`; DCVC-DC has FM's module
    names where the lift applies), on the CPU with seeded random weights
    (reset_parameters, as the codecs' init_random draws them), lifted as
    `lift` (FM_LIFT when None) says; DC's anchors are spread
    log-uniformly between the q_enc / q_dec pairs."""
    from .legacy.dcvc_fm import DMCFM
    lift = FM_LIFT if lift is None else lift
    m = (model_cls or DMCFM)(cfg)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.damp_(lift["init_scale"])
        for side in ("mv_y", "y"):
            for end in ("enc", "dec"):
                lo, hi = lift[f"q_{end}"]
                if hasattr(m, f"{side}_q_{end}"):
                    q = getattr(m, f"{side}_q_{end}")
                else:
                    q = getattr(m, f"{side}_q_scale_{end}")
                n = q.shape[0]
                q.copy_(torch.tensor([lo * (hi / lo) ** (i / (n - 1))
                                      for i in range(n)]).view(q.shape))
        m.contextual_encoder.conv4.conv.weight.mul_(lift["y_gain"])
        m.mv_encoder.enc_3_2.conv.weight.mul_(lift["mv_gain"])
        m.contextual_hyper_prior_encoder[-1].conv.weight.mul_(
            lift["z_gain"])
        m.mv_hyper_prior_encoder[-1].conv.weight.mul_(lift["mv_z_gain"])
        for fusion, spatial, ch in ((m.y_prior_fusion, m.y_spatial_prior,
                                     cfg.ch_16x),
                                    (m.mv_y_prior_fusion,
                                     m.mv_y_spatial_prior, cfg.ch_mv)):
            fusion.layers_1.ffn.conv2.conv.bias[ch:2 * ch] += \
                lift["scale_bias"]
            spatial.layers_2.ffn.conv2.conv.bias[:ch] += lift["scale_bias"]
        recon = m.recon_generation_net.recon_conv.conv
        recon.weight.mul_(lift["recon_gain"])
        recon.bias.add_(lift["recon_bias"])
    return m


# DCVC-DC's on the card: FM's lift (its modules, anchors and symbols
# behave as FM's at init_scale 0.4)
DC_LIFT = dict(FM_LIFT)


def lifted_dc(cfg, seed, lift=None):
    """A float32 DMCDC (on the CPU) with seeded random weights, lifted as
    `lift` (DC_LIFT when None) says (lifted_fm)."""
    from .legacy.dcvc_dc import DMCDC
    return lifted_fm(cfg, seed, DC_LIFT if lift is None else lift, DMCDC)


# DCVC-HEM's seeded random weights on the card: at the codec's
# init_scale 0.4 every symbol codes as 0, so the kernels are damped by
# `init_scale`, the last convs of the contextual and mv encoders (y_gain,
# mv_gain) and of the two hyper encoders (z_gain, mv_z_gain) are lifted,
# the scale parts of the prior fusions' and spatial priors' last biases
# by scale_bias, and the reconstruction's last conv (recon_gain,
# recon_bias) so that x_hat spreads over [0, 1].  Its q scales come from
# the runner's ladders, so the q vectors stay at one.
HEM_LIFT = {"init_scale": LEGACY_INIT_SCALE, "y_gain": 300.0,
            "mv_gain": 1000.0, "z_gain": 5.0, "mv_z_gain": 10.0,
            "scale_bias": 2.0, "recon_gain": 1e4, "recon_bias": 0.5}


def lifted_hem(cfg, seed, lift=None):
    """A float32 DMCHEM (on the CPU) with seeded random weights
    (reset_parameters, as DMCHEMCodec.init_random draws them), lifted as
    `lift` (HEM_LIFT when None) says."""
    from .legacy.dcvc_hem import DMCHEM
    lift = HEM_LIFT if lift is None else lift
    m = DMCHEM(cfg)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.damp_(lift["init_scale"])
        m.ce_conv4.conv.weight.mul_(lift["y_gain"])
        m.mv_encoder.layers_6.conv.weight.mul_(lift["mv_gain"])
        m.contextual_hyper_prior_encoder.layers_4.conv.weight.mul_(
            lift["z_gain"])
        m.mv_hyper_prior_encoder.layers_8.conv.weight.mul_(
            lift["mv_z_gain"])
        for fusion, spatial, ch in ((m.y_prior_fusion, m.y_spatial_prior,
                                     cfg.ch_m),
                                    (m.mv_y_prior_fusion,
                                     m.mv_y_spatial_prior, cfg.ch_mv)):
            fusion.layers_4.conv.bias[ch:2 * ch] += lift["scale_bias"]
            bias = spatial.layers_4.conv.bias
            bias[:ch // 2] += lift["scale_bias"]
            bias[ch:ch + ch // 2] += lift["scale_bias"]
        recon = m.rg_recon_conv.conv
        recon.weight.mul_(lift["recon_gain"])
        recon.bias.add_(lift["recon_bias"])
    return m


# The DCVC-2021 P model's seeded random weights on the card: at the JAX
# runner's init_scale 0.4 the GDN ladders leave mv_y ~1e-3 and y ~1e-2,
# so every symbol codes as 0.  The last convs of the mv and contextual
# encoders (mv_gain, y_gain) and of the two hyper encoders (mv_z_gain,
# z_gain) are lifted, the scale halves of the entropy-parameter chains'
# last biases by scale_bias, and the reconstruction's last conv
# (recon_gain, recon_bias) so that x_hat spreads over [0, 1].
DCVC_LIFT = {"init_scale": LEGACY_INIT_SCALE, "mv_gain": 8000.0,
             "y_gain": 600.0, "mv_z_gain": 300.0, "z_gain": 100.0,
             "scale_bias": 2.0, "recon_gain": 10.0, "recon_bias": 0.5}


def lifted_dcvc(cfg, seed, lift=None):
    """A float32 DCVCNet (on the CPU) with seeded random weights
    (reset_parameters, as DCVCCodec.init_random draws them), lifted as
    `lift` (DCVC_LIFT when None) says."""
    from .legacy.dcvc_net import DCVCNet
    lift = DCVC_LIFT if lift is None else lift
    m = DCVCNet(cfg)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.damp_(lift["init_scale"])
        m.mv_encoder.layers_6.weight.mul_(lift["mv_gain"])
        m.contextual_encoder.layers_8.weight.mul_(lift["y_gain"])
        m.mv_prior_encoder.layers_4.weight.mul_(lift["mv_z_gain"])
        m.prior_encoder.layers_4.weight.mul_(lift["z_gain"])
        for ep, ch in ((m.entropy_parameters, cfg.ch_m),
                       (m.entropy_parameters_mv, cfg.ch_mv)):
            ep.layers_4.bias[ch:] += lift["scale_bias"]   # (means, scales)
        recon = m.contextual_decoder_part2.layers_3
        recon.weight.mul_(lift["recon_gain"])
        recon.bias.add_(lift["recon_bias"])
    return m



# DCVC-TCM's seeded random weights on the card: as DCVC-2021's, at the
# JAX runner's init_scale 0.4 the GDN ladders leave mv_y and y far below
# one and every symbol codes as 0.  The last convs of the mv and
# contextual encoders (mv_gain, y_gain) and of the two hyper encoders
# (mv_z_gain, z_gain) are lifted, the scale halves of the mv prior
# decoder's and the entropy-parameter chain's last biases by scale_bias,
# the mv decoder's last deconv (mv_hat_gain, so that the flow moves a
# pixel or so) and the reconstruction's last conv (recon_gain,
# recon_bias) so that x_hat spreads over [0, 1].  The gains are for
# TCM_CONFIG (at 128x128: mv_y ~2, mv_z ~4, |mv_hat| ~0.8, y ~1.5, z ~3.7
# on average); the tests' narrow configs take their own.
TCM_LIFT = {"init_scale": LEGACY_INIT_SCALE, "mv_gain": 2.4e4,
            "mv_hat_gain": 400.0, "y_gain": 1200.0, "mv_z_gain": 100.0,
            "z_gain": 100.0, "scale_bias": 2.0, "recon_gain": 100.0,
            "recon_bias": 0.5}


def lifted_tcm(cfg, seed, lift=None):
    """A float32 DMCTCM (on the CPU) with seeded random weights
    (reset_parameters, as DMCTCMCodec.init_random draws them), lifted as
    `lift` (TCM_LIFT when None) says."""
    from .legacy.dcvc_tcm import DMCTCM
    lift = TCM_LIFT if lift is None else lift
    m = DMCTCM(cfg)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.damp_(lift["init_scale"])
        m.mv_encoder.layers_12.weight.mul_(lift["mv_gain"])
        m.ce_conv4.weight.mul_(lift["y_gain"])
        m.mv_decoder.layers_8.weight.mul_(lift["mv_hat_gain"])
        m.mv_prior_encoder.layers_4.weight.mul_(lift["mv_z_gain"])
        m.contextual_hyper_prior_encoder.layers_4.weight.mul_(
            lift["z_gain"])
        # (scales, means) halves
        m.mv_prior_decoder.layers_4.bias[:cfg.ch_mv] += lift["scale_bias"]
        m.contextual_entropy_parameter.layers_4.bias[:cfg.ch_m] += \
            lift["scale_bias"]
        m.rg_recon_conv.weight.mul_(lift["recon_gain"])
        m.rg_recon_conv.bias.add_(lift["recon_bias"])
    return m


# The CompressAI intra models' seeded random weights (the JAX codecs'
# init_scale 1.0): hyperprior's y and z are ~0.3 / ~0.1 and its relu
# scales 0, cheng2020's z ~0.1, so y (y_gain) and z (z_gain, the hyper
# encoder's last conv) are lifted and the scales by scale_bias; the
# reconstructions are centred at recon_bias (hyperprior's is ~0.03,
# cheng2020's reaches +-40 at TINY, so its last subpel conv is damped by
# recon_gain).
COMPRESSAI_LIFT = {
    "bmshj2018": {"y_gain": 4.0, "z_gain": 20.0, "scale_bias": 1.0,
                  "recon_gain": 1.0, "recon_bias": 0.5},
    "cheng2020": {"y_gain": 2.0, "z_gain": 20.0, "scale_bias": 1.0,
                  "recon_gain": 0.02, "recon_bias": 0.5}}


def lifted_compressai(name, cfg, seed, lift=None):
    """A float32 ScaleHyperprior (`name` bmshj2018) or Cheng2020Anchor
    (cheng2020) on the CPU with seeded random weights (reset_parameters,
    as the codecs' init_random draws them), lifted as `lift`
    (COMPRESSAI_LIFT[name] when None) says."""
    from .legacy.compressai_zoo import Cheng2020Anchor, ScaleHyperprior
    lift = COMPRESSAI_LIFT[name] if lift is None else lift
    cheng = name == "cheng2020"
    m = (Cheng2020Anchor if cheng else ScaleHyperprior)(cfg)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.g_a_layers_6.weight.mul_(lift["y_gain"])
        (m.h_a_layers_4 if cheng else m.h_a_layers_2).weight.mul_(
            lift["z_gain"])
        if cheng:                   # (scales, means) halves
            m.ep_layers_2.bias[:cfg.N] += lift["scale_bias"]
            recon = m.g_s_layers_7.conv
        else:
            m.h_s_layers_2.bias.add_(lift["scale_bias"])
            recon = m.g_s_layers_6
        recon.weight.mul_(lift["recon_gain"])
        recon.bias.add_(lift["recon_bias"])
    return m


# ------------------------------------------------------------------ K2

class K2Call(NamedTuple):
    """One call of K2 on the main path, its inputs kept for a replay:
    the lanes (shared by a decode's calls), the state going in, idx, the
    count tensor (or int) and the bank (rows) of the call."""
    label: str
    streams: torch.Tensor
    st: torch.Tensor
    ptr: torch.Tensor
    idx: torch.Tensor
    count: object
    bank: dict

    def args(self):
        return ({"streams": self.streams, "st": self.st, "ptr": self.ptr},
                self.idx, self.count, self.bank)

    def signature(self):
        """Its shape: (lanes, lane bytes, cap, bank rows)."""
        return (self.streams.shape[0], self.streams.shape[1],
                self.idx.shape[0], self.bank["cdf"].shape[0])


class K2Log:
    """Inside `with log:`, keeps the inputs of every launch of K2 (wrapping
    the wrapper's launch function; the codecs call it through
    kernels.rans_decode.rans_decode), under the label set by
    `log.label`."""

    def __init__(self):
        self.calls = []
        self.label = None

    def __enter__(self):
        from .kernels import rans_decode as K2
        self._k2 = K2
        self._saved = K2.rans_decode_launch

        def launch(state, idx, count, bank):
            self.calls.append(K2Call(
                self.label, state["streams"], state["st"], state["ptr"], idx,
                count, bank))
            return self._saved(state, idx, count, bank)
        K2.rans_decode_launch = launch
        return self

    def __exit__(self, *exc):
        self._k2.rans_decode_launch = self._saved


def k2_fixtures():
    """The cases of tests/test_device_decode.py and
    tests/test_pallas_decode.py, made with numpy from their seeds and
    encoded by the port's host coder: [(name, n_lanes, stream, calls)],
    calls = [(idx (cap,) uint8, count, cdf, lengths, want)] on one lane
    state, want = the host decoder's symbols of the call."""
    import numpy as np
    from .entropy.cdf import pmf_to_quantized_cdf
    from .rans import RansDecoder, RansEncoder

    def bank(rng, n_cdf, alphabet):
        per = alphabet + 2
        cdf = np.zeros((n_cdf, per), np.int32)
        for i in range(n_cdf):
            cdf[i] = pmf_to_quantized_cdf(
                rng.dirichlet(np.full(alphabet + 1, 0.6)))
        return cdf, np.full((n_cdf,), per, np.int32)

    def pad(idx, cap):
        out = np.zeros(cap, np.uint8)
        out[:idx.size] = idx
        return out

    def coders(n_lanes, y_bank, z_bank=None):
        enc, dec = RansEncoder(), RansDecoder()
        for c in (enc, dec):
            c.set_cdf(*y_bank, 1)
            if z_bank is not None:
                c.set_cdf(*z_bank, 0)
            c.set_parallel(n_lanes)
        enc.reset()
        return enc, dec

    cases = []
    for n_lanes, seed, n, cap in [(1, 101, 1001, 1017), (2, 102, 1002, 1018),
                                  (3, 103, 1003, 1019), (5, 105, 1005, 1021),
                                  (8, 108, 1008, 1024), (8, 5, 5, 256),
                                  (3, 6, 0, 64)]:
        rng = np.random.default_rng(seed)
        yb = bank(rng, 7, 12)
        idx = rng.integers(0, 7, n).astype(np.uint8)
        sym = rng.integers(-5, 6, n).astype(np.int8)
        esc = rng.random(n) < 0.02          # bypass escapes
        sym[esc] = rng.integers(30, 120, esc.sum())
        enc, dec = coders(n_lanes, yb)
        enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
        enc.flush()
        stream = enc.get_encoded_stream()
        dec.set_stream(stream)
        want = np.zeros(0, np.int8)
        if n:
            dec.decode_y(idx)
            want = dec.get_decoded(n)
        name = (f"y {n_lanes} lanes, {n} symbols, {int(esc.sum())} escapes"
                if n >= n_lanes else f"y {n_lanes} lanes, count {n}")
        cases.append((name, n_lanes, stream,
                      [(pad(idx, cap), n, *yb, want)]))

    # z -> y1 -> y2 on one state (the decode ladder)
    rng = np.random.default_rng(17)
    n_lanes, ch, qp, nz, cap = 8, 4, 2, 256, 1024
    zb, yb = bank(rng, 12, 16), bank(rng, 9, 10)
    z = rng.integers(-7, 8, nz).astype(np.int8)
    i1 = rng.integers(0, 9, 700).astype(np.uint8)
    i2 = rng.integers(0, 9, 500).astype(np.uint8)
    s1 = rng.integers(-4, 5, 700).astype(np.int8)
    s2 = rng.integers(-4, 5, 500).astype(np.int8)
    enc, dec = coders(n_lanes, yb, zb)
    enc.encode_y(((s2.astype(np.int16) << 8) | i2).astype(np.int16))
    enc.encode_y(((s1.astype(np.int16) << 8) | i1).astype(np.int16))
    enc.encode_z(z, qp * ch, ch)
    enc.flush()
    stream = enc.get_encoded_stream()
    dec.set_stream(stream)
    dec.decode_z(nz, qp * ch, ch)
    wz = dec.get_decoded(nz)
    dec.decode_y(i1)
    w1 = dec.get_decoded(700)
    dec.decode_y(i2)
    w2 = dec.get_decoded(500)
    zrows = slice(qp * ch, qp * ch + ch)
    cases.append(("z -> y1 -> y2, 8 lanes", n_lanes, stream, [
        ((np.arange(nz) % ch).astype(np.uint8), nz, zb[0][zrows],
         zb[1][zrows], wz),
        (pad(i1, cap), 700, *yb, w1), (pad(i2, cap), 500, *yb, w2)]))
    return cases


# where the symbols of k2_pattern_stream escape: none, all, one every k
# (position % k == k // 2), or the first / last symbol of every fifth
# aligned group of 16
K2_PATTERNS = ("none", "all", "every 1", "every 15", "every 16", "every 17",
               "every 100", "group first", "group last")


def k2_pattern_escapes(pattern, n):
    """The (n,) bool mask of the symbols that escape under `pattern`."""
    import numpy as np
    pos = np.arange(n)
    if pattern == "none":
        return np.zeros(n, bool)
    if pattern == "all":
        return np.ones(n, bool)
    if pattern.startswith("every "):
        k = int(pattern.split()[1])
        return pos % k == k // 2
    return pos % 80 == (0 if pattern == "group first" else 15)


def k2_escape_stream(escapes, n_lanes, seed, wide=False):
    """len(escapes) y symbols coded by the host encoder over n_lanes lanes,
    escaping where the bool mask `escapes` is set, on the rows of the
    Gaussian bank (skip 0.15) with 7 entries: a symbol in -2..2 is coded
    without escape, one of 3..127 in size escapes; wide: rows from the
    whole bank and escapes of 64..127 in size, which escape in every row.
    Returns (stream, idx (n,) uint8, sym (n,) int8, cdf, lengths)."""
    import numpy as np
    from .entropy.gaussian import GaussianConditional
    from .rans import RansEncoder
    cdf, lengths = GaussianConditional(0.15).compute_cdf_bank()
    rng = np.random.default_rng(seed)
    n, n_esc = len(escapes), int(escapes.sum())
    rows = np.arange(len(lengths)) if wide else np.nonzero(lengths == 7)[0]
    idx = rng.choice(rows, n).astype(np.uint8)
    sym = rng.integers(-2, 3, n)
    sym[escapes] = rng.choice([-1, 1], n_esc) * rng.integers(
        64 if wide else 3, 128, n_esc)
    sym = sym.astype(np.int8)
    enc = RansEncoder()
    enc.set_cdf(cdf, lengths, 1)
    enc.set_parallel(n_lanes)
    enc.reset()
    enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
    enc.flush()
    return enc.get_encoded_stream(), idx, sym, cdf, lengths


def k2_pattern_stream(pattern, n_lanes, n, seed):
    """k2_escape_stream of n symbols with escapes where `pattern` puts
    them; "all" on the whole bank (wide)."""
    return k2_escape_stream(k2_pattern_escapes(pattern, n), n_lanes, seed,
                            wide=pattern == "all")


def run_k2_case(case, dev, decode):
    """A fixture's calls through `decode` (K2's wrapper, its launch or its
    plain version) on `dev`.  Returns (final state, outputs)."""
    from .kernels.rans_decode import make_bank
    from .rans.device_decode import init_state, upload_lanes
    _, n_lanes, stream, calls = case
    state = init_state(upload_lanes(stream, n_lanes, dev))
    outs = []
    for idx, count, cdf, lengths, _ in calls:
        state, out = decode(
            state, torch.from_numpy(idx).to(dev),
            torch.tensor(count, dtype=torch.int32, device=dev),
            make_bank(cdf, lengths, dev))
        outs.append(out)
    return state, outs


# One symbol step's dependent chain (rans.cc dec_symbol): cum = st & mask,
# the compare that finds s, the select of cdf[s] / cdf[s + 1], the
# multiply-add of the new state, the renorm compare, the shift-or of the
# pulled byte: 6 dependent integer operations, each at least 4 cycles on
# Hopper's integer pipes.  The row, the byte and the next index do not
# depend on the state and can be fetched ahead.
K2_STEP_OPS = 6
# One bypass escape in closed form (csrc/rans_decode.cu): the compare of
# the state that gives j; the select of Y (the state's low 2j
# bits and the byte window shifted by 2j; the five shifts of the window
# need not wait for the state); the 3-input AND that marks the chunks that
# are not 3; the find-first-set that gives the run of 3s and so the count
# prefix; the multiply-add of n_bypass into the chunk count; the shift of
# the (parked state | next byte) by the count that gives the new state.
# 6 dependent operations; the raw value and the bytes taken are off the
# chain.
K2_ESCAPE_OPS = 6
K2_OP_CYCLES = 4


def k2_lane_sizes(count, n):
    """The symbols of each of the n lanes of a call (rans.cc's split)."""
    size0 = count // n
    return [size0] * (n - 1) + [count - size0 * (n - 1)]


def k2_lane_escapes(call, out):
    """The escaped symbols of each lane of a K2 call (K2Call), from its
    decoded symbols `out` (the plain version's): a symbol escaped if its
    value (zig-zag undone) is at least its row's len - 2.  A list of n
    ints."""
    count = int(call.count)
    n = call.streams.shape[0]
    sym = out[:count].to(torch.int64).cpu()
    rows = call.idx[:count].to(torch.int64).cpu().clamp_max(
        call.bank["len"].shape[0] - 1)
    value = 2 * sym.abs() - (sym > 0).to(torch.int64)
    esc = value >= call.bank["len"].cpu().to(torch.int64)[rows] - 2
    bounds = torch.tensor([0] + k2_lane_sizes(count, n)).cumsum(0).tolist()
    return [int(esc[a:b].sum()) for a, b in zip(bounds, bounds[1:])]


def k2_latency_bound_ms(calls, clock_mhz, escapes=None):
    """The least time of K2 on these calls: each lane is one dependent
    chain, so a call takes at least its longest lane's chain, K2_STEP_OPS
    dependent integer operations per symbol plus K2_ESCAPE_OPS per escaped
    symbol (escapes: each call's per-lane escape counts, k2_lane_escapes;
    None counts none: the symbols-only bound), each of K2_OP_CYCLES cycles at
    the SM clock; summed over the calls."""
    cycles = 0
    for i, c in enumerate(calls):
        sizes = k2_lane_sizes(int(c.count), c.streams.shape[0])
        esc = escapes[i] if escapes is not None else [0] * len(sizes)
        cycles += max(K2_STEP_OPS * n + K2_ESCAPE_OPS * e
                      for n, e in zip(sizes, esc)) * K2_OP_CYCLES
    return cycles / (clock_mhz * 1e3)


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16
# tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def k1_bound_ms(key):
    """(ms at the bf16 peak for the launch's matrix-product FLOPs, ms at
    the memory rate for its bytes: x read once (once for all entries when
    broadcast), weights and biases read once, the output written once;
    all bf16) of one K1 launch of shape `key`.  The bound is the larger."""
    pix = key.h * key.w
    i, c = key.inner, key.c
    # dc_in, dc_out, FFN (ffn_out's K is the FFN's inner width)
    macs = c * i + i * c + 4 * c * i + key.ffn_inner * c
    weights = macs + 9 * i + 2 * i + 4 * i + 3 * c    # + dw kernel, biases
    if key.adaptor:
        macs += key.cin * c
        weights += key.cin * c + c
    flops = key.s * pix * (2 * macs + 2 * 9 * i)
    x_reads = 1 if key.bcast else key.s
    nbytes = 2 * (x_reads * pix * key.cin + key.s * weights
                  + key.s * pix * c)
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S


# K1's kernels, one per launch of its chain (csrc/fused_dcb.cu), in order;
# the GEMMs run on the wgmma/TMA core
K1_KERNELS = ("k1_adaptor", "k1_h", "k1_dw", "k1_dc_out", "k1_ffn_in",
              "k1_ffn_out")
K1_GEMMS = tuple(k for k in K1_KERNELS if k != "k1_dw")


def k1_launch_flops(key):
    """The FLOPs of each launch of K1's chain at shape `key`, by kernel."""
    pix = key.s * key.h * key.w
    ci = key.c * key.inner
    flops = {"k1_h": 2 * pix * ci, "k1_dw": 2 * 9 * pix * key.inner,
             "k1_dc_out": 2 * pix * ci, "k1_ffn_in": 8 * pix * ci,
             "k1_ffn_out": 2 * pix * key.c * key.ffn_inner}
    if key.adaptor:
        flops["k1_adaptor"] = 2 * pix * key.cin * key.c
    return flops


def kernel_label(name):
    """'k1_h<128, 256>' from a demangled or mangled name of one of K1's
    kernels (a profiler event, a cuobjdump function), else None."""
    import re
    m = re.search(r"(k1_[a-z0-9_]*[a-z0-9])(?:<([0-9, ]+)>|I((?:Li\d+E)+)E)?",
                  name)
    if m is None:
        return None
    base, demangled, mangled = m.groups()
    args = (demangled.replace(" ", "") if demangled else
            ",".join(re.findall(r"Li(\d+)E", mangled)) if mangled else "")
    return f"{base}<{args}>" if args else base


def sass_counts(lib):
    """{kernel label: {'HGMMA': n, 'UTMALDG': n, 'HMMA': n}} of every
    function in the built library `lib`, from cuobjdump -sass."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1)) or m.group(1)
            counts[cur] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
        elif cur is not None:
            for op in counts[cur]:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def profile_launches(run, runs=5):
    """Device time of each of K1's kernels in a run of run() (a call of
    K1, which launches each kernel once), from torch.profiler over `runs`
    runs: {kernel: mean ms of its recorded launches}.  A first profile is
    discarded: the tracer may drop the events of its first one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
    us = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        label = kernel_label(e.name)
        if label is not None:
            us[label.split("<")[0]].append(e.time_range.elapsed_us())
    return {k: sum(v) / len(v) / 1e3 for k, v in us.items()}


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of fn() over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def random_block(cin, c, inner, adaptor, gen, planes=4):
    """DCB weights in fused_dcb layout, lecun-scaled, non-zero biases; the
    FFN sums `planes` chunks (fused_dcb.ffn_planes)."""
    def w(i, o):
        return torch.randn(i, o, generator=gen) / i ** 0.5

    def b(n):
        return 0.1 * torch.randn(n, generator=gen)
    p = {}
    if adaptor:
        p["wa"], p["ba"] = w(cin, c), b(c)
    p["w1"], p["b1"] = w(c, inner), b(inner)
    p["wd"], p["bd"] = torch.randn(3, 3, inner, generator=gen) / 3.0, b(inner)
    p["w2"], p["b2"] = w(inner, c), b(c)
    p["w3"], p["b3"] = w(c, 4 * inner), b(4 * inner)
    p["w4"], p["b4"] = w(4 * inner // planes, c), b(c)
    return p


def block_inputs(key, gen, dev):
    """Random bf16 weights and input on `dev` for a launch of shape `key`.
    Returns (x, params, run, ref): run() goes through the kernel's wrapper,
    ref(x, params) is its plain version."""
    bf = torch.bfloat16
    blocks = [random_block(key.cin, key.c, key.inner, key.adaptor, gen,
                           key.planes) for _ in range(key.s)]
    if key.kind == "fused_dcb":
        p = {k: v.to(dev, bf) for k, v in blocks[0].items()}
        x = torch.randn(1, key.h, key.w, key.cin, generator=gen).to(dev, bf)
        ops = K1.prepare_operands(p)
        return (x, p, lambda: K1.fused_dcb(x, p, key.shortcut, ops=ops),
                lambda x_, p_: K1.fused_dcb_reference(x_, p_, key.shortcut))
    p = {k: torch.stack([b[k] for b in blocks]).to(dev, bf)
         for k in blocks[0]}
    x = torch.randn(1 if key.bcast else key.s, 1, key.h, key.w, key.cin,
                    generator=gen).to(dev, bf).expand(key.s, -1, -1, -1, -1)
    ops = K1.prepare_operands_stacked(p)
    return (x, p, lambda: K1.fused_dcb_stacked(x, p, ops=ops),
            K1.fused_dcb_stacked_reference)


def smooth_frame(h, w, seed, dev):
    """A smooth synthetic frame in [-0.5, 0.5]: uniform noise under an 8x8
    box blur (the recipe of bench.py), made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(1, 3, h + 7, w + 7, generator=gen, device=dev)
    x = F.avg_pool2d(x, 8, stride=1)
    return x.permute(0, 2, 3, 1).contiguous() - 0.5


def make_sequence(h, w, n, seed, dev):
    """n frames of one smooth picture drifting a pixel to the right per
    frame, plus a little noise (the recipe of bench.py), on the card."""
    base = smooth_frame(h, w, seed, dev) + 0.5
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    return [torch.clamp(torch.roll(base, i, dims=2) + 0.005 * torch.randn(
        base.shape, generator=gen, device=dev), 0, 1) - 0.5
        for i in range(n)]


def _video_codec(dev, model, cfg_name, codec_name):
    """The video codec runtime.video_codec.<codec_name> at full width at
    models.<model>.<cfg_name> (init_scale 0.5, as bench.py), or None in a
    checkout that has none."""
    try:
        import importlib
        from .runtime import video_codec
        cfg = getattr(importlib.import_module(f".models.{model}",
                                              __package__), cfg_name)
        cls = getattr(video_codec, codec_name)
    except (ImportError, AttributeError):
        return None
    return cls.init_random(torch.Generator().manual_seed(0), cfg=cfg,
                           init_scale=0.5, skip_thres=0.15,
                           dtype=torch.bfloat16, device=dev)


def _device_ec(codec, fn):
    """fn() with the codec's device-entropy decode on."""
    codec.device_ec = True
    try:
        return fn()
    finally:
        codec.device_ec = False


def _later_chunk_calls(name, codec, dev):
    """Warm calls of a later 1080p coding unit of `codec` (an 8-frame HT
    chunk, an LD frame): encode, decode and (where the checkout has it)
    the device decode."""
    h, w = H, W
    fd = codec.cfg.frame_delay
    unit = "chunk" if fd > 1 else "frame"
    frames = make_sequence(h, w, 2 * fd, 2, dev)
    chunks = [torch.cat(frames[fd * u:fd * u + fd], dim=-1) for u in range(2)]

    def seeded():
        codec.clear_dpb()
        codec.add_ref_feature_from_frame(frames[0])

    seeded()
    r0 = codec.compress(chunks[0], QP)
    after0 = (codec.ref_feature, codec.memory)
    r1 = codec.compress(chunks[1], QP)
    streams = [(bytes(r["bit_stream"]), r["ec_parallel"]) for r in (r0, r1)]
    seeded()
    codec.decompress(streams[0][0], QP, h, w, streams[0][1])
    codec.decompress(streams[1][0], QP, h, w, streams[1][1])

    def later(fn):
        codec.ref_feature, codec.memory = after0
        return fn()

    def decode():
        return codec.decompress(streams[1][0], QP, h, w, streams[1][1])
    calls = [(f"{name} 1080p later {unit} encode", codec,
              lambda: later(lambda: codec.compress(chunks[1], QP))),
             (f"{name} 1080p later {unit} decode", codec,
              lambda: later(decode))]
    if hasattr(codec, "upload_stream"):
        calls.append((f"{name} 1080p later {unit} device decode", codec,
                      lambda: later(lambda: _device_ec(codec, decode))))
        calls[-1][2]()
    return calls


def warm_calls(dev):
    """[(label, codec, fn)] of the measured calls, each warmed up once:
    a 1080p DMCI encode and decode, and, for each video codec the
    checkout has (HTS, HTL, LD), a later 1080p chunk's (LD: frame's)
    encode and decode;
    where the checkout has the device-entropy decode, each decode also
    through it (its stream's upload included).  Every fn() repeats its
    call from the same state."""
    h, w = H, W
    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    x = smooth_frame(h, w, 0, dev)
    res = dmci.compress(x, QP)
    bits = bytes(res["bit_stream"])

    def decode():
        return dmci.decompress(bits, QP, h, w, res["ec_parallel"])
    decode()
    calls = [("DMCI 1080p encode", dmci, lambda: dmci.compress(x, QP)),
             ("DMCI 1080p decode", dmci, decode)]
    if hasattr(dmci, "upload_stream"):
        calls.append(("DMCI 1080p device decode", dmci,
                      lambda: _device_ec(dmci, decode)))
        calls[-1][2]()
    for name, model, codec_name in (("HTS", "dmc_ht", "DMCHTCodec"),
                                    ("HTL", "dmc_ht", "DMCHTCodec"),
                                    ("LD", "dmc_ld", "DMCLDCodec")):
        codec = _video_codec(dev, model, f"{name}_CONFIG", codec_name)
        if codec is not None:
            calls += _later_chunk_calls(name, codec, dev)
    return calls


def run_shapes(dev, iters):
    calls = warm_calls(dev)
    log = LaunchLog()
    with log:
        for label, _, fn in calls:
            with log.call(label):
                fn()
    gen = torch.Generator().manual_seed(0)
    times = {}
    for key in sorted(log.totals()):
        with torch.inference_mode():
            x, p, run, ref = block_inputs(key, gen, dev)
            times[key] = (cuda_ms(run, iters),
                          cuda_ms(lambda: ref(x, p), iters))
        print(f"{key}: kernel_ms={times[key][0]} plain_ms={times[key][1]}",
              flush=True)
    sums = {}
    for label, counts in log.calls:
        sums[label] = [sum(n * times[k][i] for k, n in counts.items())
                       for i in (0, 1)]
        print(f"{label}: K1 launches {sum(counts.values())}, device time "
              f"(per-shape medians x launches) kernel_ms={sums[label][0]} "
              f"plain_ms={sums[label][1]}", flush=True)
    print(json.dumps({"shapes": {str(k): v for k, v in times.items()},
                      "calls": sums}))


def busy_ms(intervals):
    """Length of the union of (start, end) intervals (us), in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profiled(fn):
    """fn() under torch.profiler on a synchronised card: (its result, wall
    ms on the host clock, device busy ms (the union of the intervals of
    every kernel, copy and memset on the card), the device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("torch.profiler recorded no device events")
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    return out, wall, busy, events


def profile_call(label, fn, run, top=10):
    """One profiled call of fn; its host entropy time is the summed
    duration of the entropy.* spans it records."""
    profiling.reset()
    _, wall, busy, events = profiled(fn)
    spans = profiling.records()["spans"]
    entropy = sum(e - s for name, _, _, s, e in spans
                  if name.startswith("entropy."))
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e.name.removeprefix("void ").replace(
            "(anonymous namespace)::", "").split("(")[0]
        kernels[name][0] += e.time_range.elapsed_us() / 1e3
        kernels[name][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print(json.dumps({"call": label, "run": run, "wall_ms": wall,
                      "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                      "host_entropy_ms": 1e-6 * entropy if spans else None,
                      "kernels_ms_count": dict(ranked)}), flush=True)


def run_profile(dev, runs):
    for label, _, fn in warm_calls(dev):
        for r in range(runs):
            profile_call(label, fn, r)


# --------------------------------------------------------- the pipeline

# `pipeline`: DMCI images, RT intra images, and per video codec the reset
# flag of each coding unit of its sequence (bench.py's 6 chunks of 8 frames
# for HTS, 3 chunks for HTL, 8 frames for LD), each after a DMCI frame
PIPELINE_IMAGES = {"DMCI": 8, "RT intra": 4}
PIPELINE_RESETS = {"HTS": (False, False, True, False, False, False),
                   "HTL": (False, True, False),
                   "LD": (False, False, False, False, True, False, False,
                          False)}


class PipelineCase(NamedTuple):
    """One coding job run serially and pipelined.  name: the codec
    ("DMCI", "RT intra", "HTS", "HTL", "LD"); kind: "encode", "decode"
    (host coder) or "device decode" (K2); resets: the reset flag of each
    unit (all False for images).  serial() and pipelined() return what the
    two must agree on: per image (bytes, ec_parallel, x_hat) or x_hat; per
    video unit (bytes, ec_parallel) or x_hat, then the final DPB.
    expect(out) says whether a result is the one the encoder's calls
    made before gave (the same bytes; the host decode's frames, and the
    encoder's DPB, bit for bit)."""
    name: str
    kind: str
    resets: tuple
    serial: object
    pipelined: object
    expect: object


def same(a, b):
    """Exact equality of nested lists / tuples of tensors, bytes, numbers
    and None."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.shape == b.shape and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def launch_counts():
    """(K1 S = 1, K1 stacked, K2) launches so far."""
    from .kernels import rans_decode as K2
    return (K1.fused_dcb.launches, K1.fused_dcb_stacked.launches,
            K2.rans_decode.launches)


def no_sync(fn):
    """fn() with every host sync an error (set_sync_debug_mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def sync_free_halves(codecs):
    """Inside, every compress_async of the codecs ({name: codec}) runs
    under no_sync, and the (S = 1, stacked, K2) launches of each call are
    appended to the yielded {name: [launches]}."""
    log = {name: [] for name in codecs}
    for name, codec in codecs.items():
        def guarded(*args, _half=codec.compress_async, _log=log[name],
                    **kwargs):
            before = launch_counts()
            out = no_sync(lambda: _half(*args, **kwargs))
            _log.append(tuple(a - b for a, b in zip(launch_counts(),
                                                     before)))
            return out
        codec.compress_async = guarded
    try:
        yield log
    finally:
        for codec in codecs.values():
            del codec.compress_async


def _results(res):
    return [(bytes(r["bit_stream"]), r["ec_parallel"], r["x_hat"])
            for r in res]


def image_pipeline(name, codec, images, qp, device_ec):
    """PipelineCases of an image codec on `images` (tensors on the card):
    compress vs compress_many; decompress vs decompress_many through the
    host coder and, with device_ec, through K2 (each stream's lanes
    uploaded once, every call under no_sync).  Runs each serially once
    first (the streams; every decode must give the encoder's frames),
    which also warms the codec up."""
    h, w = images[0].shape[1:3]
    qps = [qp] * len(images)
    enc = _results([codec.compress(x, qp) for x in images])
    streams, ecs = [r[0] for r in enc], [r[1] for r in enc]
    x_hats = [r[2] for r in enc]
    resets = (False,) * len(images)

    def decodes(bits):
        return [codec.decompress(b, qp, h, w, ec)["x_hat"]
                for b, ec in zip(bits, ecs)]

    def decode_many(bits):
        return [o["x_hat"] for o in codec.decompress_many(bits, qps, h, w,
                                                           ecs)]

    def device(fn):
        return no_sync(lambda: _device_ec(codec, fn))
    lanes = [codec.upload_stream(b, ec) for b, ec in zip(streams, ecs)] \
        if device_ec else None
    for kind, out in [("decode", decodes(streams))] + (
            [("device decode", device(lambda: decodes(lanes)))]
            if device_ec else []):
        if not same(out, x_hats):
            raise AssertionError(f"{name}: a {kind} differs from the "
                                 f"encoder's x_hat")
    cases = [PipelineCase(
        name, "encode", resets,
        lambda: _results([codec.compress(x, qp) for x in images]),
        lambda: _results(codec.compress_many(images, qps)),
        lambda out: same(out, enc)),
        PipelineCase(name, "decode", resets, lambda: decodes(streams),
                     lambda: decode_many(streams),
                     lambda out: same(out, x_hats))]
    if device_ec:
        cases.append(PipelineCase(
            name, "device decode", resets,
            lambda: device(lambda: decodes(lanes)),
            lambda: device(lambda: decode_many(lanes)),
            lambda out: same(out, x_hats)))
    return cases


def video_pipeline(name, codec, dmci, frames, resets, qp):
    """PipelineCases of a video codec on `frames` (tensors on the card),
    coded in units of frame_delay frames with these reset flags after the
    DMCI reconstruction of frames[0] (the intra frame): compress vs
    compress_sequence; decompress vs decompress_sequence through the host
    coder and through K2 (lanes uploaded once, under no_sync).  Runs each
    serially once first (the streams, frames and DPBs: the decoders' DPB
    must be the encoder's, the device decode's frames the host decode's),
    which also warms the codec up."""
    fd = codec.cfg.frame_delay
    h, w = frames[0].shape[1:3]
    units = [torch.cat(frames[fd * u:fd * u + fd], dim=-1)
             for u in range(len(resets))]
    qps = [qp] * len(units)
    intra = dmci.compress(frames[0], qp)["x_hat"]

    def seeded(fn):
        codec.clear_dpb()
        codec.add_ref_feature_from_frame(intra)
        out = fn()
        return out, codec.ref_feature, codec.memory

    def streams(res):
        return [(bytes(r["bit_stream"]), r["ec_parallel"]) for r in res]

    def encodes():
        return streams([codec.compress(x, qp, rs)
                        for x, rs in zip(units, resets)])

    enc = seeded(encodes)
    bits, ecs = [b for b, _ in enc[0]], [ec for _, ec in enc[0]]

    def decodes(data):
        return [codec.decompress(b, qp, h, w, ec, rs)["x_hat"]
                for b, ec, rs in zip(data, ecs, resets)]

    def decode_seq(data):
        return codec.decompress_sequence(data, qps, h, w, ecs, resets)

    lanes = [codec.upload_stream(b, ec) for b, ec in zip(bits, ecs)]

    def device(fn):
        return no_sync(lambda: _device_ec(codec, lambda: seeded(fn)))
    dec = seeded(lambda: decodes(bits))
    if not (same(dec[1:], enc[1:])
            and same(device(lambda: decodes(lanes)), dec)):
        raise AssertionError(f"{name}: the decoder's final DPB differs from "
                             f"the encoder's, or the device decode from the "
                             f"host decode")

    def same_dpb(out):
        return same(out, dec)
    return [
        PipelineCase(name, "encode", resets, lambda: seeded(encodes),
                     lambda: seeded(lambda: streams(codec.compress_sequence(
                         units, qps, resets))),
                     lambda out: same(out, enc)),
        PipelineCase(name, "decode", resets,
                     lambda: seeded(lambda: decodes(bits)),
                     lambda: seeded(lambda: decode_seq(bits)), same_dpb),
        PipelineCase(name, "device decode", resets,
                     lambda: device(lambda: decodes(lanes)),
                     lambda: device(lambda: decode_seq(lanes)), same_dpb)]


def pipeline_codecs(dev):
    """The codecs of `pipeline` at their published widths in bf16, skip
    0.15 (chip_smoke.py's): DMCI, RT intra, and HTS / HTL / LD at
    init_scale 0.5."""
    from .legacy.rt_intra import DMCIRTConfig
    from .runtime.rt_image_codec import RTIntraCodec
    codecs = {"DMCI": DMCICodec.init_random(
        torch.Generator().manual_seed(0), cfg=DMCIConfig(), skip_thres=0.15,
        dtype=torch.bfloat16, device=dev),
        "RT intra": RTIntraCodec.init_random(
            torch.Generator().manual_seed(0), cfg=DMCIRTConfig(),
            skip_thres=0.15, dtype=torch.bfloat16, device=dev)}
    for name, model, codec_name in (("HTS", "dmc_ht", "DMCHTCodec"),
                                    ("HTL", "dmc_ht", "DMCHTCodec"),
                                    ("LD", "dmc_ld", "DMCLDCodec")):
        codecs[name] = _video_codec(dev, model, f"{name}_CONFIG", codec_name)
    return codecs


def pipeline_cases(codecs, dev, qp=QP, h=H, w=W):
    """Every PipelineCase of `pipeline` at (h, w) and qp, from seeded
    inputs: PIPELINE_IMAGES smooth frames for each image codec (RT intra:
    in [0, 1], and no device decode: its JAX codec has none), and for
    each video codec the DMCI-seeded sequence of PIPELINE_RESETS
    (bench.py's drifting picture)."""
    cases = []
    for name, n in PIPELINE_IMAGES.items():
        shift = 0.5 if name == "RT intra" else 0.0
        images = [smooth_frame(h, w, 100 + i, dev) + shift for i in range(n)]
        cases += image_pipeline(name, codecs[name], images, qp,
                                device_ec=name == "DMCI")
    for seed, (name, resets) in enumerate(PIPELINE_RESETS.items()):
        codec = codecs[name]
        frames = make_sequence(h, w, codec.cfg.frame_delay * len(resets),
                               200 + seed, dev)
        cases += video_pipeline(name, codec, codecs["DMCI"], frames, resets,
                                qp)
    return cases


def time_pipeline(case, runs):
    """Runs case.serial and case.pipelined `runs` times each in turns
    (serial first on even turns, pipelined first on odd ones), on the
    host clock around synchronised calls, then once each under
    torch.profiler; every result must pass case.expect and equal the
    first serial run's, bit for bit.  Prints and
    returns a JSON line: per unit, the walls of every run, the medians
    and their ratio, and the profiled run's wall, device busy time and
    idle share (1 - busy / wall)."""
    fns = {"serial": case.serial, "pipelined": case.pipelined}
    walls = {k: [] for k in fns}
    units = len(case.resets)
    first = []

    def check(mode, out):
        if not first:
            first.append(out)
        if not (case.expect(out) and same(out, first[0])):
            raise AssertionError(f"{case.name} {case.kind}: a {mode} run "
                                 f"differs from the encoder's or the serial "
                                 f"run's result")
    for r in range(runs):
        for mode in (("serial", "pipelined") if r % 2 == 0
                     else ("pipelined", "serial")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[mode]()
            torch.cuda.synchronize()
            walls[mode].append(1e3 * (time.perf_counter() - t0) / units)
            check(mode, out)
    line = {"call": f"{case.name} {case.kind}", "units": units}
    for mode, fn in fns.items():
        out, wall, busy, _ = profiled(fn)
        check(mode, out)
        line[f"{mode}_ms_per_unit"] = walls[mode]
        line[f"{mode}_median_ms_per_unit"] = statistics.median(walls[mode])
        line[f"{mode}_profiled_ms_per_unit"] = wall / units
        line[f"{mode}_busy_ms_per_unit"] = busy / units
        line[f"{mode}_idle_share"] = 1 - busy / wall
    line["serial_over_pipelined"] = (line["serial_median_ms_per_unit"]
                                     / line["pipelined_median_ms_per_unit"])
    print(json.dumps(line), flush=True)
    return line


def warm_profiler(dev):
    """One throwaway torch.profiler trace (the tracer may drop the events
    of its first one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()


def run_pipeline(dev, runs):
    codecs = pipeline_codecs(dev)
    cases = pipeline_cases(codecs, dev)     # the codecs' warm-up too
    warm_profiler(dev)
    with sync_free_halves(codecs):
        for case in cases:
            time_pipeline(case, runs)


LEGACY_SIZES = ((1080, 1920), (720, 1280))


def run_legacy(dev, runs):
    """`profile`'s lines for the legacy intra codecs: EVC at EVC_CONFIG
    and IntraNoAR at INTRA_NOAR_CONFIG (float32, the weights of
    lifted_legacy_intra, chip_smoke.py's), a warm encode and decode at
    q_scale 0.8 at each of LEGACY_SIZES, `runs` profiled calls each."""
    from .legacy.evc import EVC_CONFIG
    from .legacy.hem_intra import INTRA_NOAR_CONFIG
    from .runtime.evc_codec import EVCCodec, IntraNoARCodec
    for name, cls, cfg, seed in (("EVC", EVCCodec, EVC_CONFIG, 20),
                                 ("IntraNoAR", IntraNoARCodec,
                                  INTRA_NOAR_CONFIG, 21)):
        codec = cls(lifted_legacy_intra(cls.MODEL_CLS, cfg, seed)
                    .state_dict(), cfg=cfg, device=dev)
        for h, w in LEGACY_SIZES:
            x = smooth_frame(h, w, seed + h, dev) + 0.5
            bits = codec.compress(x, 0.8)["bit_stream"]
            calls = (("encode", lambda: codec.compress(x, 0.8)),
                     ("decode", lambda: codec.decompress(bits, 0.8, h, w)))
            for kind, fn in calls:
                fn()
                for r in range(runs):
                    profile_call(f"{name} {w}x{h} {kind}", fn, r)


FM_SEED = 30
FM_Q_INDEX = 51
HEM_SEED = 40
DC_SEED = 50
DCVC_SEED = 60
TCM_SEED = 80


def fm_p_codec(dev):
    """DMCFMCodec at FM_CONFIG on the card, float32, with lifted_fm's
    weights (chip_smoke.py's)."""
    from .legacy.dcvc_fm import FM_CONFIG
    from .runtime.fm_codec import DMCFMCodec
    return DMCFMCodec(lifted_fm(FM_CONFIG, FM_SEED).state_dict(),
                      cfg=FM_CONFIG, device=dev)


def hem_p_codec(dev):
    """DMCHEMCodec at HEM_CONFIG on the card, float32, with lifted_hem's
    weights (chip_smoke.py's)."""
    from .legacy.dcvc_hem import HEM_CONFIG
    from .runtime.hem_codec import DMCHEMCodec
    return DMCHEMCodec(lifted_hem(HEM_CONFIG, HEM_SEED).state_dict(),
                       cfg=HEM_CONFIG, device=dev)


def dc_p_codec(dev):
    """DMCDCCodec at DC_CONFIG on the card, float32, with lifted_dc's
    weights (chip_smoke.py's)."""
    from .legacy.dcvc_dc import DC_CONFIG
    from .runtime.dc_codec import DMCDCCodec
    return DMCDCCodec(lifted_dc(DC_CONFIG, DC_SEED).state_dict(),
                      cfg=DC_CONFIG, device=dev)


def dcvc_p_codec(dev):
    """DCVCCodec at DCVC_CONFIG on the card, float32, with lifted_dcvc's
    weights (chip_smoke.py's)."""
    from .legacy.dcvc_net import DCVC_CONFIG
    from .runtime.dcvc_codec import DCVCCodec
    return DCVCCodec(lifted_dcvc(DCVC_CONFIG, DCVC_SEED).state_dict(),
                     cfg=DCVC_CONFIG, device=dev)


def tcm_p_codec(dev):
    """DMCTCMCodec at TCM_CONFIG on the card, float32, with lifted_tcm's
    weights (chip_smoke.py's)."""
    from .legacy.dcvc_tcm import TCM_CONFIG
    from .runtime.tcm_codec import DMCTCMCodec
    return DMCTCMCodec(lifted_tcm(TCM_CONFIG, TCM_SEED).state_dict(),
                       cfg=TCM_CONFIG, device=dev)


def hem_q_scales(q_index):
    """HEM's (mv, y) q scales at a q index: the family runner's ladders."""
    from .eval.family import interpolate_log
    return (float(interpolate_log(0.5, 2.0)[q_index]),
            float(interpolate_log(0.3, 3.0)[q_index]))


def p_frame_calls(name):
    """(codec builder, encode(codec, x, i, q), decode(codec, bits, i, q,
    h, w), seed) of a legacy P codec by name: FM (fa_idx from
    INDEX_MAP_FM), DC (from INDEX_MAP_DC), HEM (the q scales of the
    family runner's ladders) or TCM (fixed-rate: no q)."""
    from .eval.family import INDEX_MAP_DC, INDEX_MAP_FM
    if name == "TCM":
        return (tcm_p_codec, lambda c, x, i, q: c.compress(x),
                lambda c, b, i, q, h, w: c.decompress(b, h, w), TCM_SEED)
    if name == "HEM":
        return (hem_p_codec,
                lambda c, x, i, q: c.compress(x, *hem_q_scales(q)),
                lambda c, b, i, q, h, w: c.decompress(b, *hem_q_scales(q),
                                                      h, w), HEM_SEED)
    build, fa_map, seed = {"FM": (fm_p_codec, INDEX_MAP_FM, FM_SEED),
                           "DC": (dc_p_codec, INDEX_MAP_DC, DC_SEED)}[name]
    return (build,
            lambda c, x, i, q: c.compress(x, q, fa_idx=fa_map[i % len(
                fa_map)]),
            lambda c, b, i, q, h, w: c.decompress(b, q, h, w, fa_idx=fa_map[
                i % len(fa_map)]), seed)


def run_p_frame(name, dev, runs):
    """`profile`'s lines for a warm legacy P frame at 1080p (`name`: FM,
    HEM, DC or TCM at its published config, float32, chip_smoke.py's lifted
    weights, q index FM_Q_INDEX): the DPB seeded with a frame and filled
    by one P frame, then the third frame's encode and decode, the DPB put
    back before each call, `runs` profiled calls each."""
    build, encode, decode, seed = p_frame_calls(name)
    codec = build(dev)
    h, w, q = 1080, 1920, FM_Q_INDEX
    frames = [f + 0.5 for f in make_sequence(h, w, 3, seed, dev)]
    codec.set_ref_frame(frames[0])
    encode(codec, frames[1], 1, q)
    dpb = dict(codec.dpb)
    bits = encode(codec, frames[2], 2, q)["bit_stream"]

    def enc():
        codec.dpb = dict(dpb)
        return encode(codec, frames[2], 2, q)

    def dec():
        codec.dpb = dict(dpb)
        return decode(codec, bits, 2, q, h, w)
    for kind, fn in (("encode", enc), ("decode", dec)):
        fn()
        for r in range(runs):
            profile_call(f"{name} {w}x{h} {kind}", fn, r)


# ------------------------------------------------------------ training

class TrainCell(NamedTuple):
    """One full-width training step shape: the structure ("dmci", "ld",
    "hts", "htl"), batch, patch side, coding units after the intra frame
    (0 for the image trainer), cascaded, rematerialised, steps to run."""
    label: str
    structure: str
    batch: int
    patch: int
    units: int
    cascaded: bool
    remat: bool
    steps: int


# DMCI: train_image.py's first stage; LD: its stage0 shape (1 + 1
# frames); HTS: its stage1 shape (1 + 8 + 8 frames, cascaded, here with
# remat); HTL: 1 + 8 frames
TRAIN_CELLS = [
    TrainCell("DMCI 4x256x256", "dmci", 4, 256, 0, False, False, 4),
    TrainCell("LD stage0 4x(1+1)x256x256", "ld", 4, 256, 1, False, False, 3),
    TrainCell("HTS stage1 2x(1+8+8)x256x256 cascaded remat", "hts", 2, 256,
              2, True, True, 3),
    TrainCell("HTL 2x(1+8)x256x256", "htl", 2, 256, 1, False, False, 3),
]
# random conv kernels x 0.6: at 1.0 the full-width models' outputs
# overflow (DMCI's x_hat reaches ~1e9 at 128x128 and the video losses
# inf), at 0.5 they vanish (every y symbol 0)
TRAIN_INIT_SCALE = 0.6
TRAIN_LR = 1e-4
TRAIN_LAMBDAS = (8.0, 256.0)


def damped_model(cls, cfg, seed, scale):
    """cls(cfg) with seeded random weights, conv kernels x scale."""
    model = cls(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(scale)
    return model


def train_setup(cell, dev, scale=TRAIN_INIT_SCALE, data_parallel=False):
    """A cell's model, optimizer and batch on the card.  Returns (model,
    step): step() takes one training step (the trainers' step functions,
    fresh noise from a seeded generator) and returns its metrics.
    data_parallel: the optimizer averages the gradient over the process
    group's ranks (parallel/ddp.py; the group must exist)."""
    from .models.common import draw_noise, get_training_lambdas
    from .models.dmc_ht import DMCHT, HTL_CONFIG, HTS_CONFIG
    from .models.dmc_ld import DMCLD, LD_CONFIG
    from .models.dmci import DMCI
    from .train.step import Optimizer, image_train_step, training_device
    from .train.video_step import intra_seed, video_train_step
    training_device(str(dev))
    i_cfg = DMCIConfig()
    b, p = cell.batch, cell.patch
    gen = torch.Generator(device=dev).manual_seed(42)

    def u8(frame):
        return torch.round((frame + 0.5) * 255).to(torch.uint8)
    samples = [make_sequence(p, p, 1 + cell.units * 8, 100 + i, dev)
               for i in range(b)]
    qp = torch.arange(b, device=dev) * 17 % i_cfg.qp_num
    if cell.structure == "dmci":
        model = damped_model(DMCI, i_cfg, 0, scale).to(dev)
        cfg, clip = i_cfg, 0.1
        x = u8(torch.cat([s[0] for s in samples]))
    else:
        cls, cfg = {"ld": (DMCLD, LD_CONFIG), "hts": (DMCHT, HTS_CONFIG),
                    "htl": (DMCHT, HTL_CONFIG)}[cell.structure]
        model = damped_model(cls, cfg, 0, scale).to(dev)
        i_model = damped_model(DMCI, i_cfg, 10, scale).to(dev).eval() \
            .requires_grad_(False)
        clip, fd = 0.2, cfg.frame_delay
        intra = u8(torch.cat([s[0] for s in samples]))
        chunks = u8(torch.stack([torch.stack([torch.cat(
            s[1 + u * fd:1 + (u + 1) * fd], dim=-1)[0]
            for u in range(cell.units)]) for s in samples]))
    lambdas = torch.tensor(get_training_lambdas(TRAIN_LAMBDAS, cfg.qp_num),
                           dtype=torch.float32, device=dev)
    opt = Optimizer(model, TRAIN_LR, clip, data_parallel=data_parallel)

    def step():
        if cell.structure == "dmci":
            return image_train_step(model, opt, x, qp, lambdas,
                                    draw_noise(cfg, b, p, p, gen, dev))
        seed = intra_seed(i_model, intra, qp,
                          draw_noise(i_cfg, b, p, p, gen, dev))
        return video_train_step(model, opt, seed, chunks, qp, lambdas, gen,
                                cascaded=cell.cascaded,
                                use_remat=cell.remat)
    return model, step


def run_train(dev, runs):
    for cell in TRAIN_CELLS:
        _, step = train_setup(cell, dev)
        step()
        torch.cuda.synchronize()
        for r in range(runs):
            profile_call(f"train {cell.label}", step, r)


def run_mask_decay(dev, runs):
    """EVC's mask decay at EVC_LL_CONFIG, f32 with TF32 off, on a batch of
    2 256x256 images (chip_smoke.py's phase): the warm step profiled."""
    from .legacy.evc import EVC, EVC_LL_CONFIG
    from .train import mask_decay as md
    from .train.step import training_device
    training_device(str(dev))
    model = damped_model(EVC, EVC_LL_CONFIG, 3, TRAIN_INIT_SCALE).to(dev)
    x = torch.round((torch.cat([smooth_frame(256, 256, 70 + i, dev)
                                for i in range(2)]) + 0.5) * 255) \
        .to(torch.uint8)
    opt = md.create_mask_decay_state(model, TRAIN_LR, 0.1)
    step = md.make_mask_decay_step(model, opt, 0.1, 3.0)
    masks = [md.init_masks(model)]

    def one():
        masks[0], _ = step(masks[0], x)
    one()
    torch.cuda.synchronize()
    for r in range(runs):
        profile_call("mask decay EVC_LL 2x256x256", one, r, top=15)


# the heaviest K1 shapes of chip_smoke.py's main path (launches x device
# time on an H100), and one with a 1024-wide adaptor
HEAVY_SHAPES = [
    Launch("fused_dcb", 1, 136, 240, 512, 512, 512, False, False, False),
    Launch("fused_dcb", 1, 68, 120, 512, 512, 512, False, False, False),
    Launch("fused_dcb", 1, 136, 240, 512, 512, 256, False, False, False),
    Launch("fused_dcb_stacked", 8, 136, 240, 256, 256, 256, False, False,
           False),
    Launch("fused_dcb", 1, 136, 240, 384, 384, 384, False, False, False),
    Launch("fused_dcb", 1, 68, 120, 768, 768, 768, False, False, False),
    Launch("fused_dcb", 1, 136, 240, 1024, 512, 256, True, False, False),
]
SWEEP_TILES = [None, (128, 256), (128, 128), (128, 64), (64, 256),
               (64, 128), (64, 64)]


def run_tiles(dev, iters):
    """Each launch of K1's chain at HEAVY_SHAPES under every tile of
    SWEEP_TILES (None: the plan's own), device ms by torch.profiler, and
    the whole call by CUDA events; then K1's host time per call at a
    small shape (back-to-back calls, the card idle most of the time)."""
    gen = torch.Generator().manual_seed(0)
    for key in HEAVY_SHAPES:
        x, p, _, _ = block_inputs(key, gen, dev)
        if key.kind == "fused_dcb":
            ops, xs, lead = K1.prepare_operands(p), x, ()
        else:
            ops, xs, lead = K1.prepare_operands_stacked(p), x[:, 0], (key.s,)
        for tile in SWEEP_TILES:
            def run():
                return K1._launch(xs, ops, key.shortcut, lead, tile=tile)
            with torch.inference_mode():
                ms = profile_launches(run)
                t = cuda_ms(run, iters)
            plan = K1.k1_plan(key.s, key.h, key.w, key.cin, key.c,
                              key.inner, key.adaptor, tile, key.ffn_inner,
                              key.planes)
            tiles = {q.name: (q.bm, q.bn, q.stages) for q in plan}
            print(json.dumps({"shape": str(key), "tile": tile,
                              "plan": tiles, "call_ms": t,
                              "kernels_ms": ms,
                              "kernel_sum_ms": sum(ms.values())}),
                  flush=True)
    key = Launch("fused_dcb", 1, 12, 20, 128, 128, 128, False, False, False)
    x, p, run, _ = block_inputs(key, gen, dev)
    ops = K1.prepare_operands(p)

    def host_ms(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return ms
    with torch.inference_mode():
        host = {"wrapper": host_ms(run),
                "_launch": host_ms(lambda: K1._launch(x, ops, False, ())),
                "torch.empty x2": host_ms(lambda: (
                    torch.empty((1 << 20,), dtype=torch.uint8, device=dev),
                    torch.empty((1 << 16,), dtype=torch.bfloat16,
                                device=dev)))}
        device = cuda_ms(run, iters)
    print(json.dumps({"host_ms_per_call": host, "shape": str(key),
                      "call_ms": device}), flush=True)


def k2_clock_summary(clocks):
    """Where K2's cycles go, from the cycle-counting build's per-lane
    fields (kernels.rans_decode.CLOCK_FIELDS) of one call ((n, fields)
    tensor) or of several (a list of them): cycles per symbol of each part
    over every lane, escape-path cycles per escape, the escape share, the
    aligned groups, the share of them kept from the escape-free body and
    the share redone after it, the longest lane's ns per symbol, and the
    SM clock under load (the longest lanes' cycles over their
    %globaltimer ns, MHz)."""
    from .kernels.rans_decode import CLOCK_FIELDS
    if isinstance(clocks, torch.Tensor):
        clocks = [clocks]
    tot = dict.fromkeys(CLOCK_FIELDS, 0)
    longest = dict.fromkeys(CLOCK_FIELDS, 0)
    for clk in clocks:
        lanes = [dict(zip(CLOCK_FIELDS, row)) for row in clk.cpu().tolist()]
        for k in CLOCK_FIELDS:
            tot[k] += sum(r[k] for r in lanes)
        lane = max(lanes, key=lambda r: r["total"])
        for k in CLOCK_FIELDS:
            longest[k] += lane[k]
    sym = max(tot["symbols"], 1)
    groups = tot["free_groups"] + tot["full_groups"]
    return {"symbols": tot["symbols"], "escapes": tot["escapes"],
            "escape_share": tot["escapes"] / sym, "groups": groups,
            "free_share": tot["free_groups"] / max(groups, 1),
            "redo_share": tot["redone_groups"] / max(groups, 1),
            "cycles_per_symbol": {k: tot[k] / sym for k in (
                "search", "update", "escape", "store", "total")},
            "escape_cycles_per_escape": tot["escape"] / max(tot["escapes"],
                                                            1),
            "longest_lane_symbols": longest["symbols"],
            "longest_lane_ns_per_symbol": longest["ns"] / max(
                longest["symbols"], 1),
            "sm_clock_mhz": 1e3 * longest["total"] / max(longest["ns"], 1)}


def k2_clocks_of_calls(calls):
    """Each recorded K2 call (K2Call) through the cycle-counting build,
    its symbols and lane state checked against the production build's.
    Returns [(label, signature, clocks)]."""
    from .kernels import rans_decode as K2
    out = []
    for c in calls:
        args = c.args()
        st_p, out_p = K2.rans_decode_launch(*args)
        st_c, out_c, clk = K2.rans_decode_clocks(*args)
        if not (torch.equal(out_p, out_c) and torch.equal(st_p["st"],
                                                          st_c["st"])
                and torch.equal(st_p["ptr"], st_c["ptr"])):
            raise AssertionError(f"K2's cycle-counting build disagrees with "
                                 f"the production build on {c.label}")
        out.append((c.label, c.signature(), clk))
    return out


def run_k2_clocks_dmci(dev):
    """The K2 calls of one 1080p DMCI device decode (qp 32, seeded random
    weights, bf16) recorded and replayed through the cycle-counting build;
    prints each call's breakdown and kernel ms, and the sum."""
    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    x = smooth_frame(H, W, 0, dev)
    res = dmci.compress(x, QP)
    bits = bytes(res["bit_stream"])
    log = K2Log()
    dmci.device_ec = True
    with log:
        log.label = "DMCI 1080p device decode"
        lanes = dmci.upload_stream(bits, res["ec_parallel"])
        out = dmci.decompress(lanes, QP, H, W, res["ec_parallel"])
    dmci.device_ec = False
    if not torch.equal(out["x_hat"], res["x_hat"]):
        raise AssertionError("the DMCI device decode differs from the "
                             "encoder")
    per_call = k2_clocks_of_calls(log.calls)
    from .kernels import rans_decode as K2
    for i, (call, (label, sig, clk)) in enumerate(zip(log.calls, per_call)):
        ms = cuda_ms(lambda: K2.rans_decode_launch(*call.args()), iters=5,
                     warmup=1)
        print(json.dumps({"k2_clocks": f"{label} call {i}",
                          "lanes_bytes_cap_rows": sig, "kernel_ms": ms,
                          **k2_clock_summary(clk)}), flush=True)
    print(json.dumps({"k2_clocks": "DMCI 1080p device decode, all calls",
                      **k2_clock_summary([c for _, _, c in per_call])}),
          flush=True)


def run_k2(dev, symbols, lanes, clocks=False):
    """K2 on a synthetic stream: `symbols` y symbols (rows uniform over the
    128 Gaussian CDFs, values ~ N(0, 6) rounded, |v| <= 127, so some
    escape) coded by the host encoder over `lanes` lanes; the kernel
    against the host decoder and timed (CUDA events), the plain version
    timed once (host clock), and the latency bound."""
    import numpy as np
    from .entropy.gaussian import GaussianConditional
    from .kernels import rans_decode as K2
    from .rans import RansEncoder
    from .rans.device_decode import init_state, upload_lanes
    cdf, lengths = GaussianConditional(0.15).compute_cdf_bank()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 128, symbols).astype(np.uint8)
    sym = np.clip(np.round(rng.normal(0, 6, symbols)), -127, 127).astype(
        np.int8)
    enc = RansEncoder()
    enc.set_cdf(cdf, lengths, 1)
    enc.set_parallel(lanes)
    enc.reset()
    enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
    enc.flush()
    stream = enc.get_encoded_stream()
    lane_t = upload_lanes(stream, lanes, dev)
    args = (torch.from_numpy(idx).to(dev),
            torch.tensor(symbols, dtype=torch.int32, device=dev),
            K2.make_bank(cdf, lengths, dev))
    state0 = init_state(lane_t)
    _, out = K2.rans_decode(state0, *args)
    equal = bool(np.array_equal(out.cpu().numpy(), sym))
    k_ms = cuda_ms(lambda: K2.rans_decode(init_state(lane_t), *args),
                   iters=5, warmup=1)
    t0 = time.perf_counter()
    _, out_p = K2.rans_decode_reference(init_state(lane_t), *args)
    p_ms = 1e3 * (time.perf_counter() - t0)
    call = K2Call("synthetic", lane_t, state0["st"], state0["ptr"], *args)
    escapes = k2_lane_escapes(call, out_p)
    longest = k2_lane_sizes(symbols, lanes)[-1]
    max_clock = max_sm_clock_mhz()
    summary = None
    if clocks:
        _, _, clk = K2.rans_decode_clocks(init_state(lane_t), *args)
        summary = k2_clock_summary(clk)
    clock = summary["sm_clock_mhz"] if summary else max_clock
    print(json.dumps({
        "k2_symbols": symbols, "lanes": lanes, "escapes": sum(escapes),
        "stream_bytes": len(stream), "equal_to_host": equal,
        "kernel_ms": k_ms, "plain_ms": p_ms,
        "ns_per_symbol_per_lane": 1e6 * k_ms / longest,
        "bound_ms": k2_latency_bound_ms([call], clock, [escapes]),
        "sm_clock_mhz": clock, "clock_from": "clocks build under load"
        if summary else "nvidia-smi clocks.max.sm",
        "bound_ms_symbols_only_max_clock": k2_latency_bound_ms([call],
                                                               max_clock),
        "max_sm_clock_mhz": max_clock}), flush=True)
    if clocks:
        print(json.dumps({"k2_clocks": f"synthetic {symbols} symbols, "
                          f"{lanes} lanes", **summary}), flush=True)
        run_k2_clocks_dmci(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("shapes", "profile", "k2", "tiles",
                                     "train", "legacy", "fm", "hem", "dc",
                                     "tcm", "mask", "pipeline"))
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per shape (shapes)")
    ap.add_argument("--runs", type=int, default=2,
                    help="profiled runs per call (profile, train); timed "
                    "runs of each form (pipeline)")
    ap.add_argument("--symbols", type=int, default=2_000_000,
                    help="symbols of the synthetic stream (k2)")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lanes of the synthetic stream (k2)")
    ap.add_argument("--clocks", action="store_true",
                    help="k2: also the cycle-counting build's breakdown")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device: {nvidia_smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    # (the codecs' own methods run in inference mode; their weights must
    # not be made in it)
    if args.mode == "shapes":
        run_shapes(dev, args.iters)
    elif args.mode == "k2":
        run_k2(dev, args.symbols, args.lanes, args.clocks)
    elif args.mode == "tiles":
        run_tiles(dev, args.iters)
    elif args.mode == "train":
        run_train(dev, args.runs)
    elif args.mode == "legacy":
        run_legacy(dev, args.runs)
    elif args.mode == "mask":
        run_mask_decay(dev, args.runs)
    elif args.mode in ("fm", "hem", "dc", "tcm"):
        run_p_frame(args.mode.upper(), dev, args.runs)
    elif args.mode == "pipeline":
        run_pipeline(dev, args.runs)
    else:
        run_profile(dev, args.runs)


if __name__ == "__main__":
    main()
