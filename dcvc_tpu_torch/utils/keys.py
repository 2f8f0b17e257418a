"""Reference key names of the port's parameters, copied from
dcvc_tpu/utils/torch_import.py.

The port names its parameters after the reference torch module tree; the
JAX package's checkpoint importer maps each flax leaf path to that name.
utils/jax_bridge.py inverts the importer with these maps (key_fn_evc: the
port's EVC module names, legacy/evc.py; key_fn_fm, key_fn_dc and
key_fn_hem: the reference names of DCVC-FM's, DCVC-DC's and DCVC-HEM's
keys, which their models' from_reference reads, legacy/dcvc_fm.py
state_from_reference; key_fn_dcvc, key_fn_hyperprior, key_fn_cheng2020
and import_entropy_bottleneck: DCVC-2021's and the CompressAI codecs',
legacy/dcvc_net.py and legacy/compressai_zoo.py; key_fn_tcm: DCVC-TCM's,
legacy/dcvc_tcm.py).  They are verbatim
copies (pinned by tests/test_torch_core.py and, for DCVC-FM's, DC's and
HEM's, tests/test_torch_fm_weights.py and
tests/test_torch_hem_dc_weights.py, for the next four
tests/test_torch_compressai.py and tests/test_torch_dcvc_net.py, for
TCM's tests/test_torch_dcvc_tcm.py),
because the port imports nothing of the JAX package.
"""

import re

import numpy as np

_DCB_MAP = {"dc_in": "dc.0", "dc_dw": "dc.2", "dc_out": "dc.3",
            "ffn_in": "ffn.0", "ffn_out": "ffn.2", "adaptor": "adaptor"}


def _translate(path, top_map):
    """flax param path (tuple of str, leaf last) -> reference key string."""
    segs = list(path)
    leaf = segs.pop()
    out = []
    i = 0
    while i < len(segs):
        s = segs[i]
        nxt = segs[i + 1] if i + 1 < len(segs) else None

        if s in _DCB_MAP and nxt == "conv":      # DepthConvBlock internals
            out.append(_DCB_MAP[s])
            i += 2
            continue
        if s == "up" and nxt == "conv":          # SubpelConv2x
            out.append("up.conv.0")
            i += 2
            continue
        if s == "down" and nxt == "conv":        # RBWS2 / strided conv
            out.append("down")
            i += 2
            continue
        if s == "conv" and i == len(segs) - 1:   # bare ConvNxN wrapper scope
            i += 1
            continue

        mapped = top_map(out, s)
        out.append(s if mapped is None else mapped)
        i += 1

    leaf = {"kernel": "weight"}.get(leaf, leaf)
    return ".".join(out + [leaf])


def _map_dmci(out, s):
    if s == "enc_2_down":
        return "enc_2.6"
    m = re.fullmatch(r"enc_2_(\d+)", s)
    if m:
        return f"enc_2.{m.group(1)}"
    if s == "dec_1_up":
        return "dec_1.0"
    m = re.fullmatch(r"dec_1_(\d+)", s)
    if m:
        return f"dec_1.{int(m.group(1)) + 1}"
    m = re.fullmatch(r"conv_(\d+)", s)
    if m:
        return f"conv.{m.group(1)}"
    return None


def _map_dmc_ht(out, s):
    m = re.fullmatch(r"(conv1|conv2|conv)_(\d+)", s)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"layers_(\d+)", s)
    if m:  # recon_head nested Sequentials
        return m.group(1)
    return None


_STACKED_SUB = {"adaptor": "adaptor", "dc_in": "dc.0", "dc_dw": "dc.2",
                "dc_out": "dc.3", "ffn_in": "ffn.0", "ffn_out": "ffn.2"}


def _stacked_leaf(name):
    """'dc_in_w' -> ('dc.0', 'weight')."""
    base, suffix = name.rsplit("_", 1)
    return _STACKED_SUB[base], {"w": "weight", "b": "bias"}[suffix]


def _recon_keys_ht(path, frame_delay=8, hts=True):
    """Our recon head stores each per-frame decoder chain STACKED
    (layers/blocks.py StackedDCB); one flax leaf gathers frame_delay (or
    frame_delay/2 trunk) reference keys (video_model_ht.py:215-250)."""
    seg = path[1]
    coll = "conv2" if hts else "conv"
    if seg in ("out_w", "out_b"):
        # final per-head 1x1: last entry of the reference Sequential
        idx = 3 if hts else 5
        leaf = "weight" if seg.endswith("_w") else "bias"
        return [f"recon_head.{coll}.{i}.{idx}.{leaf}"
                for i in range(frame_delay)]
    m = re.fullmatch(r"trunk_(\d+)", seg)
    if m:
        sub, leaf = _stacked_leaf(path[2])
        return [f"recon_head.conv1.{i}.{m.group(1)}.{sub}.{leaf}"
                for i in range(frame_delay // 2)]
    m = re.fullmatch(r"heads_(\d+)", seg)
    if m:
        sub, leaf = _stacked_leaf(path[2])
        return [f"recon_head.{coll}.{i}.{m.group(1)}.{sub}.{leaf}"
                for i in range(frame_delay)]
    raise KeyError(f"unrecognized stacked recon path {path}")


_LD_SEQ_TOPS = {"feature_adaptor_i", "feature_adaptor_m", "feature_extractor",
                "hyper_encoder", "hyper_decoder", "y_prior_fusion"}


def _map_dmc_ld(out, s):
    if s == "temporal_prior_encoder":
        # reference wraps the RBWS2 in a module attribute named conv
        return "temporal_prior_encoder.conv"
    m = re.fullmatch(r"layers_(\d+)", s)
    if m and out and out[-1] in _LD_SEQ_TOPS:
        return f"conv.{m.group(1)}"
    m = re.fullmatch(r"(conv1|conv)_(\d+)", s)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    return None


def key_fn_dmci(path):
    return _translate(path, _map_dmci)


def key_fn_dmc_ht(path, frame_delay=8, hts=True):
    if path[0] == "recon_head" and not path[1].startswith("conv"):
        return _recon_keys_ht(path, frame_delay, hts)
    return _translate(path, _map_dmc_ht)


def key_fn_dmc_ld(path):
    return _translate(path, _map_dmc_ld)


def _map_rt(out, s):
    """DCVC-RT module tree (DCVC-RT/src/models/video_model.py): UF-style
    DCB internals + torch Sequentials wrapped under a '.conv' child."""
    m = re.fullmatch(r"layers_(\d+)", s)
    if m:
        return f"conv.{m.group(1)}"
    m = re.fullmatch(r"(conv\d)_(\d+)", s)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"conv_(\d+)", s)
    if m:
        return f"conv.{m.group(1)}"
    return None


def key_fn_rt(path):
    segs = list(path)
    if segs[0] == "bit_estimator_z" and len(segs) == 2:
        n = 3 if segs[-1] == "a" else 4
        return ("stack_last", [f"bit_estimator_z.f{i + 1}.{segs[-1]}"
                               for i in range(n)])
    return _translate(path, _map_rt)


def _evc_dcb_sub(rest, wrapped):
    """EVC DepthConvBlock internals (EVC/src/models/layers.py): enc/dec
    blocks wrap conv2/depth_conv in Sequential('.0'); the hyper/prior
    blocks don't."""
    head, sub = rest[0], rest[1] if len(rest) > 1 else None
    z = ".0" if wrapped else ""
    if head == "dc":
        return {"conv1": "block.0.conv1.0", "conv2": f"block.0.conv2{z}",
                "depth_conv": f"block.0.depth_conv{z}",
                "adaptor": "block.0.adaptor"}[sub]
    if head == "ffn":
        return {"conv1": "block.1.conv.0", "conv2": "block.1.conv.2"}[sub]
    if head == "up_conv":
        return "block.2"
    raise KeyError(rest)


def key_fn_evc(path):
    """EVC checkpoint map (EVC/src/models/image_model.py EVC_LL tree)."""
    segs = list(path)
    if len(segs) == 1:                   # q_basic / q_scale
        return segs[0]
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    top = segs[0]
    if top == "bit_estimator_z":
        n = 3 if segs[-1] == "a" else 4
        return ("stack_last", [f"bit_estimator_z.f{i + 1}.{segs[-1]}"
                               for i in range(n)])
    wrapped = top in ("enc", "dec")
    if top == "dec_out":
        return f"dec.7.0.{leaf}"
    out = [top]
    rest = segs[1:-1]
    i = 0
    while i < len(rest):
        s = rest[i]
        nxt = rest[i + 1] if i + 1 < len(rest) else None
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:
            out.append(m.group(1))
            i += 1
            continue
        if s in ("dc", "ffn", "up_conv"):
            out.append(_evc_dcb_sub(rest[i:], wrapped))
            i += 3 if nxt and i + 2 < len(rest) and rest[i + 2] == "conv" \
                else 2
            continue
        if s in ("subpel_conv", "upsample") and nxt == "conv":
            out.append(f"{s}.0")
            i += 2
            continue
        if s in ("conv1", "conv2") and nxt == "conv":   # RBS internals
            out.append(s)
            i += 2
            continue
        if s == "conv" and nxt == "conv":               # RBU plain conv
            out.append("conv")
            i += 2
            continue
        if s == "conv" and nxt is None:                 # bare wrapper
            i += 1
            continue
        out.append(s)
        i += 1
    return ".".join(out + [leaf])


def _fm_dcb_sub(rest):
    """FM DepthConvBlock internals: our scope suffix -> torch
    '.block.*' suffix (DCVC-FM/src/models/layers.py DepthConvBlock*)."""
    head, sub = rest[0], rest[1]
    if head == "dc":
        return {"depth_conv": "block.0.depth_conv",
                "adaptor": "block.0.adaptor",
                "conv1": "block.0.conv1.0",
                "conv2": "block.0.conv2"}[sub]
    if head == "ffn":
        return {"conv": "block.1.conv", "conv_out": "block.1.conv_out",
                "conv1": "block.1.conv.0", "conv2": "block.1.conv.2"}[sub]
    raise KeyError(rest)


_FM_RBU_SUB = {"conv": "conv", "subpel_conv": "subpel_conv.0",
               "upsample": "upsample.0"}
# parents whose inner ConvK is a torch subpel Sequential (conv, shuffle)
_FM_SUBPEL_PARENTS = {"up1", "up2", "up3", "up4", "conv2_up", "conv3_up",
                      "dec_3_1"}


def key_fn_fm(path):
    """DCVC-FM checkpoint map: our flax paths -> reference state_dict
    keys (DCVC-FM/src/models/video_model.py module tree).

    Returns a key string, a list of keys (leaf stacked on axis 0), or a
    (transform, payload) pair for the structured leaves."""
    segs = list(path)
    leaf = segs.pop()

    # bitparm banks: our (Q, C, L) packs torch f1..fL.{h,b,a} (Q,C,1,1)
    if segs and segs[0] in ("bit_estimator_z", "bit_estimator_z_mv"):
        n_layers = 4 if leaf in ("h", "b") else 3
        return ("stack_last",
                [f"{segs[0]}.f{i + 1}.{leaf}" for i in range(n_layers)])
    # OffsetDiversity grouped fusion conv
    if segs == ["align"] and leaf in ("fusion_kernel", "fusion_bias"):
        which = "weight" if leaf == "fusion_kernel" else "bias"
        return ("group_conv", f"align.fusion.{which}")

    out = []
    i = 0
    while i < len(segs):
        s = segs[i]
        rest = segs[i + 1:]

        m = re.fullmatch(r"moduleBasic_(\d+)", s)
        if m:  # SpyNet level order: 0 = coarsest = me_8x
            out.append(f"me_{8 >> int(m.group(1))}x")
            i += 1
            continue
        m = re.fullmatch(r"conv_offset_(\d+)", s)
        if m:  # align.conv_offset Sequential(conv, lrelu)*: 0, 2, 4
            out.append(f"conv_offset.{2 * int(m.group(1))}")
            i += 2 if rest and rest[0] == "conv" else 1
            continue
        if s in ("dc", "ffn") and rest:
            out.append(_fm_dcb_sub([s] + rest))
            # consume dc/<sub>[/conv] or ffn/<sub>[/conv]
            i += 3 if len(rest) >= 2 and rest[1] == "conv" else 2
            continue
        if s in ("subpel_conv", "upsample") and rest and rest[0] == "conv":
            # ResidualBlockUpsampleFM subpel branches wrap Sequential(.0)
            out.append(_FM_RBU_SUB[s])
            i += 2
            continue
        if s == "conv":
            prev = segs[i - 1] if i else ""
            if rest and rest[0] == "conv":
                # X/conv/conv: SubpelConv (torch Sequential .0) when the
                # parent is a subpel module, else an RBU's plain conv
                if prev in _FM_SUBPEL_PARENTS:
                    out.append("0")
                else:
                    out.append("conv")
                i += 2
                continue
            # bare ConvK wrapper scope: dropped, except standalone
            # SubpelConv modules (dec_3_1) which are torch Sequential(.0)
            if prev in _FM_SUBPEL_PARENTS:
                out.append("0")
            i += 1
            continue
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:  # Sequential index (activations count on both sides)
            out.append(m.group(1))
            i += 1
            continue
        m = re.fullmatch(r"feature_adaptor_(\d+)", s)
        if m:
            out.append(f"feature_adaptor.{m.group(1)}")
            i += 1
            continue
        m = re.fullmatch(r"(enc_\d+|dec_\d+|context_refine)_(\d+)", s)
        if m:  # indexed module lists: enc_1_0 -> enc_1.0
            out.append(f"{m.group(1)}.{m.group(2)}")
            i += 1
            continue
        out.append(s)
        i += 1

    leaf = {"kernel": "weight"}.get(leaf, leaf)
    return ".".join(out + [leaf])


# ----------------------------------------------------------------- DCVC-DC

# flax scopes that are bare SubpelConv modules (torch Sequential .0)
_DC_SUBPEL_PARENTS = {"up1", "up2", "up3", "up4", "conv2_up", "conv3_up",
                      "dec_3_1"}
_DC_HYPER_DECS = {"mv_hyper_prior_decoder", "contextual_hyper_prior_decoder"}


def key_fn_dc(path):
    """DCVC-DC checkpoint map (DCVC-DC/src/models/video_model.py +
    video_net.py module trees).  Same DCB/enc-dec-list conventions as FM
    but: SpyNet keeps torch's moduleBasic.N naming, hyper coders are the
    flat HEM-style Sequentials, and the UNet is DepthConvBlock-based."""
    segs = list(path)
    if len(segs) == 1:                 # q_basic / q_scale leaves
        return segs[0]
    leaf = segs.pop()
    top = segs[0]
    if top in ("bit_estimator_z", "bit_estimator_z_mv"):
        n = 3 if leaf == "a" else 4
        return ("stack_last", [f"{top}.f{i + 1}.{leaf}" for i in range(n)])
    if segs == ["align"] and leaf in ("fusion_kernel", "fusion_bias"):
        which = "weight" if leaf == "fusion_kernel" else "bias"
        return ("group_conv", f"align.fusion.{which}")

    out = []
    i = 0
    while i < len(segs):
        s = segs[i]
        rest = segs[i + 1:]
        prev = segs[i - 1] if i else ""
        m = re.fullmatch(r"conv_offset_(\d+)", s)
        if m:
            out.append(f"conv_offset.{2 * int(m.group(1))}")
            i += 2 if rest and rest[0] == "conv" else 1
            continue
        if s in ("dc", "ffn") and rest:
            out.append(_fm_dcb_sub([s] + rest))
            i += 3 if len(rest) >= 2 and rest[1] == "conv" else 2
            continue
        if s in ("subpel_conv", "upsample") and rest and rest[0] == "conv":
            out.append(_FM_RBU_SUB[s])
            i += 2
            continue
        if s == "conv":
            is_subpel = prev in _DC_SUBPEL_PARENTS or (
                top in _DC_HYPER_DECS and re.fullmatch(r"layers_[26]", prev))
            if rest and rest[0] == "conv":
                out.append("0" if is_subpel else "conv")
                i += 2
                continue
            if is_subpel:
                out.append("0")
            i += 1
            continue
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:
            out.append(m.group(1))
            i += 1
            continue
        m = re.fullmatch(r"(moduleBasic|feature_adaptor)_(\d+)", s)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            i += 1
            continue
        m = re.fullmatch(r"(enc_\d+|dec_\d+|context_refine)_(\d+)", s)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            i += 1
            continue
        out.append(s)
        i += 1

    leaf = {"kernel": "weight"}.get(leaf, leaf)
    return ".".join(out + [leaf])


# ---------------------------------------------------------------- DCVC-HEM

# mv_decoder slots that are ResidualBlockUpsample (their inner bare conv
# stays '.conv'; elsewhere a bare subpel conv becomes '.0')
_HEM_RBU_SLOTS = {("mv_decoder", 1), ("mv_decoder", 3), ("mv_decoder", 5)}


def _hem_unet_sub(rest):
    """HEM UNet internals (DCVC-HEM/src/models/video_net.py:99-225).
    rest: path segs after the unet scope, leaf excluded."""
    head = rest[0]
    m = re.fullmatch(r"context_refine_(\d+)", head)
    if m:  # HEMResBlock: conv1/conv2 ConvK wrappers
        return f"context_refine.{m.group(1)}.{rest[1]}", None
    if head in ("up2", "up3"):          # subpel Sequential
        return f"{head}.0", None
    # ConvBlockResidual (conv1/conv2/conv3/up_conv2/up_conv3)
    inner = rest[1]
    if inner == "conv1":
        return f"{head}.conv.0", None
    if inner == "conv2":
        return f"{head}.conv.2", None
    if inner == "up_dim":
        return f"{head}.up_dim", None
    if inner == "se":
        idx = "0" if rest[2] == "fc1" else "2"
        return f"{head}.conv.3.fc.{idx}", "linear"
    raise KeyError(rest)


def _hem_top(s):
    m = re.fullmatch(r"(ce|cd|tp)_(\w+)", s)
    if m:
        scope = {"ce": "contextual_encoder", "cd": "contextual_decoder",
                 "tp": "temporal_prior_encoder"}[m.group(1)]
        return f"{scope}.{m.group(2)}"
    m = re.fullmatch(r"fx_conv(\d)", s)
    if m:
        return f"feature_extractor.conv{m.group(1)}"
    m = re.fullmatch(r"fx_res(\d)", s)
    if m:
        return f"feature_extractor.res_block{m.group(1)}"
    m = re.fullmatch(r"cf_res(\d)_(up|out)", s)
    if m:
        return f"context_fusion_net.res_block{m.group(1)}_{m.group(2)}"
    m = re.fullmatch(r"cf_(conv\d_(?:up|out))", s)
    if m:
        return f"context_fusion_net.{m.group(1)}"
    if s in ("rg_first_conv", "rg_recon_conv"):
        return f"recon_generation_net.{s[3:]}"
    m = re.fullmatch(r"rg_unet_(\d)", s)
    if m:
        return f"recon_generation_net.unet_{m.group(1)}"
    return s


def key_fn_hem(path):
    """DCVC-HEM checkpoint map (DCVC-HEM/src/models/video_model.py +
    video_net.py module trees)."""
    segs = list(path)
    if len(segs) == 1:   # top-level leaves (mv_y_q_basic, y_q_scale, ...)
        return segs[0]
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    top = segs[0]
    if top in ("bit_estimator_z", "bit_estimator_z_mv"):
        n = 3 if segs[-1] == "a" else 4
        return ("stack_last", [f"{top}.f{i + 1}.{segs[-1]}"
                               for i in range(n)])
    out = [_hem_top(top)]
    tag = None
    rest = segs[1:-1]
    if top.startswith("rg_unet"):
        sub, tag = _hem_unet_sub(rest)
        out.append(sub)
        rest = []
    i = 0
    last_idx = None
    while i < len(rest):
        s = rest[i]
        nxt = rest[i + 1] if i + 1 < len(rest) else None
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:
            last_idx = int(m.group(1))
            out.append(m.group(1))
            i += 1
            continue
        m = re.fullmatch(r"moduleBasic_(\d+)", s)
        if m:
            out.append(f"moduleBasic.{m.group(1)}")
            i += 1
            continue
        if s in ("subpel_conv", "upsample") and nxt == "conv":
            out.append(f"{s}.0")
            i += 3   # consume subpel_conv/conv/conv
            continue
        if s == "conv" and nxt == "conv":
            # bare SubpelConv: '.0' — except RBU's plain conv member
            if (top, last_idx) in _HEM_RBU_SLOTS:
                out.append("conv")
            else:
                out.append("0")
            i += 2
            continue
        if s in ("conv1", "conv2", "downsample", "up_dim") and nxt == "conv":
            out.append(s)
            i += 2
            continue
        if s == "conv" and nxt is None:      # bare ConvK wrapper
            i += 1
            continue
        out.append(s)
        i += 1
    key = ".".join(out + [leaf])
    return (tag, key) if tag else key


# ------------------------------------------------------------- DCVC (2021)

_DCVC_TOP = {
    "mv_encoder": "mvEncoder", "mv_decoder_part1": "mvDecoder_part1",
    "mv_decoder_part2": "mvDecoder_part2",
    "contextual_encoder": "contextualEncoder",
    "contextual_decoder_part1": "contextualDecoder_part1",
    "contextual_decoder_part2": "contextualDecoder_part2",
    "prior_encoder": "priorEncoder", "prior_decoder": "priorDecoder",
    "mv_prior_encoder": "mvpriorEncoder",
    "mv_prior_decoder": "mvpriorDecoder",
    "temporal_prior_encoder": "temporalPriorEncoder",
    "optic_flow": "opticFlow",
}


# scopes whose conv entries are all torch ConvTranspose2d
_DCVC_DECONV = {"mv_decoder_part1", "prior_decoder", "mv_prior_decoder"}


def key_fn_dcvc(path):
    """DCVC-2021 checkpoint map (DCVC-family/DCVC/src/models/
    DCVC_net.py:22-181 module tree; flax Sequential list positions match
    the torch Sequential indices by construction)."""
    segs = list(path)
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    top = segs[0]
    if top in ("bit_estimator_z", "bit_estimator_z_mv"):
        # torch BitEstimator: f1..f4 Bitparm rows (video_net.py);
        # ours stacks the layer axis last: a (1,C,3), b/h (1,C,4)
        name = "bitEstimator_z_mv" if top.endswith("_mv") \
            else "bitEstimator_z"
        n = 3 if segs[-1] == "a" else 4
        return ("stack_last", [f"{name}.f{i + 1}.{segs[-1]}"
                               for i in range(n)])
    out = [_DCVC_TOP.get(top, top)]
    deconv = False
    for i, s in enumerate(segs[1:-1]):
        is_last = i == len(segs) - 3
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:
            out.append(m.group(1))
            if top in _DCVC_DECONV:
                deconv = True
            continue
        m = re.fullmatch(r"moduleBasic_(\d+)", s)
        if m:
            out.append(f"moduleBasic.{m.group(1)}")
            continue
        if s == "conv" and is_last:          # SubpelConv3x3 inner conv
            out.append("0")
            continue
        if top in ("contextual_decoder_part1", "contextual_encoder") \
                and s in ("conv1", "conv2"):
            # ResBlockLRelu: torch ResBlock_LeakyReLU_0_Point_1's
            # Sequential 'conv' indices 0 / 2 (DCVC_net video_net.py)
            out.append("conv.0" if s == "conv1" else "conv.2")
            continue
        out.append(s)
    key = ".".join(out + [leaf])
    return ("deconv", key) if deconv and leaf == "weight" else key


# ---------------------------------------------------------------- DCVC-TCM

_TCM_DECONV = {"mv_prior_decoder", "contextual_hyper_prior_decoder"}


def _tcm_top(s):
    """Our scope prefix -> torch module path
    (DCVC-TCM/src/models/video_net_dmc.py module tree)."""
    m = re.fullmatch(r"ce_(\w+)", s)
    if m:
        return f"contextual_encoder.{m.group(1)}"
    m = re.fullmatch(r"cd_(\w+)", s)
    if m:
        return f"contextual_decoder.{m.group(1)}"
    m = re.fullmatch(r"tp_(\w+)", s)
    if m:
        return f"temporal_prior_encoder.{m.group(1)}"
    m = re.fullmatch(r"fx_conv(\d)", s)
    if m:
        return f"feature_extractor.conv{m.group(1)}"
    m = re.fullmatch(r"fx_res(\d)", s)
    if m:
        return f"feature_extractor.res_block{m.group(1)}"
    m = re.fullmatch(r"cf_res(\d)_(up|out)", s)
    if m:
        return f"context_fusion_net.res_block{m.group(1)}_{m.group(2)}"
    m = re.fullmatch(r"cf_(conv\d_(?:up|out))", s)
    if m:
        return f"context_fusion_net.{m.group(1)}"
    if s == "rg_conv":
        return "recon_generation_net.feature_conv.0"
    m = re.fullmatch(r"rg_res(\d)", s)
    if m:
        return f"recon_generation_net.feature_conv.{m.group(1)}"
    if s == "rg_recon_conv":
        return "recon_generation_net.recon_conv"
    return s


def key_fn_tcm(path):
    """DCVC-TCM checkpoint map (video_net_dmc.py:17-147)."""
    segs = list(path)
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    top = segs[0]
    if top in ("bit_estimator_z", "bit_estimator_z_mv"):
        n = 3 if segs[-1] == "a" else 4
        return ("stack_last", [f"{top}.f{i + 1}.{segs[-1]}"
                               for i in range(n)])
    out = [_tcm_top(top)]
    deconv = False
    rest = segs[1:-1]
    i = 0
    while i < len(rest):
        s = rest[i]
        nxt = rest[i + 1] if i + 1 < len(rest) else None
        m = re.fullmatch(r"layers_(\d+)", s)
        if m:
            out.append(m.group(1))
            if top in _TCM_DECONV:
                deconv = True
            i += 1
            continue
        m = re.fullmatch(r"moduleBasic_(\d+)", s)
        if m:
            out.append(f"moduleBasic.{m.group(1)}")
            i += 1
            continue
        if s == "conv" and nxt == "conv":    # SubpelConv wrapper
            out.append("0")
            i += 2
            continue
        if s in ("conv1", "conv2") and nxt == "conv":  # HEMResBlock ConvK
            out.append(s)
            i += 2
            continue
        if s == "conv" and nxt is None:      # bare ConvK wrapper
            i += 1
            continue
        out.append(s)
        i += 1
    if top == "mv_decoder" and out[-1] in ("0", "4", "6", "8"):
        deconv = True
    key = ".".join(out + [leaf])
    return ("deconv", key) if deconv and leaf == "weight" else key


# ---------------------------------------------------------------- CompressAI
# cheng2020-anchor / bmshj2018-hyperprior (the DCVC / TCM I-frame models);
# the torch modules are nn.Sequentials whose indices skip activation slots

def _seq_key(scope, flax_idx, torch_indices, sub, leaf, deconv_at=()):
    ti = torch_indices[flax_idx]
    parts = [f"{scope}.{ti}"] + sub
    key = ".".join(parts + [leaf])
    if flax_idx in deconv_at and leaf == "weight":
        return ("deconv", key)
    return key


def _compressai_sub(sub):
    """Residual-block / subpel internals -> torch child names."""
    out = []
    i = 0
    while i < len(sub):
        s = sub[i]
        nxt = sub[i + 1] if i + 1 < len(sub) else None
        if s in ("subpel_conv", "upsample") and nxt == "conv":
            out.append(f"{s}.0")      # subpel_conv3x3 Sequential(conv, PS)
            i += 2
            continue
        out.append(s)
        i += 1
    return out


# flax list slots that are bare SubpelConv3x3 modules: their inner conv
# is torch Sequential index 0 (subpel_conv3x3, layers.py:56-60)
_CHENG_SUBPEL_SLOTS = {("h_s", 1), ("h_s", 3), ("g_s", 7)}


def key_fn_hyperprior(path):
    """bmshj2018-hyperprior (priors.py:200-254): g_a/g_s 1:1 Sequential
    indices (GDN between convs counts), h_a/h_s skip ReLU slots."""
    segs = list(path)
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    m = re.fullmatch(r"(g_a|g_s|h_a|h_s)_layers_(\d+)", segs[0])
    assert m, f"unmapped path {path}"
    scope, idx = m.group(1), int(m.group(2))
    sub = _compressai_sub(segs[1:-1])
    if scope == "g_a":
        return _seq_key("g_a", idx, list(range(7)), sub, leaf)
    if scope == "g_s":
        return _seq_key("g_s", idx, list(range(7)), sub, leaf,
                        deconv_at=(0, 2, 4, 6))
    if scope == "h_a":
        return _seq_key("h_a", idx, [0, 2, 4], sub, leaf)
    return _seq_key("h_s", idx, [0, 2, 4], sub, leaf, deconv_at=(0, 1))


def key_fn_cheng2020(path):
    """cheng2020-anchor (waseda.py:28-95)."""
    segs = list(path)
    leaf = {"kernel": "weight"}.get(segs[-1], segs[-1])
    if segs[0] == "context_prediction_kernel":
        return "context_prediction.weight"
    if segs[0] == "context_prediction_bias":
        return "context_prediction.bias"
    m = re.fullmatch(r"ep_layers_(\d+)", segs[0])
    if m:
        return f"entropy_parameters.{int(m.group(1)) * 2}.{leaf}"
    m = re.fullmatch(r"(g_a|g_s|h_a|h_s)_layers_(\d+)", segs[0])
    assert m, f"unmapped path {path}"
    scope, idx = m.group(1), int(m.group(2))
    sub = _compressai_sub(segs[1:-1])
    if (scope, idx) in _CHENG_SUBPEL_SLOTS and sub == ["conv"]:
        sub = ["0"]
    if scope in ("g_a", "g_s"):
        return _seq_key(scope, idx, list(range(8)), sub, leaf)
    if scope == "h_a":
        return _seq_key("h_a", idx, [0, 2, 4, 6, 8], sub, leaf)
    return _seq_key("h_s", idx, [0, 2, 4, 6, 8], sub, leaf)


def import_entropy_bottleneck(state_dict, prefix="entropy_bottleneck",
                              n_filters=4):
    """Torch EntropyBottleneck params -> the eb_params dict used by
    entropy/compressai.py (direct copies; entropy_models.py:238-264)."""
    p = {}
    for i in range(n_filters + 1):
        p[f"matrix_{i}"] = np.asarray(
            state_dict[f"{prefix}._matrices.{i}"], np.float32)
        p[f"bias_{i}"] = np.asarray(
            state_dict[f"{prefix}._biases.{i}"], np.float32)
        if i < n_filters:
            p[f"factor_{i}"] = np.asarray(
                state_dict[f"{prefix}._factors.{i}"], np.float32)
    p["quantiles"] = np.asarray(state_dict[f"{prefix}.quantiles"],
                                np.float32)
    return p
