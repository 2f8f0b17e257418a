"""Reference key names of the port's parameters, copied from
dcvc_tpu/utils/torch_import.py.

The port names its parameters after the reference torch module tree; the
JAX package's checkpoint importer maps each flax leaf path to that name.
utils/jax_bridge.py inverts the importer with these maps.  They are
verbatim copies (pinned by tests/test_torch_core.py), because the port
imports nothing of the JAX package.
"""

import re

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
