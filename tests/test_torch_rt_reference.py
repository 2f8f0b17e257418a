"""DCVC-RT's P-frame codec against the benchmark's frozen float32
reference (benchmark/reference/dcvc_rt.py), at TINY_RT_CONFIG in float32
on the CPU, on weights drawn by the benchmark's recipe
(benchmark/reference/weights.py::draw_state, the rt_1080p_k2 cell's
recipe with larger quant steps, so that the tiny model codes nonzero
symbols):

- the two-way DepthConvBlock alone, with and without an adaptor and
  with the shortcut;
- a segment of 3 frames from a seeded DPB (banks qp, qp + 8, qp: the
  second frame at a shifted bank) through DMCRTCodec's compress_sequence
  and decompress_sequence (host coder and device_ec): the quantised
  symbols of both checkerboard steps equal the reference's, the decoded
  frames and the final DPB feature agree within TOL, and the same
  comparison with the port in bfloat16 exceeds TOL;
- compress_sequence gives the streams of compress called frame by frame
  (chip_smoke.py's RT phase codes frame by frame).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json
import os

import pytest
import torch

import benchmark.reference.dcvc_rt as ref
from benchmark import traffic
from benchmark.reference import weights
from dcvc_tpu_torch.core.masks import phase_merge
from dcvc_tpu_torch.legacy import dcvc_rt
from dcvc_tpu_torch.legacy.dcvc_rt import DMCRTCodec, TINY_RT_CONFIG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, N = 64, 96, 5, 3
# float32 against float32 through other op orders (the port's conv and
# matmul layouts, its f32 casts): a few ulps of values near 1, far below
# bfloat16's 2^-8 relative step, which the bf16 case below must exceed
TOL = 1e-5
WIDTHS = {k: getattr(TINY_RT_CONFIG, k)
          for k in ("ch_src_d", "ch_y", "ch_z", "ch_d", "ch_recon", "qp_num")}


def recipe():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "dcvc_rt.json")) as f:
        spec = json.load(f)
    rec = dict(spec["weights"])
    # the tiny widths' y is ~5x smaller than the published ones': steps
    # 3x the cell's code nonzero symbols in both steps at every bank
    rec["ladders"] = dict(rec["ladders"], q_encoder=[20.0, 60.0, False],
                          q_decoder=[20.0, 60.0, True])
    return rec, spec["skip_thres"]


@pytest.fixture(scope="module")
def setup():
    rec, skip = recipe()
    with torch.device("meta"):
        meta = ref.DMCRT(WIDTHS)
    state = weights.draw_state(meta, rec, "cpu")
    model = ref.DMCRT(WIDTHS)
    model.load_state_dict(state)
    frames = [f + 0.5 for f in traffic.make_frames(2 ** 31 + 7, 3, N, H, W,
                                                   "cpu")]
    return state, model.eval(), skip, frames


def codec(state, skip, dtype=torch.float32, device_ec=False):
    c = DMCRTCodec(state, cfg=TINY_RT_CONFIG, dtype=dtype, skip_thres=skip,
                   device="cpu", device_ec=device_ec)
    c.force_ec = 2
    return c


def qps():
    return [dcvc_rt.shift_qp(QP, dcvc_rt.INDEX_MAP[i], TINY_RT_CONFIG.qp_num)
            for i in range(N)]


def reference_segment(model, frames, skip):
    """The reference's decoded frames, final DPB feature and each step's
    symbols (full grid, 0 off the step's mask or where skipped)."""
    symbols, code_step = [], ref.code_step

    def spy(y, scales, means, mask, thres):
        coded = mask & (scales > thres)
        symbols.append(torch.where(coded, torch.clamp(
            torch.round(y - means), -128.0, 127.0), torch.zeros_like(y)))
        return code_step(y, scales, means, mask, thres)

    ref.code_step = spy
    try:
        with torch.no_grad():
            dpb, outs = model.seed_feature(frames[0]), []
            for i, (x, q) in enumerate(zip(frames, model.frame_qps(QP, N))):
                feature = model.adapt(dpb, i == 0)
                ctx, ctx_t = model.extract(feature, q)
                y, z = model.analysis(x, ctx, q)
                dpb = model.feature(y, z, ctx, ctx_t, q, skip)
                outs.append(model.recon(dpb, q, H, W))
    finally:
        ref.code_step = code_step
    with torch.no_grad():
        whole = model.code_segment(frames[0], frames, QP, skip)
    for a, b in zip(outs, whole):
        assert torch.equal(a, b)
    return outs, dpb, symbols


def port_segment(c, frames, device_ec=False):
    """The port's streams, the encoder's symbols of each step (full
    grid), the decoded frames and both sides' final DPB features."""
    symbols, quant = [], c._enc_quant_ladder

    def spy(p, step, *args):
        combined, y_q = quant(p, step, *args)
        symbols.append(phase_merge(y_q.float(), p["terms"][step],
                                   c.cfg.ch_y, *p["y"]))
        return combined, y_q

    c._enc_quant_ladder = spy
    c.clear_dpb()
    c.add_ref_feature_from_frame(frames[0])
    res = c.compress_sequence(frames, qps())
    enc_dpb = c.ref_feature
    del c._enc_quant_ladder
    c.device_ec = device_ec
    c.clear_dpb()
    c.add_ref_feature_from_frame(frames[0])
    outs = c.decompress_sequence([r["bit_stream"] for r in res], qps(), H, W,
                                 [r["ec_parallel"] for r in res])
    return res, symbols, outs, enc_dpb, c.ref_feature


@pytest.mark.parametrize("in_ch,out_ch,shortcut", [(32, 32, False),
                                                    (48, 32, False),
                                                    (32, 32, True)])
def test_two_way_block_alone(in_ch, out_ch, shortcut):
    with torch.device("meta"):
        meta = ref.DepthConvBlockRT(ref.Numerics(), in_ch, out_ch, shortcut)
    rec, _ = recipe()
    state = weights.draw_state(meta, rec, "cpu")
    a = ref.DepthConvBlockRT(ref.Numerics(), in_ch, out_ch, shortcut)
    b = dcvc_rt.DepthConvBlockRT(in_ch, out_ch, shortcut=shortcut)
    a.load_state_dict(state)
    b.load_state_dict(state)
    assert (b.adaptor is not None) == (in_ch != out_ch)
    x = torch.randn(1, 6, 10, in_ch, generator=torch.Generator()
                    .manual_seed(in_ch + shortcut))
    with torch.no_grad():
        want, got = a(x), b(x)
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("device_ec", [False, True])
def test_segment_matches_the_reference(setup, device_ec):
    state, model, skip, frames = setup
    want, want_dpb, want_sym = reference_segment(model, frames, skip)
    res, got_sym, got, enc_dpb, dec_dpb = port_segment(
        codec(state, skip), frames, device_ec)
    assert [q for q in qps()] == [QP, QP + 8, QP]
    assert all(r["ec_parallel"] == 2 for r in res)
    # the quantised symbols: each frame's two steps, exact
    assert len(got_sym) == len(want_sym) == 2 * N
    for g, w in zip(got_sym, want_sym):
        assert torch.equal(g, w)
    coded = sum(int((w != 0).sum()) for w in want_sym)
    assert coded > 100, coded
    assert torch.equal(enc_dpb, dec_dpb)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, H, W, 3)
        assert (g - w).abs().max() <= TOL
    assert (dec_dpb - want_dpb).abs().max() <= TOL * want_dpb.abs().max()


def test_tolerance_fails_in_bfloat16(setup):
    """The same comparison with the port in bfloat16 (its precision on the
    card) lies outside TOL."""
    state, model, skip, frames = setup
    want, _, _ = reference_segment(model, frames, skip)
    _, _, got, _, _ = port_segment(codec(state, skip, torch.bfloat16),
                                   frames)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) > \
        100 * TOL


def test_sequence_streams_equal_frame_by_frame(setup):
    state, _, skip, frames = setup
    c = codec(state, skip)
    c.clear_dpb()
    c.add_ref_feature_from_frame(frames[0])
    seq = c.compress_sequence(frames, qps())
    c.clear_dpb()
    c.add_ref_feature_from_frame(frames[0])
    one = [c.compress(x, q) for x, q in zip(frames, qps())]
    assert [r["bit_stream"] for r in seq] == [r["bit_stream"] for r in one]
