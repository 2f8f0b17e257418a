"""The CUDA kernels of the port on the card: K1 (csrc/fused_dcb.cu), one
block and the stacked form, and K2 (csrc/rans_decode.cu), against their
plain PyTorch versions (K2 also against the host decoder), and the
wrappers' refusals.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so it also runs on the GPU machine, where
tests/conftest.py (which imports jax) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.kernels import rans_decode as K2
from dcvc_tpu_torch.layers import blocks
from dcvc_tpu_torch.entropy.gaussian import GaussianConditional
from dcvc_tpu_torch.perf_probe import k2_fixtures, k2_lane_escapes, \
    random_block, run_k2_case, K2Call
from dcvc_tpu_torch.rans import RansDecoder, RansEncoder
from dcvc_tpu_torch.rans.device_decode import init_state, upload_lanes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c,shortcut", [
    (8, 18, 256, 128, False),
    (17, 30, 128, 128, True),
    (5, 7, 192, 384, False),
    (45, 80, 368, 368, False),    # DCVC-RT's intra trunk: tail tiles
    (17, 30, 192, 368, False),    # its first block (an adaptor)
    (9, 17, 368, 192, True),      # a K tail into 192
])
def test_cuda_kernel_matches_plain(cuda_device, h, w, cin, c, shortcut):
    """The CUDA kernel against its plain version, both bf16: within 2^-6
    of the output's largest magnitude (the two round at different points,
    see chip_smoke.py)."""
    gen = torch.Generator().manual_seed(0)
    blk = blocks.DepthConvBlock(cin, c, shortcut=shortcut)
    blocks.lecun_init_(blk, gen)
    blk = blk.to(cuda_device, torch.bfloat16)
    x = torch.randn(1, h, w, cin, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    with torch.inference_mode():
        n = K1.fused_dcb.launches
        out = blk(x)
        torch.cuda.synchronize()
        assert K1.fused_dcb.launches == n + 1
        ref = K1.fused_dcb_reference(x, blk.block_params(), shortcut)
    peak = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= peak * 2 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("ch,dtype,match", [
    (64, torch.float32, "bfloat16"),
    (40, torch.bfloat16, "multiples of 16"),
])
def test_cuda_wrapper_raises(cuda_device, ch, dtype, match):
    """On the card the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    blk = blocks.DepthConvBlock(ch, ch).to(cuda_device, dtype)
    n = K1.fused_dcb.launches
    with pytest.raises(ValueError, match=match):
        K1.fused_dcb(torch.zeros(1, 4, 4, ch, device=cuda_device,
                                 dtype=dtype), blk.block_params())
    assert K1.fused_dcb.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,batch", [(torch.float32, 1),
                                         (torch.bfloat16, 2)])
def test_cuda_block_outside_the_kernel_path_runs_plain(cuda_device, dtype,
                                                       batch):
    """A block in float32 or at batch > 1 (the training forwards) takes
    the plain version, with autograd, and launches nothing."""
    gen = torch.Generator().manual_seed(4)
    blk = blocks.DepthConvBlock(128, 128)
    blocks.lecun_init_(blk, gen)
    blk = blk.to(cuda_device, dtype)
    x = torch.randn(batch, 8, 16, 128, generator=gen).to(cuda_device, dtype)
    n = K1.fused_dcb.launches
    out = blk(x)
    out.float().sum().backward()
    assert K1.fused_dcb.launches == n
    assert torch.equal(out, K1.fused_dcb_reference(x, blk.block_params()))
    assert blk.dc[0].weight.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c,inner", [
    (9, 17, 2048, 512, 256),     # the HTS encoder's adaptor, Cin = 2048
    (7, 13, 768, 768, 768),      # the HTS prior fusion, C = I = 768
])
def test_cuda_kernel_hts_widths(cuda_device, h, w, cin, c, inner):
    """The one-block kernel at the HTS widths: the Cin = 2048 adaptor and
    C = I = 768."""
    gen = torch.Generator().manual_seed(1)
    blk = blocks.DepthConvBlock(cin, c, dcb2=inner < c)
    blocks.lecun_init_(blk, gen)
    blk = blk.to(cuda_device, torch.bfloat16)
    x = torch.randn(1, h, w, cin, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    with torch.inference_mode():
        out = blk(x)
        torch.cuda.synchronize()
        ref = K1.fused_dcb_reference(x, blk.block_params())
    peak = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= peak * 2 ** -6


def _stack(s, cin, c, device):
    gen = torch.Generator().manual_seed(s)
    mods = torch.nn.ModuleList(blocks.DepthConvBlock(cin, c)
                               for _ in range(s))
    for m in mods:
        blocks.lecun_init_(m, gen)
    return mods.to(device, torch.bfloat16), gen


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,c,h,w,broadcast", [
    (2, 128, 128, 5, 7, False),
    (4, 256, 256, 9, 16, True),   # one x for every entry (stride 0)
    (8, 256, 128, 17, 30, False),  # adaptor
    (8, 192, 128, 4, 5, False),    # adaptor, Cin not a multiple of 128
    (8, 256, 128, 17, 30, True),   # adaptor on one x for every entry
])
def test_cuda_stacked_kernel_matches_plain(cuda_device, s, cin, c, h, w,
                                          broadcast):
    """The stacked kernel (one launch of each kind for S entries) against
    its per-entry plain version, each entry within 2^-6 of its peak; and
    rows= runs a sub-range of the stack to the same bits."""
    mods, gen = _stack(s, cin, c, cuda_device)
    stack = blocks.StackedDCB(mods)
    if broadcast:
        x = torch.randn(1, 1, h, w, cin, generator=gen).to(
            cuda_device, torch.bfloat16).expand(s, 1, h, w, cin)
    else:
        x = torch.randn(s, 1, h, w, cin, generator=gen).to(
            cuda_device, torch.bfloat16)
    with torch.inference_mode():
        n = K1.fused_dcb_stacked.launches
        out = stack(x)
        part = stack(x[s // 2:], rows=(s // 2, s))
        torch.cuda.synchronize()
        assert K1.fused_dcb_stacked.launches == n + 2
        ref = K1.fused_dcb_stacked_reference(x, stack.stacked_params())
    assert out.shape == ref.shape == (s, 1, h, w, c)
    assert torch.equal(part, out[s // 2:])
    for e in range(s):
        peak = ref[e].float().abs().max().item()
        err = (out[e].float() - ref[e].float()).abs().max().item()
        assert err <= peak * 2 ** -6, e


@pytest.mark.cuda
def test_cuda_stacked_wrapper_raises(cuda_device):
    """A stacked shape the kernel does not take raises on the card: x with
    a stack stride that is neither 0 nor one entry, and weights of
    another stack size."""
    mods, _ = _stack(2, 64, 64, cuda_device)
    ops = blocks.StackedDCB(mods)._kernel_operands()
    n = K1.fused_dcb_stacked.launches
    big = torch.zeros(4, 1, 4, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stack stride"):
        K1.fused_dcb_stacked_launch(big[::2], ops)
    with pytest.raises(ValueError, match="entries"):
        K1.fused_dcb_stacked_launch(big[:3], ops)
    assert K1.fused_dcb_stacked.launches == n


def _close(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    assert err <= rel * peak, f"{name}: max error {err} > {rel} x {peak}"


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,w,cin,c,inner,shortcut,bcast,tile", [
    (1, 5, 7, 128, 128, 128, False, False, (64, 64)),    # M < one tile
    (1, 9, 17, 128, 128, 128, True, False, (128, 128)),  # ragged M, shortcut
    (1, 9, 17, 64, 64, 64, False, False, (128, 64)),     # N = 64
    (1, 12, 40, 384, 384, 384, False, False, (128, 128)),
    (1, 8, 33, 256, 512, 512, False, False, (64, 128)),  # adaptor, BM 64
    (1, 4, 5, 2048, 512, 256, False, False, None),       # Cin = 2048
    (1, 7, 13, 768, 768, 768, False, False, None),       # C = I = 768
    (1, 7, 13, 768, 768, 768, False, False, (128, 128)),
    (8, 6, 9, 256, 256, 256, False, True, (128, 128)),   # S = 8, one x
    (8, 6, 9, 512, 256, 256, False, True, (64, 128)),    # and an adaptor
    # channel counts with no 64-wide divisor: tail tiles in N and K
    (1, 9, 17, 192, 368, 368, False, False, None),       # RT trunk, adaptor
    (1, 5, 7, 368, 368, 368, True, False, (64, 64)),
    (1, 12, 40, 368, 368, 368, False, False, (128, 128)),
    (1, 9, 17, 368, 192, 192, False, False, (128, 64)),  # K tail only
    (1, 5, 9, 80, 48, 48, False, False, None),           # N < 64
    (2, 6, 9, 368, 368, 368, False, True, (128, 64)),    # stacked, one x
])
def test_cuda_chain_launches_match_torch(cuda_device, s, h, w, cin, c,
                                         inner, shortcut, bcast, tile):
    """Each launch of K1's chain against its torch expression in f32 on
    the kernel's own input of that launch: the bf16 outputs within 2^-7
    of their peak (a bf16 step at the peak is 2^-8), out1 (f32) within
    2^-10 (the same sums in another order); out1c is bf16(out1) exactly,
    and a second run gives the same bits."""
    gen = torch.Generator().manual_seed(s + h + w + cin)
    bf = torch.bfloat16
    raw = [random_block(cin, c, inner, cin != c, gen) for _ in range(s)]
    p = {k: torch.stack([b[k] for b in raw]).to(cuda_device, bf)
         for k in raw[0]}
    x = torch.randn(1 if bcast else s, h, w, cin, generator=gen).to(
        cuda_device, bf).expand(s, h, w, cin)
    ops = K1.prepare_operands(p)
    lead = (s,)
    if s == 1:
        p = {k: v[0] for k, v in p.items()}
        ops = K1.prepare_operands(p)
        lead = ()
    keep, again = {}, {}
    with torch.inference_mode():
        out = K1._launch(x, ops, shortcut, lead, tile=tile, keep=keep)
        out2 = K1._launch(x, ops, shortcut, lead, tile=tile, keep=again)
        torch.cuda.synchronize()
    assert torch.equal(out, out2)
    for k in keep:
        assert torch.equal(keep[k], again[k]), k
    wts = {k: (v if s > 1 else v[None]).float() for k, v in p.items()}

    def mm(a, wm, b):   # a (S, H, W, K) @ w (S, K, N) + b (S, N), f32
        return (torch.einsum("shwk,skn->shwn", a.float(), wm)
                + b[:, None, None, :])
    xin = x.float()
    if cin != c:
        _close("adaptor", keep["xa"], mm(x, wts["wa"], wts["ba"]).to(bf),
               2 ** -7)
        xin = keep["xa"].float()
    _close("h", keep["h"], K1.wsilu_f32(mm(xin, wts["w1"], wts["b1"])).to(bf),
           2 ** -7)
    d = torch.stack([F.conv2d(
        keep["h"][e].float().permute(2, 0, 1)[None],
        wts["wd"][e].permute(2, 0, 1)[:, None], wts["bd"][e], padding=1,
        groups=inner)[0].permute(1, 2, 0) for e in range(s)])
    _close("dw", keep["d"], d.to(bf), 2 ** -7)
    out1 = mm(keep["d"], wts["w2"], wts["b2"]) + xin
    _close("dc_out", keep["out1"], out1, 2 ** -10)
    assert torch.equal(keep["out1c"], keep["out1"].to(bf))
    f = K1.wsilu_f32(mm(keep["out1c"], wts["w3"], wts["b3"]))
    f = f.reshape(*f.shape[:-1], inner, 4).sum(dim=-1)
    _close("ffn_in", keep["s"], f.to(bf), 2 ** -7)
    y = mm(keep["s"], wts["w4"], wts["b4"]) + keep["out1"]
    if shortcut:
        y = y + xin
    _close("ffn_out", out, y.to(bf), 2 ** -7)


@pytest.mark.cuda
def test_cuda_rans_decode_matches_plain_and_host(cuda_device):
    """K2 on the fixtures of the JAX package's decode tests (1/2/3/5/8
    lanes with escapes, count < lanes, count 0, z -> y -> y): each call's
    symbols are the host decoder's, zeros past the count, and symbols and
    final lane states equal the plain version's."""
    for fixture in k2_fixtures():
        n = K2.rans_decode.launches
        st_k, outs_k = run_k2_case(fixture, cuda_device, K2.rans_decode)
        torch.cuda.synchronize()
        assert K2.rans_decode.launches == n + len(fixture[3])
        st_p, outs_p = run_k2_case(fixture, cuda_device,
                                   K2.rans_decode_reference)
        assert torch.equal(st_k["st"], st_p["st"]), fixture[0]
        assert torch.equal(st_k["ptr"], st_p["ptr"]), fixture[0]
        for (_, count, _, _, want), out_k, out_p in zip(fixture[3], outs_k,
                                                        outs_p):
            assert torch.equal(out_k, out_p), fixture[0]
            got = out_k.cpu().numpy()
            np.testing.assert_array_equal(got[:count], want)
            assert not got[count:].any(), fixture[0]


def _k2_args(device, lanes=2, idx_device=None, st_dtype=torch.int32):
    streams = torch.zeros(lanes, 16, dtype=torch.uint8, device=device)
    state = init_state(streams)
    state["st"] = state["st"].to(st_dtype)
    idx = torch.zeros(8, dtype=torch.uint8, device=idx_device or device)
    bank = K2.make_bank(np.array([[0, 65535, 65536]], np.int32),
                        np.array([3], np.int32), device)
    return state, idx, 8, bank


@pytest.mark.cuda
@pytest.mark.parametrize("kind,match", [
    ("cpu state", "one device"),
    ("9 lanes", "1 <= n <= 8"),
    ("int64 st", "st must be torch.int32"),
    ("no search tables", "lacks"),
    ("cut search table", "search tables must be"),
    ("too many rows", "do not fit"),
])
def test_cuda_rans_decode_wrapper_raises(cuda_device, kind, match):
    """K2's wrapper launches or raises on the card, never falls back: a
    CPU state with a CUDA idx, more than 8 lanes, a wrong dtype, a bank
    without make_bank's search tables or with one cut short, and a bank
    whose tables do not fit in a block's shared memory (the whole z bank
    of DMCI: the z call passes one qp's rows)."""
    if kind == "cpu state":
        args = _k2_args("cpu", idx_device=cuda_device)
    elif kind == "9 lanes":
        args = _k2_args(cuda_device, lanes=9)
    elif kind == "int64 st":
        args = _k2_args(cuda_device, st_dtype=torch.int64)
    else:
        state, idx, count, bank = _k2_args(cuda_device)
        if kind == "no search tables":
            bank = {"cdf": bank["cdf"], "len": bank["len"]}
        elif kind == "cut search table":
            bank = dict(bank, sym=bank["sym"][:, :-1].contiguous())
        else:
            bank = K2.make_bank(np.tile([[0, 65535, 65536]], (2048, 1)),
                                np.full(2048, 3, np.int32), cuda_device)
        args = state, idx, count, bank
    n = K2.rans_decode.launches
    with pytest.raises(ValueError, match=match):
        K2.rans_decode(*args)
    assert K2.rans_decode.launches == n


def _coded_lanes(n_lanes, idx, sym, cdf, lengths, device):
    """(lanes on the card, the host decoder's symbols) of `sym` coded by
    the host encoder over n_lanes lanes."""
    enc = RansEncoder()
    enc.set_cdf(cdf, lengths, 1)
    enc.set_parallel(n_lanes)
    enc.reset()
    enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
    enc.flush()
    stream = enc.get_encoded_stream()
    dec = RansDecoder()
    dec.set_cdf(cdf, lengths, 1)
    dec.set_parallel(n_lanes)
    dec.set_stream(stream)
    want = np.zeros(0, np.int8)
    if idx.size:
        dec.decode_y(idx)
        want = dec.get_decoded(idx.size)
    return upload_lanes(stream, n_lanes, device), want


def _k2_check(state, idx, count, bank, want):
    """K2, its cycle-counting build and its plain version on one call:
    every symbol, zero past count, and the lane states equal; the symbols
    the host decoder's."""
    st_k, out_k = K2.rans_decode(state, idx, count, bank)
    st_c, out_c, clocks = K2.rans_decode_clocks(state, idx, count, bank)
    torch.cuda.synchronize()
    st_p, out_p = K2.rans_decode_reference(state, idx, count, bank)
    for got in ((st_k, out_k), (st_c, out_c)):
        assert torch.equal(got[1], out_p)
        assert torch.equal(got[0]["st"], st_p["st"])
        assert torch.equal(got[0]["ptr"], st_p["ptr"])
    n = int(count)
    np.testing.assert_array_equal(out_k.cpu().numpy()[:n], want)
    assert not out_k.cpu().numpy()[n:].any()
    return out_p, clocks


@pytest.mark.cuda
def test_cuda_rans_decode_escape_heavy_stream(cuda_device):
    """200 K symbols over 8 lanes, > 90% of them escapes (the tight rows of
    the Gaussian bank, values up to +-127, as DMCI's random weights code),
    so that escapes read the last bytes of every lane and the zeros past
    it; the cycle-counting build counts the escapes the plain version's
    symbols show."""
    cdf, lengths = GaussianConditional(0.15).compute_cdf_bank()
    rng = np.random.default_rng(7)
    n = 200_000
    idx = rng.integers(0, 8, n).astype(np.uint8)
    sym = rng.integers(-127, 128, n).astype(np.int8)
    lanes, want = _coded_lanes(8, idx, sym, cdf, lengths, cuda_device)
    np.testing.assert_array_equal(want, sym)
    state = init_state(lanes)
    idx_t = torch.from_numpy(idx).to(cuda_device)
    count = torch.tensor(n, dtype=torch.int32, device=cuda_device)
    bank = K2.make_bank(cdf, lengths, cuda_device)
    out_p, clocks = _k2_check(state, idx_t, count, bank, want)
    call = K2Call("escapes", lanes, state["st"], state["ptr"], idx_t, count,
                  bank)
    escapes = k2_lane_escapes(call, out_p)
    assert sum(escapes) > 0.9 * n
    fields = dict(zip(K2.CLOCK_FIELDS, clocks.sum(0).tolist()))
    assert fields["escapes"] == sum(escapes) and fields["symbols"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", range(1, 9))
def test_cuda_rans_decode_short_counts(cuda_device, n_lanes):
    """1-8 lanes at counts 0, 1 and n_lanes - 1 (every symbol in the last
    lane, size0 = 0), each padded to a cap of 64."""
    rng = np.random.default_rng(n_lanes)
    cdf, lengths = GaussianConditional(0.15).compute_cdf_bank()
    bank = K2.make_bank(cdf, lengths, cuda_device)
    for n in sorted({0, 1, n_lanes - 1}):
        idx = rng.integers(0, 128, n).astype(np.uint8)
        sym = rng.integers(-20, 21, n).astype(np.int8)
        lanes, want = _coded_lanes(n_lanes, idx, sym, cdf, lengths,
                                   cuda_device)
        idx_pad = np.zeros(64, np.uint8)
        idx_pad[:n] = idx
        _k2_check(init_state(lanes), torch.from_numpy(idx_pad).to(
            cuda_device), torch.tensor(n, dtype=torch.int32,
                                       device=cuda_device), bank, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["evc", "scalable_evc", "intra_noar"])
def test_cuda_legacy_intra_codec(cuda_device, kind):
    """EVCCodec / IntraNoARCodec on the card, float32, TINY configs with
    the smoke's lifted weights (perf_probe.lifted_legacy_intra): a 64x96
    frame's stream decodes to the encoder's x_hat bit for bit, two
    encodes give the same bytes, no kernel launches (their blocks are not
    K1's), and the card's stages agree with the CPU's (relative RMS
    within 1e-4, float32 on both, TF32 off)."""
    from dcvc_tpu_torch.legacy.evc import TINY_EVC_CONFIG, \
        TINY_SCALABLE_EVC_CONFIG
    from dcvc_tpu_torch.legacy.hem_intra import TINY_INTRA_NOAR_CONFIG
    from dcvc_tpu_torch.perf_probe import lifted_legacy_intra
    from dcvc_tpu_torch.runtime.evc_codec import EVCCodec, IntraNoARCodec
    cls, cfg = {"evc": (EVCCodec, TINY_EVC_CONFIG),
                "scalable_evc": (EVCCodec, TINY_SCALABLE_EVC_CONFIG),
                "intra_noar": (IntraNoARCodec, TINY_INTRA_NOAR_CONFIG)}[kind]
    model = lifted_legacy_intra(cls.MODEL_CLS, cfg, 5)
    state = model.state_dict()
    card = cls(state, cfg=cfg, device=cuda_device)
    cpu = cls(state, cfg=cfg, device="cpu")
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    n = K1.fused_dcb.launches, K2.rans_decode.launches
    for qs in (0.8, 1.4):
        res = card.compress(x, qs)
        again = card.compress(x, qs)
        out = card.decompress(res["bit_stream"], qs, 64, 96)
        assert again["bit_stream"] == res["bit_stream"]
        assert torch.equal(out["x_hat"], res["x_hat"])
        assert out["x_hat"].device.type == "cuda"
    assert (K1.fused_dcb.launches, K2.rans_decode.launches) == n
    qs = torch.tensor(0.8)
    with torch.inference_mode():
        y_c, z_c = cpu.model.analysis(x, qs)
        y_g, _ = card.model.analysis(x.to(cuda_device), qs.to(cuda_device))
        prior_c = cpu.model.prior(z_c)
        prior_g = card.model.prior(z_c.to(cuda_device))
        x_c = cpu.model.synthesis(torch.round(y_c), qs)
        x_g = card.model.synthesis(torch.round(y_c).to(cuda_device),
                                   qs.to(cuda_device))
    for got, want in [(y_g, y_c), (x_g, x_c)] + list(zip(prior_g, prior_c)):
        err = (got.cpu() - want).norm() / want.norm().clamp_min(1e-12)
        assert float(err) <= 1e-4


@pytest.mark.cuda
def test_cuda_fm_codec(cuda_device):
    """DMCFMCodec on the card, float32, TINY_FM_CONFIG with the smoke's
    lifted weights (perf_probe.lifted_fm): a DPB seeded with a 256x256
    frame, then 3 P frames on INDEX_MAP_FM's fa_idx schedule, whose
    streams decode to the encoder's x_hat bit for bit, the final DPBs
    equal, two encodes giving the same bytes, and no kernel launched (FM's
    blocks are not K1's and it decodes on the host)."""
    from dcvc_tpu_torch.eval.family import INDEX_MAP_FM
    from dcvc_tpu_torch.legacy.dcvc_fm import TINY_FM_CONFIG
    from dcvc_tpu_torch.perf_probe import lifted_fm, make_sequence
    from dcvc_tpu_torch.runtime.fm_codec import DMCFMCodec
    codec = DMCFMCodec(lifted_fm(TINY_FM_CONFIG, 3).state_dict(),
                       cfg=TINY_FM_CONFIG, device=cuda_device)
    frames = [f + 0.5 for f in make_sequence(256, 256, 4, 6, cuda_device)]
    n = K1.fused_dcb.launches, K2.rans_decode.launches
    for q in (0, TINY_FM_CONFIG.qp_num - 1):
        passes = []
        for _ in range(2):
            codec.set_ref_frame(frames[0])
            passes.append([codec.compress(frames[i], q,
                                          fa_idx=INDEX_MAP_FM[i])
                           for i in (1, 2, 3)])
        enc_dpb = dict(codec.dpb)
        assert [r["bit_stream"] for r in passes[0]] == \
            [r["bit_stream"] for r in passes[1]]
        codec.set_ref_frame(frames[0])
        for i, res in zip((1, 2, 3), passes[0]):
            out = codec.decompress(res["bit_stream"], q, 256, 256,
                                   fa_idx=INDEX_MAP_FM[i])
            assert out["x_hat"].device.type == "cuda"
            assert torch.equal(out["x_hat"], res["x_hat"])
        for k, v in enc_dpb.items():
            assert torch.equal(codec.dpb[k], v), k
    assert (K1.fused_dcb.launches, K2.rans_decode.launches) == n
