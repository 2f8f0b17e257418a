"""K2's algorithm on the CPU (csrc/rans_decode.cu runs only on the card):
the pieces the kernel computes differently from rans.cc, each against
rans.cc's own way, exactly.

- The inverse CDF by make_bank's bucket table and the fix-up over the F
  following starts (bucket_search below, the kernel's search) equals the
  linear search (rans.cc:136-138) at every cum in [0, 65536) of every
  row of the real banks: the Gaussian y bank at skip 0.15 and 0.0, one
  qp's rows of the z bank of the TINY and the full-width BitEstimator
  (sliced as the z call slices them), and the decode fixtures' banks;
  the "sym" entries hold each symbol's start, frequency and escape flag
  as the kernel's update reads them.
- The closed-form escape equals rans.cc's get_bits chain: the state and
  pointer after 1-40 chunks (escape_state below), and the kernel's
  16-chunk escape (kernels/rans_decode.py::escape_fast) on random states
  and windows, including windows that run past a lane's end.
- rans_decode_kernel_model, the kernel's algorithm in Python, equals the
  host decoder and the plain version on every decode fixture
  (perf_probe.k2_fixtures) and on every K2 call of a DMCI TINY device
  decode.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.entropy.bit_estimator import BitEstimator
from dcvc_tpu_torch.entropy.gaussian import GaussianConditional
from dcvc_tpu_torch.kernels import rans_decode as K2
from dcvc_tpu_torch.models.dmci import TINY_CONFIG, DMCIConfig
from dcvc_tpu_torch.perf_probe import k2_fixtures, run_k2_case
from dcvc_tpu_torch.runtime import image_codec
from dcvc_tpu_torch.runtime.image_codec import DMCICodec

from test_torch_image_codec import _image


def _z_bank(cfg, qp, seed):
    """One qp's rows of the z bank of a BitEstimator with the seeded
    N(0, 0.01) parameters of DMCI's random init, sliced from the whole
    bank as the z call slices it."""
    rng = np.random.default_rng(seed)
    params = {k: (0.01 * rng.standard_normal((cfg.qp_num, cfg.ch_z, n)))
              .astype(np.float32) for k, n in (("h", 4), ("b", 4), ("a", 3))}
    cdf, lengths = BitEstimator(cfg.qp_num, cfg.ch_z).compute_cdf_bank(
        params, 8)
    bank = K2.make_bank(cdf, lengths, "cpu")
    rows = slice(qp * cfg.ch_z, (qp + 1) * cfg.ch_z)
    return {k: v[rows] for k, v in bank.items()}


def bucket_search(bank, cum):
    """The kernel's inverse CDF for every row of `bank` at each value of
    the 1-D int64 tensor `cum`: T = bucket[row, cum >> 8], then s = T +
    the count of k in 1..F with sym[row, T + k].start <= cum.
    (R, cum.numel()) int64."""
    bucket = bank["bucket"].to(torch.int64)
    starts = bank["sym"][..., 0].to(torch.int64)
    t = bucket[:, cum >> (K2.K_SCALE_BITS - K2.BUCKET_BITS)]
    s = t.clone()
    for k in range(1, K2.fixup_bound(bank) + 1):
        s += torch.gather(starts, 1, t + k) <= cum
    return s


def escape_state(st, data, ptr, k):
    """The state after k bypass chunks (rans.cc dec_get_bits) in closed
    form, for a state st >= 2^23 (as every renorm leaves it) over the
    bytes `data` of a lane at `ptr` (0 past its end): j = the first j >= 1
    with st >> 2j < 2^23; the chunks are the low 2j bits of st, then the
    bytes from ptr low bits first, 4 chunks each, while the state's top
    bits stay parked.  Returns (chunk list, st, ptr)."""
    def byte(i):
        return data[i] if 0 <= i < len(data) else 0
    j = next(j for j in range(1, 6) if st >> (2 * j) < K2.K_RANS_L)
    chunks = [(st >> (2 * i)) & 3 if i < j
              else (byte(ptr + (i - j) // 4) >> (2 * ((i - j) % 4))) & 3
              for i in range(k)]
    if k < j:
        return chunks, st >> (2 * k), ptr
    m = k - j
    return (chunks, (((st >> (2 * j)) << 8) | byte(ptr + m // 4))
            >> (2 * (m % 4)), ptr + m // 4 + 1)


@functools.lru_cache(maxsize=None)
def _fixtures():
    return k2_fixtures()


def _banks(name):
    """[bank] of one name of BANKS."""
    if name.startswith("y skip"):
        cdf, lengths = GaussianConditional(float(name.split()[-1])) \
            .compute_cdf_bank()
        return [K2.make_bank(cdf, lengths, "cpu")]
    if name == "z TINY qp 3":
        return [_z_bank(TINY_CONFIG, 3, 0)]
    if name == "z full width qp 32":
        return [_z_bank(DMCIConfig(), 32, 1)]
    return [K2.make_bank(cdf, lengths, "cpu") for _, _, _, calls
            in _fixtures() for _, _, cdf, lengths, _ in calls]


BANKS = ["y skip 0.15", "y skip 0.0", "z TINY qp 3", "z full width qp 32",
         "decode fixtures"]


@pytest.mark.parametrize("name", BANKS)
def test_bucket_search_equals_linear_search(name):
    for bank in _banks(name):
        _check_bucket_search(bank)


def _check_bucket_search(bank):
    cdf = bank["cdf"].to(torch.int64)
    lengths = bank["len"].to(torch.int64)
    cum = torch.arange(1 << K2.K_SCALE_BITS)
    want = K2._linear_search(cdf, lengths, cum)
    # the fix-up bound holds: no bucket holds more than F further starts
    first = cum[::1 << K2.BUCKET_BITS]
    spread = (K2._linear_search(cdf, lengths, first + 255)
              - K2._linear_search(cdf, lengths, first)).max()
    assert int(spread) <= K2.fixup_bound(bank)
    assert torch.equal(bucket_search(bank, cum), want)

    # the entry each s selects: start, the update's frequency, the escape
    rows, per = cdf.shape
    sym = bank["sym"].to(torch.int64)
    nxt = torch.cat([cdf[:, 1:], torch.zeros(rows, 1, dtype=torch.int64)], 1)
    s = torch.arange(per)
    inside = s < lengths[:, None]
    assert torch.equal(sym[:, :per, 0][inside], cdf[inside])
    assert torch.equal(sym[:, :per, 1][inside] & 0xFFFFFFFF,
                       (nxt - cdf)[inside] & 0xFFFFFFFF)
    assert torch.equal(sym[:, :per, 2][inside],
                       (s | ((s == lengths[:, None] - 2).long() << 8))
                       .expand(rows, per)[inside])
    assert (sym[:, :, 0][~torch.cat([inside, torch.zeros(
        rows, sym.shape[1] - per, dtype=torch.bool)], 1)]
        == K2.NO_START).all()


def _get_bits_chain(st, data, ptr, k):
    """rans.cc dec_get_bits, k times: (chunks, st, ptr)."""
    chunks = []
    for _ in range(k):
        chunks.append(st & 3)
        st >>= 2
        if st < K2.K_RANS_L:
            st = ((st << 8) | (data[ptr] if 0 <= ptr < len(data) else 0)) \
                & 0xFFFFFFFF
            ptr += 1
    return chunks, st, ptr


def _escape_chain(st, data, ptr):
    """The escape of rans.cc dec_symbol with the kernel's bounds: (raw,
    st, ptr)."""
    chunks, _, _ = _get_bits_chain(st, data, ptr, 60)
    val = chunks[0]
    n_bypass, used = val, 1
    for _ in range(K2.MAX_BYPASS_CHUNKS):
        if val != 3:
            break
        val = chunks[used]
        n_bypass += val
        used += 1
    n_bypass = min(n_bypass, K2.MAX_BYPASS_CHUNKS)
    raw = sum(c << (2 * i) for i, c in enumerate(
        chunks[used:used + n_bypass]))
    _, st, ptr = _get_bits_chain(st, data, ptr, used + n_bypass)
    return raw, st, ptr


def _random_case(rng):
    """A state >= 2^23, a lane of 1-24 bytes and a pointer that sits
    inside it, at its end or past it (the window reads zeros there); half
    the lanes run of 0xff bytes (long runs of 3-chunks)."""
    st = int(rng.integers(1 << 23, 1 << 32))
    n = int(rng.integers(1, 25))
    data = bytes(rng.integers(0, 256, n).astype(np.uint8)) \
        if rng.random() < 0.5 else bytes([0xFF] * (n - 1) + [0x5A])
    ptr = int(rng.integers(max(n - 6, 0), n + 3))
    return st, data, ptr


def test_closed_form_state_equals_get_bits_chain():
    rng = np.random.default_rng(0)
    for _ in range(4000):
        st, data, ptr = _random_case(rng)
        k = int(rng.integers(1, 41))
        assert escape_state(st, data, ptr, k) == \
            _get_bits_chain(st, data, ptr, k), (st, data, ptr, k)


def test_escape_fast_equals_get_bits_chain():
    rng = np.random.default_rng(1)
    fast = 0
    for i in range(20000):
        st, data, ptr = _random_case(rng)
        win = sum((data[p] if 0 <= p < len(data) else 0) << (8 * (p - ptr))
                  for p in range(ptr, ptr + 4))
        got = K2.escape_fast(st, win)
        raw, st_c, ptr_c = _escape_chain(st, data, ptr)
        if got is None:     # more than 16 chunks: the kernel's slow path
            continue
        fast += 1
        assert (got[0], got[1], ptr + got[2]) == (raw, st_c, ptr_c), \
            (st, data, ptr)
    assert fast > 10000     # most random escapes fit in 16 chunks


@pytest.mark.parametrize("i", range(8))
def test_kernel_model_matches_host_on_fixtures(i):
    case = _fixtures()[i]
    st_m, outs_m = run_k2_case(case, "cpu", K2.rans_decode_kernel_model)
    st_p, outs_p = run_k2_case(case, "cpu", K2.rans_decode_reference)
    assert torch.equal(st_m["st"], st_p["st"])
    assert torch.equal(st_m["ptr"], st_p["ptr"])
    for (_, count, _, _, want), out_m, out_p in zip(case[3], outs_m, outs_p):
        assert torch.equal(out_m, out_p)
        np.testing.assert_array_equal(out_m.numpy()[:count], want)
        assert not out_m.numpy()[count:].any()


def test_kernel_model_matches_on_dmci_device_decode(monkeypatch):
    """Every K2 call of a DMCI TINY device decode (prior scale biases
    lifted, as tests/test_torch_device_ec.py, so that y symbols and
    escapes are coded) replayed through the kernel model: the plain
    version's symbols and lane states."""
    codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=TINY_CONFIG, dtype=torch.float32,
                                  device="cpu")
    cy = TINY_CONFIG.ch_y
    with torch.no_grad():
        codec.model.y_prior_fusion.conv[3].bias[:cy] += 2.0
        codec.model.y_spatial_prior.conv[3].bias[:cy] += 2.0
    calls = []
    real = image_codec.rans_decode

    def recorded(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(image_codec, "rans_decode", recorded)
    res = codec.compress(_image(80, 112, 5), 5)
    codec.device_ec = True
    out = codec.decompress(res["bit_stream"], 5, 80, 112,
                           res["ec_parallel"])["x_hat"]
    assert torch.equal(out, res["x_hat"])
    assert len(calls) == 5
    escapes = 0
    for state, idx, count, bank in calls:
        st_m, out_m = K2.rans_decode_kernel_model(state, idx, count, bank)
        st_p, out_p = K2.rans_decode_reference(state, idx, count, bank)
        assert torch.equal(out_m, out_p)
        assert torch.equal(st_m["st"], st_p["st"])
        assert torch.equal(st_m["ptr"], st_p["ptr"])
        n = int(count)
        value = 2 * out_p[:n].long().abs() - (out_p[:n] > 0).long()
        escapes += int((value >= bank["len"][idx[:n].long()] - 2).sum())
    assert escapes > 0
