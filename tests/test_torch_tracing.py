"""The port's spans and counter (dcvc_tpu_torch/utils/profiling.py) on the
CPU: off, a span is the shared null context and records nothing; under
torch.profiler, spans nest with parent indexes, the spans of a request
share its id, each profiler event is FUNCTION-scope (scope 0, which the
profiler does not mirror on a device's timeline), and a count adds only
while the profiler is on.  The TINY DMCI compress_many /
decompress_many(depth=2) and HTS compress_sequence / decompress_sequence
record the codecs' span names (host coder and device_ec), every span
inside its parent (none is left open across a decode coroutine's yield),
and entropy.symbols counts the symbols the host coder was given.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec
from dcvc_tpu_torch.utils import profiling

H, W = 64, 64
QPS = [0, 3, 7]
ENCODE = {"codec.compress_async", "stage.analysis", "copy.start",
          "stage.prior", "stage.quant", "stage.step",
          "codec.compress_finish", "wait.copy", "entropy.encode"}
DMCI_SPANS = ENCODE | {"codec.compress_many", "codec.decompress_many",
                       "codec.decode_unit", "entropy.decode_z",
                       "entropy.decode_y", "stage.synthesis"}
HTS_SPANS = ENCODE | {"codec.dpb_seed", "stage.seed", "stage.adaptor",
                      "stage.final", "codec.compress_sequence",
                      "codec.decompress_sequence", "codec.decode_unit",
                      "entropy.decode_z", "entropy.decode_y", "stage.recon"}


@pytest.fixture
def recorded():
    """Runs fn() under torch.profiler on the CPU; returns (fn's result,
    the records, the profiler's events)."""
    def run(fn):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        assert profiling._stack == []
        return out, profiling.records(), prof.events()
    yield run
    profiling.reset()


@pytest.fixture(scope="module")
def dmci():
    codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=TINY_CONFIG, dtype=torch.float32,
                                  device="cpu")
    cy = TINY_CONFIG.ch_y
    with torch.no_grad():      # lift the scales so that y symbols are coded
        codec.model.y_prior_fusion.conv[3].bias[:cy] += 2.0
        codec.model.y_spatial_prior.conv[3].bias[:cy] += 2.0
    return codec


@pytest.fixture(scope="module")
def hts():
    codec = DMCHTCodec.init_random(torch.Generator().manual_seed(1),
                                   cfg=TINY_HT_CONFIG, init_scale=0.5,
                                   dtype=torch.float32, device="cpu")
    cy = TINY_HT_CONFIG.ch_y
    with torch.no_grad():
        codec.model.y_prior_fusion.conv[3].bias[cy:2 * cy] += 2.0
    return codec


def smooth(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return torch.from_numpy(x).cumsum(2).div(shape[2]).contiguous()


@contextlib.contextmanager
def device_ec(codec, on):
    codec.device_ec = on
    try:
        yield
    finally:
        codec.device_ec = False


def check_nesting(rec):
    """Every span closed and inside its parent, and carrying its
    parent's request id; returns the names."""
    spans = rec["spans"]
    for name, parent, request, start, end in spans:
        assert end is not None and start <= end, name
        if parent >= 0:
            p = spans[parent]
            assert p[3] <= start and end <= p[4], (name, p[0])
            assert request == p[2], name
        elif name.startswith("codec."):
            assert request is not None, name
    return {s[0] for s in spans}


def test_off_a_span_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    profiling.reset()
    a, b = profiling.span("stage.x"), profiling.span("codec.y")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        profiling.count("entropy.symbols", 5)

    @profiling.spanned("stage.z")
    def f(x, y=1):
        return x + y
    assert f(1, y=2) == 3
    assert profiling.records() == {"spans": [], "counters": {},
                                   "dropped": 0}


def test_spans_nest_share_request_ids_and_are_function_scope(recorded):
    def fn():
        for _ in range(2):
            with profiling.span("codec.request"):
                with profiling.span("stage.a"):
                    with profiling.span("k1.launch"):
                        profiling.count("entropy.symbols", 3)
                with profiling.span("stage.b"):
                    torch.ones(4).sum()
        with profiling.span("k2.launch"):          # outside any request
            pass
    _, rec, events = recorded(fn)
    spans = rec["spans"]
    assert [(s[0], s[1]) for s in spans] == [
        ("codec.request", -1), ("stage.a", 0), ("k1.launch", 1),
        ("stage.b", 0), ("codec.request", -1), ("stage.a", 4),
        ("k1.launch", 5), ("stage.b", 4), ("k2.launch", -1)]
    ids = [s[2] for s in spans]
    assert ids[:4] == [ids[0]] * 4 and ids[4:8] == [ids[4]] * 4
    assert ids[0] != ids[4] and ids[8] is None
    check_nesting(rec)
    assert rec["counters"] == {"entropy.symbols": 6}
    ours = [e for e in events if e.name in ("codec.request", "stage.a",
                                             "stage.b", "k1.launch",
                                             "k2.launch")]
    assert len(ours) == 9 and {int(e.scope) for e in ours} == {0}
    # records stay until reset; a count with the profiler off adds nothing
    profiling.count("entropy.symbols", 100)
    assert profiling.records()["counters"] == {"entropy.symbols": 6}
    assert len(profiling.records()["spans"]) == 9


def test_spans_past_the_cap_are_dropped_and_counted(recorded,
                                                    monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)

    def fn():
        with profiling.span("codec.request"):
            for _ in range(4):
                with profiling.span("stage.a"):
                    pass
    _, rec, _ = recorded(fn)
    assert [s[0] for s in rec["spans"]] == ["codec.request", "stage.a",
                                            "stage.a"]
    assert rec["dropped"] == 2
    check_nesting(rec)


@pytest.mark.parametrize("on", [False, True], ids=["host", "device_ec"])
def test_dmci_many_records_its_spans(dmci, recorded, on):
    images = [smooth((1, H, W, 3), s) for s in range(3)]

    def fn():
        res = dmci.compress_many(images, QPS)
        with device_ec(dmci, on):
            return res, dmci.decompress_many(
                [r["bit_stream"] for r in res], QPS, H, W,
                [r["ec_parallel"] for r in res], depth=2)
    (res, outs), rec, _ = recorded(fn)
    for r, o in zip(res, outs):
        assert torch.equal(r["x_hat"], o["x_hat"])
    names = check_nesting(rec)
    assert names == DMCI_SPANS | ({"entropy.upload"} if on else set())
    roots = [s[0] for s in rec["spans"] if s[1] == -1]
    assert roots == ["codec.compress_many", "codec.decompress_many"]
    # each image's decode is resumed one decode_unit at a time
    units = [s for s in rec["spans"] if s[0] == "codec.decode_unit"]
    assert len(units) > len(images)


@pytest.mark.parametrize("on", [False, True], ids=["host", "device_ec"])
def test_hts_sequence_records_its_spans(hts, recorded, on):
    intra = smooth((1, H, W, 3), 7)
    chunks = [smooth((1, H, W, 24), 8 + u) for u in range(2)]
    qps = QPS[:2]

    def seed():
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(intra)

    def fn():
        seed()
        res = hts.compress_sequence(chunks, qps)
        dpb = hts.ref_feature.clone()
        seed()
        with device_ec(hts, on):
            hts.decompress_sequence([r["bit_stream"] for r in res], qps, H,
                                    W, [r["ec_parallel"] for r in res])
        return dpb, hts.ref_feature
    (enc_dpb, dec_dpb), rec, _ = recorded(fn)
    assert torch.equal(enc_dpb, dec_dpb)
    names = check_nesting(rec)
    assert names == HTS_SPANS | ({"entropy.upload"} if on else set())
    roots = [s[0] for s in rec["spans"] if s[1] == -1]
    assert roots == ["codec.dpb_seed"] * 2 + ["codec.compress_sequence"] \
        + ["codec.dpb_seed"] * 2 + ["codec.decompress_sequence"]
    units = [s for s in rec["spans"] if s[0] == "codec.decode_unit"]
    assert len(units) == len(chunks)


@pytest.mark.parametrize("codec", ["dmci", "hts"])
def test_symbol_counter_is_the_symbols_coded(dmci, hts, recorded, codec,
                                             monkeypatch):
    """entropy.symbols against the sizes of the arrays the host coder's
    encode_y / encode_z calls were given."""
    c = dmci if codec == "dmci" else hts
    given = {"encode_y": [], "encode_z": []}
    for method, sizes in given.items():
        real = getattr(c.encoder, method)

        def spy(arr, *args, _real=real, _sizes=sizes):
            _sizes.append(np.asarray(arr).size)
            return _real(arr, *args)
        monkeypatch.setattr(c.encoder, method, spy)

    def fn():
        if codec == "dmci":
            return dmci.compress_many([smooth((1, H, W, 3), 3)] * 2,
                                      QPS[:2])
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(smooth((1, H, W, 3), 4))
        return hts.compress_sequence([smooth((1, H, W, 24), 5)] * 2,
                                     QPS[:2])
    _, rec, _ = recorded(fn)
    # two units: DMCI 4 y calls a unit, HTS one; one z call a unit
    assert len(given["encode_y"]) == (8 if codec == "dmci" else 2)
    assert len(given["encode_z"]) == 2 and sum(given["encode_y"]) > 0
    total = sum(given["encode_y"]) + sum(given["encode_z"])
    assert rec["counters"] == {"entropy.symbols": total}
