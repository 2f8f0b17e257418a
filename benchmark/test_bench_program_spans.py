"""The program's spans on a traced run's clock (program_spans.py) and the
per-layer readers that use them, on a hand-made trace and hand-made
records (CPU): the clock offset recovered, each idle gap split at the
spans' boundaries, a span outside its call refused, and each reader's
value worked by hand."""

import os

import pytest

from benchmark import program_spans, run
from benchmark.tracing import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = 1_792_000_000_000_000_000       # unix-epoch ns of the trace's 0
NAMES = ("dispatch_idle_share.enc", "dispatch_idle_share.dec",
         "host_entropy_ms_per_frame.enc", "k1_dispatch_us_per_launch.enc",
         "k2_ns_per_symbol")


def reader(name):
    return run.load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                           "reader_" + name.replace(".", "_"))


def make_trace():
    # one encode call [0, 10 ms], one decode call [20, 30 ms]
    device = [("void k1_h<128, 128>(x)", 150, 1_500),
              ("x", 1_800, 6_500), ("y", 6_600, 7_000),
              ("void rans_decode_kernel<5>(x)", 22_050, 26_000),
              ("k1_ffn_in", 26_000, 28_950)]
    return Trace(calls={"enc": [(0, 10_000)], "dec": [(20_000, 30_000)]},
                 device=device, frames={"enc": 8, "dec": 8},
                 requests={"enc": 1, "dec": 1}, host_coder_s={},
                 work={})


# (name, parent, start us, end us) on the trace's clock; the request id
# follows the parent chain
SPANS = [
    ("codec.compress_many", -1, 0, 9_000),
    ("codec.compress_async", 0, 10, 6_000),
    ("stage.analysis", 1, 20, 2_000),
    ("k1.launch", 2, 100, 200),
    ("copy.start", 1, 2_000, 2_100),
    ("stage.prior", 1, 2_100, 3_000),
    ("k1.launch", 5, 2_200, 2_260),
    ("codec.compress_finish", 0, 6_000, 8_900),
    ("wait.copy", 7, 6_000, 7_000),
    ("entropy.encode", 7, 7_000, 8_800),
    ("codec.dpb_seed", -1, 20_000, 20_500),
    ("codec.decompress_sequence", -1, 20_600, 29_000),
    ("codec.decode_unit", 11, 20_700, 28_000),
    ("entropy.upload", 12, 20_700, 21_500),
    ("stage.step", 12, 21_500, 27_000),
    ("k2.launch", 14, 22_000, 22_100),
    ("stage.recon", 11, 28_000, 28_900),
]


def make_records(shift_us=123_456, spans=SPANS, late=None):
    """Records of SPANS with the program's clock `shift_us` ahead of the
    trace's; late: {span index: us} starts (and ends) later still."""
    out, request, ids = [], 0, {}
    for i, (name, parent, s, e) in enumerate(spans):
        if parent == -1:
            request += 1
            ids[i] = request
        else:
            ids[i] = ids[parent]
        d = (late or {}).get(i, 0)
        out.append((name, parent, ids[i], T0 + 1000 * (s + shift_us + d),
                    T0 + 1000 * (e + shift_us + d)))
    return {"spans": out, "counters": {"entropy.symbols": 1_000_000},
            "dropped": 0}


@pytest.fixture
def records(monkeypatch):
    """Sets the records the readers find."""
    box = {}
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: box.get("rec"))
    return box


def test_recovers_the_clock_offset():
    sp = program_spans.split_records(make_trace(), make_records())
    assert sp["offset_ns"] == T0 + 1000 * 123_456
    assert sp["offset_spread_us"] == 0
    # the decode's first request 7 us after its call: the offset is the
    # encode's (the smaller), the spread 7 us
    late = {i: 7 for i in range(10, len(SPANS))}
    sp = program_spans.split_records(make_trace(), make_records(late=late))
    assert sp["offset_ns"] == T0 + 1000 * 123_456
    assert sp["offset_spread_us"] == pytest.approx(7.0)
    assert sp["spans"]["dec"][0][:2] == (20_007, 20_507)


def test_idle_gaps_split_at_span_boundaries():
    sp = program_spans.split_records(make_trace(), make_records())
    # encode gaps [0, 150], [1500, 1800], [6500, 6600], [7000, 10000]
    assert sp["idle"]["enc"] == pytest.approx({
        "codec.compress_many": 10 + 100, "codec.compress_async": 10,
        "stage.analysis": 80 + 300, "k1.launch": 50, "wait.copy": 100,
        "entropy.encode": 1_800, "codec.compress_finish": 100, None: 1_000})
    assert sp["by_category"]["enc"] == pytest.approx({
        "dispatch": 430, "entropy": 1_800, "host copies": 100,
        "codec glue": 220, "client": 1_000})
    # decode gaps [20000, 22050], [28950, 30000]
    assert sp["by_category"]["dec"] == pytest.approx({
        "codec glue": 500 + 100 + 50, "client": 100 + 1_000,
        "entropy": 800, "dispatch": 500 + 50})
    for kind, idle in (("enc", 3_550), ("dec", 3_100)):
        assert sum(sp["idle"][kind].values()) == pytest.approx(idle)


def test_a_span_outside_its_call_gives_none(records):
    def split(spans):
        return program_spans.split_records(make_trace(),
                                           make_records(spans=spans))
    outside = SPANS + [("k1.launch", -1, 31_000, 31_100)]
    assert split(outside) is None
    # a request that ends after its call
    over = list(SPANS)
    over[11] = ("codec.decompress_sequence", -1, 20_600, 30_500)
    assert split(over) is None
    # fewer requests than calls
    assert split(SPANS[:10]) is None
    records["rec"] = make_records(spans=outside)
    for name in NAMES:
        assert reader(name).read(make_trace()) is None, name


def test_older_records_before_the_window_are_left_out():
    rec = make_records()
    old = make_records(shift_us=-50_000_000)
    n = len(old["spans"])
    spans = old["spans"] + [(s[0], s[1] + n if s[1] >= 0 else -1,
                             s[2] + 100, s[3], s[4]) for s in rec["spans"]]
    sp = program_spans.split_records(make_trace(), dict(rec, spans=spans))
    assert sp["offset_ns"] == T0 + 1000 * 123_456
    assert sp["by_category"]["enc"]["dispatch"] == pytest.approx(430)


def test_readers_by_hand(records):
    records["rec"] = make_records()
    t = make_trace()
    assert reader("dispatch_idle_share.enc").read(t) == pytest.approx(4.3)
    assert reader("dispatch_idle_share.dec").read(t) == pytest.approx(5.5)
    # entropy.encode: 1.8 ms of self time over 8 frames
    assert reader("host_entropy_ms_per_frame.enc").read(t) == \
        pytest.approx(0.225)
    # k1.launch spans of 100 and 60 us
    assert reader("k1_dispatch_us_per_launch.enc").read(t) == \
        pytest.approx(80.0)
    # K2 3.95 ms over 1,000,000 symbols
    assert reader("k2_ns_per_symbol").read(t) == pytest.approx(3.95)


def test_readers_without_program_records_say_none(records):
    for rec in (None, {"spans": [], "counters": {}, "dropped": 0}):
        records["rec"] = rec
        for name in NAMES:
            assert reader(name).read(make_trace()) is None, name
    # no device operation seen: no idle split, and no K2 time
    records["rec"] = make_records()
    t = make_trace()
    t.device = []
    for name in ("dispatch_idle_share.enc", "dispatch_idle_share.dec",
                 "k2_ns_per_symbol"):
        assert reader(name).read(t) is None, name


def test_self_time_leaves_out_nested_spans():
    spans = [(0, 100, 1, "entropy.encode"), (10, 30, 2, "wait.copy"),
             (20, 40, 2, "x"), (50, 60, 3, "deeper"),
             (200, 250, 1, "entropy.encode")]
    assert program_spans.self_us(spans, "entropy.encode") == \
        pytest.approx(100 - 30 + 50)
