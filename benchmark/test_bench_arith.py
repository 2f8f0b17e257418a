"""The yardstick's arithmetic on synthetic inputs (CPU): the percentile,
the union of busy intervals and the gaps between them, K1's bound, the
per-layer readers on a hand-made trace, and the traffic's schedule."""

import math
import os
import random

import pytest

from benchmark import run, traffic
from benchmark.reference import counts
from benchmark.tracing import Trace

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name):
    return run.load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                           "reader_" + name.replace(".", "_"))


def test_percentile_matches_numpy_linear():
    np = pytest.importorskip("numpy")
    rng = random.Random(3)
    for n in (1, 2, 5, 20, 201):
        xs = [rng.random() for _ in range(n)]
        for q in (0, 50, 95, 100):
            assert counts.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12)
    assert counts.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert counts.union_length(iv) == 15 + 11 + 1
    assert counts.gaps(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    assert counts.gaps(iv, 12, 25) == [(15, 20)]
    assert counts.gaps([], 3, 7) == [(3, 7)]


def test_k1_bound_by_hand():
    # 64 x 128 grid, 512 -> 512 channels, inner 256, no adaptor
    h, w, c, i = 64, 128, 512, 256
    macs = c * i + i * c + 4 * c * i + i * c
    flops = h * w * (2 * macs + 18 * i)
    nbytes = 2 * (h * w * c + macs + 15 * i + 3 * c + h * w * c)
    t_flops, t_bytes = counts.k1_bound_ms(h, w, c, c, i, False)
    assert t_flops == pytest.approx(1e3 * flops / 989e12)
    assert t_bytes == pytest.approx(1e3 * nbytes / 3.35e12)
    fa, _ = counts.k1_bound_ms(h, w, 1024, c, i, True)
    assert fa == pytest.approx(t_flops + 1e3 * h * w * 2 * 1024 * c
                               / 989e12)


def make_trace():
    # two encode calls of 10 ms and 10 ms, two decode calls of 20 ms
    calls = {"enc": [(0, 10_000), (50_000, 60_000)],
             "dec": [(10_000, 30_000), (60_000, 80_000)]}
    device = [("void k1_h<128, 128>(x)", 1_000, 4_000),
              ("k1_dw", 3_000, 5_000),           # overlaps: union 4 ms
              ("ampere_gemm", 51_000, 59_000),   # 8 ms
              ("rans_decode_kernel", 12_000, 22_000),
              ("copy", 62_000, 64_000),
              ("outside", 40_000, 45_000)]       # in no call
    return Trace(calls=calls, device=device, frames={"enc": 8, "dec": 8},
                 requests={"enc": 2, "dec": 2},
                 host_coder_s={"enc": 0.004, "dec": 0.016},
                 work={"flops.enc": 989e9, "flops.dec": 0.0,
                       "k1_bound_ms.enc": 0.5})


def test_readers_on_a_synthetic_trace():
    t = make_trace()
    # encode: 20 ms of calls, busy 4 + 8 = 12 ms
    assert reader("idle_share.enc").read(t) == pytest.approx(40.0)
    # decode: 40 ms of calls, busy 10 + 2 ms
    assert reader("idle_share.dec").read(t) == pytest.approx(70.0)
    # 2 requests x 989 GFLOP in 20 ms = 98.9 TFLOP/s = 10% of the peak
    assert reader("mfu.enc").read(t) == pytest.approx(10.0)
    assert reader("mfu.dec").read(t) is None
    # K1 kernels 3 + 2 ms; bound 2 x 0.5 ms
    assert reader("k1_roofline_share.enc").read(t) == pytest.approx(20.0)
    assert reader("k2_ms_per_frame").read(t) == pytest.approx(10.0 / 8)
    assert reader("host_rans_ms_per_frame.enc").read(t) == \
        pytest.approx(0.5)


def test_readers_find_nothing_and_say_so():
    t = make_trace()
    t.device = []
    t.host_coder_s = {}
    for name in ("idle_share.enc", "idle_share.dec", "k1_roofline_share.enc",
                 "k2_ms_per_frame", "host_rans_ms_per_frame.enc"):
        assert reader(name).read(t) is None, name


def test_reservoir_is_uniform_and_seeded():
    hits = [0] * 10
    for seed in range(2000):
        r = run.Reservoir(2, seed)
        for i in range(10):
            r.offer(lambda i=i: i)
        for i in r.items:
            hits[i] += 1
        r2 = run.Reservoir(2, seed)
        for i in range(10):
            r2.offer(lambda i=i: i)
        assert r.items == r2.items
    assert all(abs(h - 400) < 80 for h in hits), hits
    assert math.isclose(sum(hits), 4000)


def test_corpus_schedule_is_the_same_work_in_another_order():
    wl = {"qps": [0, 21, 42, 63], "corpus": {"pictures": 5, "seed": 7}}
    n = 5 * 4
    passes = {}
    for seed in (3, 2 ** 31 + 12345):
        s = traffic.Schedule(wl, seed)
        reqs = [s.request(i) for i in range(3 * n)]
        assert reqs == [traffic.Schedule(wl, seed).request(i)
                        for i in range(3 * n)]
        for k in range(3):
            p = reqs[k * n:(k + 1) * n]
            assert sorted(p) == sorted(((7, j), q) for j in range(5)
                                       for q in wl["qps"])
            for r in range(5):
                assert sorted(q for _, q in p[4 * r:4 * r + 4]) == wl["qps"]
        passes[seed] = reqs
    a, b = passes.values()
    assert a != b


def test_schedule_without_corpus_draws_a_picture_a_request():
    wl = {"qps": [0, 21, 42, 63]}
    s = traffic.Schedule(wl, 11)
    q = traffic.QpSchedule(wl["qps"], 11)
    assert [s.request(i) for i in range(9)] == [((11, i), q.qp(i))
                                               for i in range(9)]
