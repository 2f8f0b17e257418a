"""The rt_1080p_k2 cell (DCVC-RT's P-frame codec): its run driven on the
CPU at tiny widths and sizes, the faults of RT's own layers and the
float8 control through the harness's comparison, the two dcb.rt readers
on a hand-made trace, and the faults at the cell's size on the card
(marker `cuda`).  The tiny tables are also test_bench_cells.py's entries
for dcvc_rt (benchmark/conftest.py)."""

import json
import types

import pytest
import torch

from benchmark import readings, run, span_kernels
from benchmark.reference import counts_rt
from benchmark.tracing import Trace

CELL, CONFIG = "rt_1080p_k2", "dcvc_rt"
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
TINY_WIDTHS = {"ch_y": 16, "ch_z": 8, "ch_d": 32, "ch_recon": 32,
               "qp_num": 8}
# the tiny model's y is ~5x smaller than the published widths': quant
# steps 3x the cell's code nonzero symbols at every bank
TINY_LADDERS = {"q_encoder": [20.0, 60.0, False],
                "q_decoder": [20.0, 60.0, True]}
TINY_QPS = [0, 2, 5, 7]         # banks up to 15, qp_num + 8 - 1
# the port in float32 equals the reference on the CPU (gap 0 here, and
# tests/test_torch_rt_reference.py); a tiny model moves its frames less
# than the published widths do, so tiny runs are held to this limit
TINY_LIMIT = 1e-4


def tiny():
    wl, spec, _ = run.load_cell(CELL)
    weights = dict(spec["weights"])
    weights["ladders"] = dict(weights["ladders"], **TINY_LADDERS)
    return {"widths": TINY_WIDTHS,
            "workload": {"height": 48, "width": 80, "qps": TINY_QPS,
                         "request": {"frames": 3}, "trace_requests": 2,
                         "limits": {"recon_mae_max": {
                             str(q): TINY_LIMIT for q in TINY_QPS}}},
            "spec": {"weights": weights}}


def run_tiny(fault=None):
    """A tiny run whose window ends after one request of each QP, so
    that every QP is compared."""
    return run.run_cell(CELL, SEED, 1e9, device="cpu", overrides=tiny(),
                        fault=fault, max_requests=len(TINY_QPS))


def ffn_half_dropped(prog):
    """The feature extractor's last two-way block sums only the first
    half of its FFN's 4C activation: the WSiLU's second half comes out
    zero."""
    act = prog.codec.model.feature_extractor.conv2[3].ffn[1]
    forward = act.forward

    def broken(x):
        a, b = forward(x).chunk(2, dim=-1)
        return torch.cat([a, torch.zeros_like(b)], dim=-1)
    act.forward = broken


def unshifted_bank(prog):
    """The second frame of each segment (INDEX_MAP 1, bank qp + 8) is
    coded and decoded at the unshifted bank qp."""
    codec = prog.codec
    compress, decompress = codec.compress_sequence, codec.decompress_sequence

    def unshift(qps):
        return [qps[0]] + [qps[0]] + list(qps[2:])

    codec.compress_sequence = lambda chunks, qps, *a, **k: compress(
        chunks, unshift(qps), *a, **k)
    codec.decompress_sequence = lambda streams, qps, *a, **k: decompress(
        streams, unshift(qps), *a, **k)


def step1_prior_unchanged(prog):
    """The second checkerboard step codes with the first step's scales
    and means (the fused prior's), its spatial prior left out."""
    model = prog.codec.model

    def stale(spctx, y_hat_so_far):
        _, scales, means = spctx.chunk(3, dim=-1)
        return scales, means
    model.prior_step = stale


FAULTS = [ffn_half_dropped, unshifted_bank, step1_prior_unchanged]


def test_reference_equals_port():
    res = run_tiny()
    assert res["failed"] == 0 and res["attempted"] == len(TINY_QPS)
    gaps = [c["value"] for k, c in res["checks"].items()
            if k.startswith("recon_")]
    assert len(gaps) == len(TINY_QPS)
    assert all(g is not None and g <= 1e-6 for g in gaps), res["checks"]
    assert res["correct"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    res = run_tiny(fault)
    assert res["failed"] == 0, res["checks"]     # the gate still holds
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    res = readings.control_run(CELL, SEED, "cpu", tiny())
    gaps = readings.gaps(res)
    assert set(gaps) == {str(q) for q in TINY_QPS}
    assert max(gaps.values()) > 1e-3, gaps
    assert not res["correct"]


# ------------------------------------------------ the dcb.rt readers

def reader(name):
    return run.load_module(f"{run.HERE}/metrics/{name}.py",
                           "reader_" + name.replace(".", "_"))


def event(name, start, end, kernels=(), children=()):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        kernels=[types.SimpleNamespace(duration=d) for d in kernels],
        cpu_children=list(children))


def make_trace():
    # two encode calls, one decode call of 8 frames
    return Trace(calls={"enc": [(0, 10_000), (40_000, 50_000)],
                        "dec": [(20_000, 30_000)]},
                 device=[], frames={"enc": 16, "dec": 8},
                 requests={"enc": 2, "dec": 1}, host_coder_s={}, work={})


def make_events():
    mm = event("aten::mm", 120, 400, [300], [event("x", 150, 200, [200])])
    inner = event("dcb.rt", 1_100, 1_500, [50])
    blocks = [event("dcb.rt", 100, 900, [], [mm]),
              event("dcb.rt", 1_000, 2_000, [450], [inner]),
              event("dcb.rt", 41_000, 42_000, [], [event("y", 41_100,
                                                         41_200, [1_000])]),
              event("dcb.rt", 21_000, 22_000, [800]),
              event("dcb.rt", 35_000, 36_000, [5_000])]   # in no call
    # the profiler lists every event, the nested ones too
    return blocks + [mm, inner, event("rans_decode_kernel", 21_000,
                                      22_000, [7])]


@pytest.fixture
def events(monkeypatch):
    box = {"events": make_events()}
    monkeypatch.setattr(span_kernels, "profiler_events",
                        lambda: box["events"])
    monkeypatch.setitem(counts_rt.REQUEST_BOUND_MS, "enc", 0.6)
    return box


def test_span_kernels_by_hand(events):
    t = make_trace()
    # enc: 300 + 200, 450 + 50 (the nested span once), 1000
    assert span_kernels.span_kernel_us(t, "enc", "dcb.rt",
                                       events["events"]) == 2_000
    assert span_kernels.span_kernel_us(t, "dec", "dcb.rt",
                                       events["events"]) == 800
    # 0.6 ms of bound a request, 2 requests, over 2 ms
    assert reader("dcb_rt_roofline_share.enc").read(t) == \
        pytest.approx(60.0)
    assert reader("dcb_rt_ms_per_frame.dec").read(t) == pytest.approx(0.1)


def test_readers_without_dcb_rt_spans_say_none(events):
    t = make_trace()
    for evs in (None, [], [e for e in make_events() if e.name != "dcb.rt"]):
        events["events"] = evs
        for name in ("dcb_rt_roofline_share.enc", "dcb_rt_ms_per_frame.dec"):
            assert reader(name).read(t) is None, (name, evs)


def test_profiler_events_come_from_a_caller():
    assert span_kernels.profiler_events() is None

    def held():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.ones(3).sum()
        return inner(prof)

    def inner(_):
        return span_kernels.profiler_events()
    evs = held()
    assert evs is not None and any(e.name == "aten::sum" for e in evs)


def test_bound_by_hand():
    # 10 x 20 grid, 64 -> 32 channels, an adaptor
    h, w, cin, c = 10, 20, 64, 32
    macs = 2 * c * c + 4 * c * c + 2 * c * c + cin * c
    flops = h * w * (2 * macs + 18 * c)
    nbytes = 2 * (h * w * cin + macs + 17 * c + c + h * w * c)
    t_flops, t_bytes = counts_rt.dcb_rt_bound_ms(h, w, cin, c, True)
    assert t_flops == pytest.approx(1e3 * flops / 989e12)
    assert t_bytes == pytest.approx(1e3 * nbytes / 3.35e12)


def test_request_bound_counts_each_block_call():
    """The work functions leave the bound of the reference's two-way
    blocks: per frame of the encode, adaptor (I on the first), the
    extractor's 6, the encoder's 3, the hyper codec's 6, the temporal
    prior's 1, the fusion's 3, the spatial prior's 2 and the decoder's
    3; the decode drops the encoder's and hyper encoder's 6 and adds the
    recon's 4."""
    wl, spec, mod = run.load_cell(CELL)
    with torch.device("meta"):
        model = mod.reference(spec)
    enc, dec = mod.work_fns(model, wl, spec)
    calls = []
    handles = [m.register_forward_pre_hook(lambda m, a: calls.append(m))
               for m in model.modules()
               if isinstance(m, type(model.feature_adaptor_i))]
    try:
        enc()
        n_enc = len(calls)
        dec()
        n_dec = len(calls) - n_enc
    finally:
        for h in handles:
            h.remove()
    n = mod.frames_per_request(wl)
    assert n == 8
    assert n_enc == 1 + n * (6 + 3 + 6 + 1 + 3 + 2 + 3)
    assert n_dec == 1 + n * (6 + 3 + 1 + 3 + 2 + 3 + 4)
    assert counts_rt.REQUEST_BOUND_MS["enc"] > 0
    assert counts_rt.REQUEST_BOUND_MS["dec"] > 0


# ------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct_on_the_card(fault):
    """At the cell's own sizes and limits: each fault of RT's layers
    turns `correct` false, its gate still holding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl, _, _ = run.load_cell(CELL)
    res = run.run_cell(CELL, SEED + 3, 1e9, fault=fault,
                       max_requests=wl["sample"] * len(wl["qps"]))
    print(CELL, fault.__name__, json.dumps(res["checks"]))
    assert res["failed"] == 0, res["checks"]
    assert not res["correct"], res["checks"]
