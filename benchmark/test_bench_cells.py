"""Every cell's run driven on the CPU at tiny widths and sizes (the look
for a chip skipped): the frozen reference equals the port through the
port's plain paths in float32, the result carries exactly the contract's
keys, each fault planted under the timed path turns `correct` false, and
the float8 control in the program's place reads far from the
reference.  The control and the faults at the cells' own sizes, against
their limits, need the card (marker `cuda`)."""

import json
import os

import pytest
import torch

from benchmark import readings, run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold

TINY = {
    "dmc_hts": {"ch_y": 16, "ch_z": 8, "ch_d": 32, "ch_m": 32,
                "ch_recon": 16, "qp_num": 8, "enc_depth": 1, "dec_depth": 1,
                "fa_i_depth": 1, "fa_m_depth": 1, "fx_depth": 1,
                "recon_depth": 1},
    "dmci": {"ch_enc_dec": 32, "ch_y": 16, "ch_z": 8, "enc_depth": 1,
             "dec_depth": 1, "qp_num": 8},
}
# the tiny models code no symbol at the recipe's quant steps (the tiny
# HTS's |y| ~ 0.03): steps 10-20x larger make their reconstructions
# depend on their inputs
TINY_LADDERS = {
    "dmc_hts": {"q_encoder": [10.0, 40.0, False],
                "q_decoder": [10.0, 40.0, True]},
    "dmci": {"q_scale_y_enc": [3.0, 30.0, False],
             "q_scale_y_dec": [3.0, 30.0, True]},
}
TINY_QPS = [0, 2, 5, 7]
# On the CPU the port in float32 equals the reference exactly (gap 0,
# test_reference_equals_port), and a tiny model moves its output far less
# than the published widths do, so the tiny runs are held to this limit in
# place of the cells' own (set from the cells' readings at their sizes).
TINY_LIMIT = 1e-4


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [(w["name"], w["config"]) for w in json.load(f)["workloads"]]


def tiny(cell, config, **workload):
    """Tiny widths and frames, at most 2 chunks or images a request, the
    tiny QPs in place of the cell's four.
    At tiny widths the seeded priors' scales fall under the
    configurations' skip threshold, and a run would code no symbol: the
    tiny runs code every one (skip_thres 0)."""
    wl, spec, _ = run.load_cell(cell)
    weights = dict(spec["weights"])
    weights["ladders"] = dict(weights["ladders"], **TINY_LADDERS[config])
    request = {k: min(v, 2) for k, v in wl["request"].items()}
    tiny_wl = {"height": 48, "width": 80, "qps": TINY_QPS,
               "request": request, "trace_requests": 2,
               "limits": {"recon_mae_max": {str(q): TINY_LIMIT
                                            for q in TINY_QPS}}}
    tiny_wl.update(workload)
    return {"widths": TINY[config], "workload": tiny_wl,
            "spec": {"skip_thres": 0.0, "weights": weights}}


def run_tiny(cell, config, fault=None, trace=False, **wl):
    """A tiny run whose window ends after one request of each QP, so that
    every QP is compared."""
    return run.run_cell(cell, SEED, 1e9, trace=trace, device="cpu",
                        overrides=tiny(cell, config, **wl), fault=fault,
                        readers={} if trace else None,
                        max_requests=len(TINY_QPS))


@pytest.mark.parametrize("cell,config", cells())
def test_reference_equals_port(cell, config):
    """float32 on the CPU: the port's decoded frames are the reference's
    (the same weights, frames, quantisation and skips)."""
    res = run_tiny(cell, config)
    assert res["failed"] == 0 and res["attempted"] >= 1
    gaps = [c["value"] for k, c in res["checks"].items()
            if k.startswith("recon_") and c["value"] is not None]
    assert gaps and all(g <= 1e-6 for g in gaps), res["checks"]
    assert res["correct"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    cell, config = cells()[0]
    res = run_tiny(cell, config, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(res) == keys
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"encode_fps", "decode_fps",
                                       "encode_p95_ms", "decode_p95_ms",
                                       "setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit", "is"}


def stage_unchanged(prog):
    """One DepthConvBlock of the shared prior returns its input."""
    blk = prog.codec.model.y_prior_fusion.conv[1]
    blk.forward = lambda x: x


def half_left_out(prog):
    """The second half of each request's frames is not coded: the first
    half's frames stand in for it."""
    prepare = prog.prepare

    def broken(frames):
        half = frames[:len(frames) // 2]
        return prepare(half + half)
    prog.prepare = broken


def frame_altered(prog):
    """The first decoded frame of each request comes out mirrored left to
    right where the decoder produces it."""
    decode = prog.decode

    def broken(req, enc):
        dec = decode(req, enc)
        key = "frames" if "frames" in dec else "x_hat"
        dec[key][0] = dec[key][0].flip(2)
        return dec
    prog.decode = broken


def stream_altered(prog):
    """One byte of the first stream is altered where the encoder
    produces it."""
    encode = prog.encode

    def broken(req, qp):
        enc = encode(req, qp)
        s = bytearray(enc["streams"][0])
        s[len(s) // 2] ^= 0x5A
        enc["streams"][0] = bytes(s)
        return enc
    prog.encode = broken


FAULTS = [stage_unchanged, half_left_out, frame_altered, stream_altered]


def cell_faults():
    """(cell, config, fault) for each fault a cell can have: a request of
    one image has no half to leave out."""
    out = []
    for cell, config in cells():
        wl, _, mod = run.load_cell(cell)
        for fault in FAULTS:
            if fault is half_left_out and mod.frames_per_request(wl) < 2:
                continue
            out.append(pytest.param(cell, config, fault,
                                    id=f"{cell}-{fault.__name__}"))
    return out


@pytest.mark.parametrize("cell,config,fault", cell_faults())
def test_fault_is_not_correct(cell, config, fault):
    res = run_tiny(cell, config, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,config", cells())
def test_control_reads_far_from_the_reference(cell, config):
    """The float8 control in the program's place, through the harness's
    own comparison, where the port in float32 reads 0
    (test_reference_equals_port)."""
    res = readings.control_run(cell, SEED, "cpu", tiny(cell, config))
    gaps = readings.gaps(res)
    assert set(gaps) == {str(q) for q in TINY_QPS}
    assert max(gaps.values()) > 1e-3, gaps
    assert not res["correct"]


def on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config", cells())
def test_control_fails_the_limit_on_the_card(cell, config):
    """At the cell's own sizes and limits on three seeds: the control in
    the program's place comes out not correct."""
    on_the_card()
    for seed in (SEED, SEED + 1, SEED + 2):
        res = readings.control_run(cell, seed)
        assert not res["correct"], (seed, res["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config,fault", cell_faults())
def test_fault_is_not_correct_on_the_card(cell, config, fault):
    """At the cell's own sizes and limits: each fault planted under the
    timed path turns `correct` false."""
    on_the_card()
    wl, _, _ = run.load_cell(cell)
    res = run.run_cell(cell, SEED + 3, 1e9, fault=fault,
                       max_requests=wl["sample"] * len(wl["qps"]))
    print(cell, fault.__name__, json.dumps(res["checks"]))
    assert not res["correct"], res["checks"]
