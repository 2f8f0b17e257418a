"""K1's launch plan (kernels/fused_dcb.py::k1_plan), on the CPU.

On the card one call of K1 is a chain of launches (adaptor, h, dw,
dc_out, ffn_in, ffn_out; csrc/fused_dcb.cu).  The plan of each call is
made in Python and checked by the C entry, so it is tested here, at every
shape the main path of chip_smoke.py launches K1 at (listed below as its
launch log prints them, and DCVC-RT's intra codec's, derived from the
model), at chip_smoke.py's TEST_SHAPES and at the shapes of the card
tests: every launch fits in a Hopper block's shared memory, the K and N of
every GEMM are multiples of 16 (a width with no 64-wide divisor, RT's 368,
takes tail tiles), the blocks of each GEMM cover its S x M x N outputs
exactly once (so the h launch computes dc_in once per pixel: no halo
rows), the dw blocks cover every pixel and channel once, and a GEMM with
at least a wave of 64 x 64 tiles launches at least a wave of blocks.  The
plans of the 87 shapes that predate the tails are pinned.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import hashlib

import math
import os
import re
import sys

import pytest

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.legacy.dcvc_rt import RT_CONFIG
from dcvc_tpu_torch.legacy.rt_intra import DMCIRTConfig
from dcvc_tpu_torch.perf_probe import Launch, rt_stage_launches

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

# the 87 distinct K1 shapes of chip_smoke.py's main path (DMCI 1080p /
# 720p, DMCI -> HTS and DMCI -> HTL chunks, DMCI -> LD frames), as its
# launch log prints them; the last 20 are LD's (dcb2: I = C / 2, so
# I = 64 in the hyper codecs and 192 in the prior fusion, and a 448-wide
# adaptor into the encoder), which perf_probe.ld_stage_launches derives
# from the model
MAIN_PATH = """
fused_dcb 12x20 128->128 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 12x20 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 17x30 128->128 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 17x30 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 24x40 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 24x40 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 24x40 256->256 I=256 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 34x60 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 34x60 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 34x60 256->256 I=256 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 45x80 256->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 45x80 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 45x80 512->512 I=512 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 45x80 512->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 45x80 768->768 I=768 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 48x80 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 48x80 128->256 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 48x80 256->128 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 48x80 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 48x80 256->256 I=256 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 68x120 128->128 I=128 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 68x120 128->256 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 68x120 256->128 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 68x120 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 256->256 I=256 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 68x120 256->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 68x120 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 512->512 I=512 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 68x120 512->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 68x120 768->768 I=768 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 90x160 192->384 I=384 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 192->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 192->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 384->192 I=192 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 384->384 I=384 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 90x160 384->384 I=384 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 90x160 512->512 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 90x160 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 90x160 1024->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 1024->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 2048->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 2048->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 192->384 I=384 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 192->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 192->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 384->192 I=192 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 384->384 I=384 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 136x240 384->384 I=384 adaptor=0 shortcut=1 broadcast_x=0
fused_dcb 136x240 512->512 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 136x240 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 136x240 1024->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 1024->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 2048->512 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 2048->512 I=512 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb_stacked S=1 136x240 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb_stacked S=1 136x240 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb_stacked S=1 136x240 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb_stacked S=2 136x240 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb_stacked S=2 136x240 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=1
fused_dcb_stacked S=4 90x160 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=1
fused_dcb_stacked S=4 136x240 512->512 I=512 adaptor=0 shortcut=0 broadcast_x=1
fused_dcb_stacked S=8 90x160 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb_stacked S=8 90x160 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb_stacked S=8 90x160 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=1
fused_dcb_stacked S=8 136x240 256->256 I=256 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb_stacked S=8 136x240 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb_stacked S=8 136x240 512->256 I=256 adaptor=1 shortcut=0 broadcast_x=1
fused_dcb 12x20 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 136x240 192->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 256->256 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 136x240 448->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 136x240 512->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 17x30 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 24x40 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 34x60 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 45x80 256->256 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 45x80 384->384 I=192 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 45x80 512->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 48x80 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 128->128 I=64 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 256->256 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 384->384 I=192 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 68x120 512->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 192->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 256->256 I=128 adaptor=0 shortcut=0 broadcast_x=0
fused_dcb 90x160 448->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
fused_dcb 90x160 512->256 I=128 adaptor=1 shortcut=0 broadcast_x=0
""".strip().splitlines()
LD_SHAPES = MAIN_PATH[67:]

# the shapes of tests/test_torch_cuda.py
CARD_TESTS = [
    Launch("fused_dcb", 1, 8, 18, 256, 128, 128, True, False, False),
    Launch("fused_dcb", 1, 17, 30, 128, 128, 128, False, True, False),
    Launch("fused_dcb", 1, 5, 7, 192, 384, 384, True, False, False),
    Launch("fused_dcb", 1, 9, 17, 2048, 512, 256, True, False, False),
    Launch("fused_dcb", 1, 7, 13, 768, 768, 768, False, False, False),
    Launch("fused_dcb", 1, 5, 7, 128, 128, 128, False, False, False),
    Launch("fused_dcb", 1, 9, 17, 64, 64, 64, False, False, False),
    Launch("fused_dcb", 1, 12, 40, 384, 384, 384, False, False, False),
    Launch("fused_dcb", 1, 8, 33, 256, 512, 512, True, False, False),
    Launch("fused_dcb_stacked", 8, 17, 30, 256, 128, 128, True, False,
           True),
    Launch("fused_dcb_stacked", 8, 6, 9, 512, 256, 256, True, False, True),
]

_LINE = re.compile(r"(\w+)(?: S=(\d+))? (\d+)x(\d+) (\d+)->(\d+) I=(\d+) "
                   r"adaptor=([01]) shortcut=([01]) broadcast_x=([01])$")


def parse(line):
    """A Launch from its str() (chip_smoke.py's launch log)."""
    m = _LINE.match(line.strip())
    kind, s, h, w, cin, c, inner, ad, sc, bc = m.groups()
    return Launch(kind, int(s or 1), int(h), int(w), int(cin), int(c),
                  int(inner), ad == "1", sc == "1", bc == "1")



def _rt_shapes():
    """The distinct K1 shapes of DCVC-RT's codecs on chip_smoke.py's 1080p
    and 720p frames (perf_probe.rt_stage_launches)."""
    shapes = set()
    for h, w in ((1080, 1920), (720, 1280)):
        for counts in rt_stage_launches(DMCIRTConfig(), RT_CONFIG, h,
                                        w).values():
            shapes.update(counts)
    return sorted(shapes, key=str)


RT_SHAPES = _rt_shapes()
SHAPES = ([parse(line) for line in MAIN_PATH] + list(chip_smoke.TEST_SHAPES)
          + CARD_TESTS + [k for k in RT_SHAPES if str(k) not in MAIN_PATH])
# sha256 of repr() of the 87 MAIN_PATH plans as they were before the tail
# tiles: widening K1 to multiples of 16 changed no launch of them
MAIN_PATH_PLANS_SHA256 = \
    "248d799c00b3c4e122ac10b1b93fc436d57eb3f8d5bba629ac551ed4d70b0fe2"


def plan_of(key):
    return K1.k1_plan(key.s, key.h, key.w, key.cin, key.c, key.inner,
                      key.adaptor)


def test_main_path_list_parses_back():
    assert len(MAIN_PATH) == 87
    assert len(set(MAIN_PATH)) == 87
    for line in MAIN_PATH:
        assert str(parse(line)) == line


def test_main_path_plans_unchanged():
    plans = repr([plan_of(parse(line)) for line in MAIN_PATH]).encode()
    assert hashlib.sha256(plans).hexdigest() == MAIN_PATH_PLANS_SHA256


def test_rt_shapes_derived_from_the_model():
    """DCVC-RT's K1 launches: its intra codec's blocks (42 per encode, 32
    per decode, as DMCI's), 8 of them new shapes, every one at C or Cin =
    368; the P model launches none (its DCBs are the two-way kind)."""
    new = [str(k) for k in RT_SHAPES if str(k) not in MAIN_PATH]
    assert len(new) == 8
    assert all("368" in line for line in new)
    for h, w in ((1080, 1920), (720, 1280)):
        n = {k: sum(v.values()) for k, v in rt_stage_launches(
            DMCIRTConfig(), RT_CONFIG, h, w).items()}
        steps = sum(n[f"prior_step {k}"] for k in (1, 2, 3))
        assert n["analysis"] + n["prior0"] + steps + n["synthesis"] == 42
        assert n["prior0"] + steps + n["synthesis"] == 32
        assert all(v == 0 for k, v in n.items() if k.startswith("p."))


@pytest.mark.parametrize("key", [k for k in RT_SHAPES if "368" in str(k)],
                         ids=str)
def test_368_wide_trunk_takes_tail_tiles(key):
    """C = 368 (or a 368-wide K): the GEMMs of width 368 take 128- or
    64-wide tiles whose last one has a tail (368 = 2 x 128 + 112 = 5 x 64
    + 48), a K of 368 runs 6 stages of GEMM_BK, and the dw launch 6
    channel blocks."""
    plan = {q.name: q for q in plan_of(key)}
    for q in plan.values():
        if q.name == "dw":
            assert q.n != 368 or q.grid[1] == 6
            continue
        if q.n == 368:
            assert q.n % q.bn_out and math.ceil(368 / q.bn_out) in (3, 6)
            last = K1.gemm_block_tile(q, q.grid[0] - 1, 0)
            assert last[4] == 368 and last[4] - last[3] < q.bn_out
        assert math.ceil(q.k / K1.GEMM_BK) * K1.GEMM_BK >= q.k


def test_ld_shapes_derived_from_the_model():
    """LD's lines are the K1 launches of DMC-LD's stage methods at
    LD_CONFIG on chip_smoke.py's 1080p and 720p frames (run on the meta
    device: no memory, no compute), and its launches per call are
    chip_smoke.py's: 27 per encode, 21 per decode, 3 per recon and per
    reset, whichever adaptor runs."""
    spec = dict(chip_smoke.VIDEO["LD"])
    shapes = chip_smoke.ld_spec(spec)
    assert sorted(map(str, shapes)) == sorted(LD_SHAPES)
    assert (spec["encode"], spec["first_encode"], spec["decode"],
            spec["first_decode"], spec["recon"]) == (27, 27, 21, 21, (3, 0))
    inner = {parse(line).inner for line in LD_SHAPES}
    assert {64, 192} <= inner
    assert 448 in {parse(line).cin for line in LD_SHAPES}


@pytest.mark.parametrize("line", [ln for ln in LD_SHAPES if "I=64 " in ln])
def test_single_k_step_gemms_are_planned(line):
    """I = 64: dc_out and ffn_out have a K of 64, one GEMM_BK step; the
    plan still gives them a ring of 2-4 stages (the core's producer loads
    one stage, the consumers wait on it once) and a tile of 64 or 128."""
    key = parse(line)
    plan = {q.name: q for q in plan_of(key)}
    for name in ("dc_out", "ffn_out"):
        q = plan[name]
        assert q.k == K1.GEMM_BK == 64
        assert q.k // K1.GEMM_BK == 1
        assert 2 <= q.stages <= 4 and q.smem <= K1.K1_SMEM_LIMIT
        assert q.n == key.c == 128 and q.bn in (64, 128)
    assert plan["h"].n == plan["ffn_in"].n == 64
    assert plan["dw"].grid[1] == 1          # one 64-channel block


@pytest.mark.parametrize("key", SHAPES, ids=str)
def test_plan_fits_and_covers_once(key):
    plan = plan_of(key)
    names = [q.name for q in plan]
    assert names == [n for n in K1.CHAIN if n != "adaptor" or key.adaptor]
    m = key.h * key.w
    for q in plan:
        assert q.smem <= K1.K1_SMEM_LIMIT, q
        assert q.s == key.s and q.m == m, q
        if q.name == "dw":
            th, tw = q.bm, q.bn
            tiles_w = math.ceil(key.w / tw)
            assert q.grid == (math.ceil(key.h / th) * tiles_w,
                              math.ceil(key.inner / q.bn_out), key.s)
            assert q.bn_out * (q.grid[1] - 1) < key.inner \
                <= q.bn_out * q.grid[1]
            pixels = set()
            for bx in range(q.grid[0]):
                y0, x0 = (bx // tiles_w) * th, (bx % tiles_w) * tw
                pixels.update((y, x) for y in range(y0, min(key.h, y0 + th))
                              for x in range(x0, min(key.w, x0 + tw)))
            assert len(pixels) == m
            continue
        assert q.k % 16 == 0 and q.n % 16 == 0, q
        assert q.n % q.bn_out == 0 or q.n % 64, q   # a tail only past 64s
        assert q.bn == (4 * q.bn_out if q.name == "ffn_in" else q.bn_out)
        assert q.bn in ((256,) if q.name == "ffn_in" else (64, 128))
        assert q.smem == K1.gemm_smem(q.bm, q.bn, q.stages)
        assert 2 <= q.stages <= 4
        # the epilogue's f32 tile fits in the stages it reuses
        assert K1.epilogue_tile_bytes(q.bm, q.bn) <= \
            q.stages * (q.bm + q.bn) * K1.GEMM_BK * 2
        assert q.grid[2] == 1 and q.grid[1] == key.s
        cells = set()
        area = 0
        for by in range(q.grid[1]):
            for bx in range(q.grid[0]):
                s, m0, m1, n0, n1 = K1.gemm_block_tile(q, bx, by)
                assert 0 <= m0 < m1 <= m and 0 <= n0 < n1 <= q.n, q
                cells.add((s, m0, n0))
                area += (m1 - m0) * (n1 - n0)
        # distinct cells of one bm x bn_out grid, whose areas add up to
        # the outputs: every output once
        assert len(cells) == q.grid[0] * q.grid[1]
        assert area == key.s * m * q.n
    h_launch = plan[names.index("h")]
    assert (h_launch.m, h_launch.n, h_launch.k) == (m, key.inner, key.c)


@pytest.mark.parametrize("key", SHAPES, ids=str)
def test_plan_fills_the_card(key):
    """A GEMM with at least a wave of 64 x 64 output tiles launches at
    least a wave of blocks; BM = 128 wherever that still gives one, with
    the widest BN (<= 128; ffn_in: four 64-wide planes) that does."""
    for q in plan_of(key):
        if q.name == "dw":
            continue
        blocks = q.grid[0] * q.grid[1]
        if key.s * q.m * q.n >= K1.K1_SMS * 64 * 64:
            assert blocks >= K1.K1_SMS, q
        wide = key.s * math.ceil(q.m / 128) * math.ceil(q.n / 64)
        assert (q.bm == 128) == (wide >= K1.K1_SMS), q
        if q.name != "ffn_in" and q.bn == 64 and K1.tile_fits(128, q.n):
            assert key.s * math.ceil(q.m / q.bm) * math.ceil(q.n / 128) \
                < K1.K1_SMS, q


def test_plan_ints_rows():
    """plan_ints: PLAN_INTS ints per launch of CHAIN, zeros for the
    adaptor of a block without one; the C entry reads them in this
    order."""
    plan = K1.k1_plan(1, 9, 17, 128, 128, 128, False)
    ints = list(K1.plan_ints(plan))
    n = K1.PLAN_INTS
    assert len(ints) == n * len(K1.CHAIN)
    assert ints[:n] == [0] * n
    for i, q in enumerate(plan):
        assert ints[n * (i + 1):n * (i + 2)] == [
            1, q.bm, q.bn, q.bn_out, q.stages, *q.grid, q.smem]


@pytest.mark.parametrize("tile,n", [
    ((64, 64), 512), ((128, 128), 512), ((64, 128), 384),
    ((128, 128), 320),   # 128 does not divide N = 320: 64
    ((128, 128), 368),   # no 64-wide divisor: 128 with a tail
    ((128, 256), 512),   # no 256-wide tile but ffn_in's: 64
])
def test_plan_tile_override(tile, n):
    """k1_plan(tile=) forces every GEMM's tile (the card tests' BM = 64 /
    128 cases); a width that does not fit N (K1.tile_fits) falls back to
    64."""
    for q in K1.k1_plan(1, 9, 17, n, n, n, False, tile):
        if q.name == "dw":
            continue
        assert q.bm == tile[0]
        if q.name != "ffn_in":
            fits = tile[1] <= 128 and (n % tile[1] == 0 or n % 64)
            assert q.bn == (tile[1] if fits else 64)


@pytest.mark.parametrize("line", [ln for ln in LD_SHAPES if "I=192 " in ln])
def test_192_wide_inner_is_planned(line):
    """I = 192 (LD's prior fusion, C = 384): 128 does not divide 192, so
    the GEMMs of width I take 64-wide tiles, dc_out and ffn_out a K of
    three GEMM_BK steps, and the dw launch three 64-channel blocks."""
    key = parse(line)
    plan = {q.name: q for q in plan_of(key)}
    assert plan["h"].n == 192 and plan["h"].bn == 64
    assert plan["ffn_in"].bn_out == 64
    assert plan["dc_out"].k == plan["ffn_out"].k == 3 * K1.GEMM_BK
    assert plan["dw"].grid[1] == 3
