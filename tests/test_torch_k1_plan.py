"""K1's launch plan (kernels/fused_dcb.py::k1_plan), on the CPU.

On the card one call of K1 is a chain of launches (adaptor, h, dw,
dc_out, ffn_in, ffn_out; csrc/fused_dcb.cu).  The plan of each call is
made in Python and checked by the C entry, so it is tested here, at every
shape the main path of chip_smoke.py launches K1 at (listed below as its
launch log prints them), at chip_smoke.py's TEST_SHAPES and at the shapes
of the card tests: every launch fits in a Hopper block's shared memory,
the K and N of every GEMM are multiples of 64, the blocks of each GEMM
cover its S x M x N outputs exactly once (so the h launch computes dc_in
once per pixel: no halo rows), the dw blocks cover every pixel and
channel once, and a GEMM with at least a wave of 64 x 64 tiles launches at
least a wave of blocks.
"""

import math
import os
import re
import sys

import pytest

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.perf_probe import Launch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

# the 67 distinct K1 shapes of chip_smoke.py's main path (DMCI 1080p /
# 720p, DMCI -> HTS and DMCI -> HTL chunks), as its launch log prints them
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
""".strip().splitlines()

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


SHAPES = ([parse(line) for line in MAIN_PATH] + list(chip_smoke.TEST_SHAPES)
          + CARD_TESTS)


def plan_of(key):
    return K1.k1_plan(key.s, key.h, key.w, key.cin, key.c, key.inner,
                      key.adaptor)


def test_main_path_list_parses_back():
    assert len(MAIN_PATH) == 67
    assert len(set(MAIN_PATH)) == 67
    for line in MAIN_PATH:
        assert str(parse(line)) == line


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
                              key.inner // q.bn_out, key.s)
            assert q.bn_out * q.grid[1] == key.inner
            pixels = set()
            for bx in range(q.grid[0]):
                y0, x0 = (bx // tiles_w) * th, (bx % tiles_w) * tw
                pixels.update((y, x) for y in range(y0, min(key.h, y0 + th))
                              for x in range(x0, min(key.w, x0 + tw)))
            assert len(pixels) == m
            continue
        assert q.k % 64 == 0 and q.n % 64 == 0, q
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
        wide = key.s * math.ceil(q.m / 128) * (q.n // 64)
        assert (q.bm == 128) == (wide >= K1.K1_SMS), q
        if q.name != "ffn_in" and q.bn == 64 and q.n % 128 == 0:
            assert key.s * math.ceil(q.m / q.bm) * (q.n // 128) \
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
    ((128, 256), 512),   # no 256-wide tile but ffn_in's: 64
])
def test_plan_tile_override(tile, n):
    """k1_plan(tile=) forces every GEMM's tile (the card tests' BM = 64 /
    128 cases); a width that does not divide N falls back to 64."""
    for q in K1.k1_plan(1, 9, 17, n, n, n, False, tile):
        if q.name == "dw":
            continue
        assert q.bm == tile[0]
        if q.name != "ffn_in":
            fits = tile[1] <= 128 and n % tile[1] == 0
            assert q.bn == (tile[1] if fits else 64)
