"""The port's complexity counter and trace context, mirroring
tests/test_complexity.py: a matmul counts exactly m*k*n MACs
(FlopCounterMode counts products, where XLA's cost analysis also counts
elementwise work, so the port's counts are not held to the JAX
package's); each TINY model's training forward (DCVC-FM's, DCVC-HEM's
and DCVC-DC's: the eval forward of a later P frame) counts more than
zero kMACs per pixel, a video chunk's per pixel of each of its frames; a
1x1 convolution counts H*W*Cin*Cout; the trace context writes a Chrome
trace and the counters of its window.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json
import os

import pytest
import torch

from dcvc_tpu_torch.legacy.compressai_zoo import Cheng2020Anchor, \
    ScaleHyperprior, TINY_CHENG2020, TINY_HYPERPRIOR
from dcvc_tpu_torch.legacy.dcvc_dc import DMCDC, TINY_DC_CONFIG
from dcvc_tpu_torch.legacy.dcvc_net import DCVCNet, TINY_DCVC_CONFIG
from dcvc_tpu_torch.legacy.dcvc_fm import DMCFM, TINY_FM_CONFIG
from dcvc_tpu_torch.legacy.dcvc_hem import DMCHEM, TINY_HEM_CONFIG
from dcvc_tpu_torch.legacy.dcvc_tcm import DMCTCM, TINY_TCM_CONFIG
from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HT_CONFIG, \
    TINY_HTL_CONFIG
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.utils.model_complexity import count_macs, \
    model_macs_per_pixel, summarize
from dcvc_tpu_torch.utils.profiling import count, trace


def test_matmul_macs():
    a = torch.zeros(128, 256)
    b = torch.zeros(256, 64)
    assert count_macs(lambda x, y: x @ y, a, b) == 128 * 256 * 64


def test_conv_macs():
    conv = torch.nn.Conv2d(16, 32, 1)
    assert count_macs(conv, torch.zeros(1, 16, 8, 8)) == 8 * 8 * 16 * 32


@pytest.mark.parametrize("model", [
    lambda: DMCI(TINY_CONFIG), lambda: DMCHT(TINY_HT_CONFIG),
    lambda: DMCHT(TINY_HTL_CONFIG), lambda: DMCLD(TINY_LD_CONFIG),
    lambda: DMCFM(TINY_FM_CONFIG), lambda: DMCHEM(TINY_HEM_CONFIG),
    lambda: DMCDC(TINY_DC_CONFIG), lambda: DCVCNet(TINY_DCVC_CONFIG),
    lambda: Cheng2020Anchor(TINY_CHENG2020),
    lambda: ScaleHyperprior(TINY_HYPERPRIOR),
    lambda: DMCTCM(TINY_TCM_CONFIG)],
    ids=["dmci", "hts", "htl", "ld", "fm", "hem", "dc", "dcvc", "cheng2020",
         "bmshj2018", "tcm"])
def test_model_complexity_runs(model):
    model = model()
    kmacs = model_macs_per_pixel(model, 64, 64)
    assert kmacs > 0
    # the count is per pixel: the same at another size, up to the edges
    assert abs(model_macs_per_pixel(model, 128, 64) / kmacs - 1) < 0.2
    assert all(p.requires_grad for p in model.parameters())


def test_summarize_lists_each_size():
    text = summarize(DMCI(TINY_CONFIG), resolutions=((64, 64), (60, 100)))
    assert text.splitlines()[0].startswith("64x64: ")
    assert text.splitlines()[1].startswith("60x100: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
        count("entropy.symbols", 7)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert sorted(os.listdir(tmp_path)) == ["counters.json", "trace.json"]
    with open(tmp_path / "counters.json") as f:
        assert json.load(f)["counters"] == {"entropy.symbols": 7}
