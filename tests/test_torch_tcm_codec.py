"""Port parity, the DCVC-TCM P-frame codec: dcvc_tpu_torch's
runtime/tcm_codec.py DMCTCMCodec against dcvc_tpu's at TINY_TCM_CONFIG,
float32 on the CPU.

- Both codecs on tests/test_torch_dcvc_tcm.py's lifted weights (carried
  to the JAX codec by tcm_params_to_jax; no flax init), at 64x64 (the
  1x1 z grid) and at the odd 72x88 (padded to 128x128): one intra-seeded
  DPB, then 3 P frames, each coding against the previous reconstruction
  and, from the second on, the carried feature.  Every stream is the JAX
  codec's byte for byte, every x_hat within atol = rtol = 2e-5 of the
  JAX one; the port's decoder, from the same DPB, reproduces every x_hat
  and the final DPB (frame and feature) bit for bit, and the JAX decoder
  the JAX encoder's from the port's streams.  Encoding again from the
  same DPB gives the same bytes; a P frame with an empty DPB raises.
- Weights both ways: a port-written params.v1 file read by the JAX
  load_params codes the same bytes in the JAX codec, a JAX-written one
  read by load_native_into codes them in the port's, and so does a
  reference .pth.tar synthesised through key_fn_tcm, read by
  load_reference_into.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_tcm as jtcm
from dcvc_tpu.runtime import tcm_codec as jcodec
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.legacy import dcvc_tcm
from dcvc_tpu_torch.runtime import tcm_codec
from dcvc_tpu_torch.utils.checkpoint import load_reference_into
from dcvc_tpu_torch.utils.jax_bridge import load_native_into, save_native
from test_torch_dcvc_net import frames
from test_torch_dcvc_tcm import JAX_TINY, TINY, _close, jax_params, \
    lifted_model, reference_state

P_FRAMES = 3


@pytest.fixture(scope="module")
def model():
    return lifted_model(seed=1)


@pytest.fixture(scope="module")
def codecs(model):
    """(the port's codec, the JAX codec) on the same lifted weights."""
    state = model.state_dict()
    port = tcm_codec.DMCTCMCodec(state, cfg=TINY, device="cpu")
    jax_codec = jcodec.DMCTCMCodec(jtcm.DMCTCM(cfg=JAX_TINY),
                                   jax_params(state))
    return port, jax_codec


def sequence(h, w):
    """(intra reconstruction, P_FRAMES frames), each frame the previous
    one shifted by 2 px."""
    ref = frames(h, w, h + w)[0]
    return ref, [np.clip(np.roll(ref, 2 * (i + 1), 2), 0, 1)
                 for i in range(P_FRAMES)]


def encode(codec, ref, seq, h, w):
    codec.set_ref_frame(ref, h, w)
    return [codec.compress(x) for x in seq]


@pytest.mark.parametrize("h,w", [(64, 64), (72, 88)])
def test_streams_match_jax(codecs, h, w):
    port, jax_codec = codecs
    ref, seq = sequence(h, w)
    got = encode(port, ref, seq, h, w)
    want = encode(jax_codec, ref, seq, h, w)
    for i, (g, wt) in enumerate(zip(got, want)):
        assert g["bit_stream"] == wt["bit_stream"], i
        assert len(g["bit_stream"]) > 60
        assert g["x_hat"].shape == (1, h, w, 3)
        _close(g["x_hat"], wt["x_hat"])
    enc_dpb = port.dpb
    assert enc_dpb["ref_feature"] is not None
    again = encode(port, ref, seq[:1], h, w)
    assert again[0]["bit_stream"] == got[0]["bit_stream"]

    port.set_ref_frame(ref, h, w)
    for res in got:
        out = port.decompress(res["bit_stream"], h, w)
        assert torch.equal(out["x_hat"], res["x_hat"])
    for k, v in enc_dpb.items():
        assert torch.equal(port.dpb[k], v), k
    jax_codec.set_ref_frame(ref, h, w)
    for res, wt in zip(got, want):
        out = jax_codec.decompress(res["bit_stream"], h, w)
        np.testing.assert_array_equal(np.asarray(out["x_hat"]),
                                      np.asarray(wt["x_hat"]))


def test_empty_dpb_raises():
    codec = tcm_codec.DMCTCMCodec.init_random(
        torch.Generator().manual_seed(0), cfg=TINY, init_scale=0.4,
        device="cpu")
    with pytest.raises(ValueError, match="DPB empty"):
        codec.compress(np.zeros((1, 64, 64, 3), np.float32))


def test_weights_both_ways(codecs, model, tmp_path):
    port, _ = codecs
    h, w = 64, 64
    ref, seq = sequence(h, w)
    seq = seq[:2]
    want = [r["bit_stream"] for r in encode(port, ref, seq, h, w)]

    save_native(model, str(tmp_path / "port.bin"))
    tree, hdr = load_params(str(tmp_path / "port.bin"))
    assert hdr["config"] == vars(TINY)
    jax_codec = jcodec.DMCTCMCodec(jtcm.DMCTCM(cfg=JAX_TINY), tree)
    assert [r["bit_stream"] for r in encode(jax_codec, ref, seq, h, w)] \
        == want

    save_params(str(tmp_path / "jax.bin"),
                jax.tree.map(np.asarray, jax_params(model.state_dict())),
                JAX_TINY)
    path = str(tmp_path / "tcm.pth.tar")
    torch.save({"state_dict": reference_state(model)}, path)
    for loaded in (load_native_into(dcvc_tcm.DMCTCM(TINY),
                                    str(tmp_path / "jax.bin")),
                   load_reference_into(dcvc_tcm.DMCTCM(TINY), path)):
        codec = tcm_codec.DMCTCMCodec(loaded.state_dict(), cfg=TINY,
                                      device="cpu")
        assert [r["bit_stream"] for r in encode(codec, ref, seq, h, w)] \
            == want
