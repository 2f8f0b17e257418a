"""Reference checkpoints: a .pth.tar in the reference's format, read by
dcvc_tpu's importer (load_torch_checkpoint + import_state_dict) and by the
port's loader (utils/checkpoint.py), gives codecs whose streams are
byte-identical, on the CPU in float32.

The file is the port's seeded random TINY DMCI and DMC-LD state_dicts
(the LD kernels damped by 0.5 and the fusion prior's scale bias lifted by
2, as in tests/test_torch_dmc_ld.py, so that y is coded), saved with
torch.save as {"state_dict": {"module." + key: tensor}}, with the entropy
coder's cached tables beside them (both loaders ignore those).  The port's
loader raises on a key the model does not use and on one it lacks.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmc_ld import TINY_LD_CONFIG as JAX_TINY_LD
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY_I
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxDMCI
from dcvc_tpu.runtime.video_codec import DMCLDCodec as JaxLD
from dcvc_tpu.utils.torch_import import import_state_dict, key_fn_dmc_ld, \
    key_fn_dmci, load_torch_checkpoint
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCLDCodec
from dcvc_tpu_torch.utils.checkpoint import load_reference_into, \
    load_state_dict_file

H, W, QP_I, QP_P = 64, 96, 3, 5
RESETS = [False, True, False]


def _save(path, state, extra=None):
    wrapped = {"module." + k: v for k, v in state.items()}
    wrapped.update(extra or {})
    torch.save({"state_dict": wrapped}, path)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    i_model = DMCI(TINY_CONFIG)
    i_model.reset_parameters(torch.Generator().manual_seed(3))
    p_state = DMCLDCodec.init_random(
        torch.Generator().manual_seed(4), cfg=TINY_LD_CONFIG, init_scale=0.5,
        dtype=torch.float32, device="cpu").model.state_dict()
    cy = TINY_LD_CONFIG.ch_y
    p_state["y_prior_fusion.conv.3.bias"][cy:2 * cy] += 2.0
    cached = {"module.bit_estimator_z.quantized_cdf": torch.zeros(4, 8),
              "module.bit_estimator_z.cdf_length": torch.zeros(4)}
    return (_save(root / "i.pth.tar", i_model.state_dict(), cached),
            _save(root / "p.pth.tar", p_state, cached))


def _frames(seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (H, W, 3)), 3.0)
    return [(np.clip(np.roll(base, i, axis=1), 0, 1) - 0.5)[None].astype(
        np.float32) for i in range(len(RESETS) + 1)]


def _code(i_codec, p_codec, frames):
    """The intra frame's stream, then the P frames' (streams, x_hat)."""
    intra = i_codec.compress(frames[0], QP_I)
    p_codec.clear_dpb()
    p_codec.add_ref_feature_from_frame(intra["x_hat"])
    res = [p_codec.compress(x, QP_P, reset_feature_memory=rs)
           for x, rs in zip(frames[1:], RESETS)]
    return [intra["bit_stream"]] + [r["bit_stream"] for r in res]


def test_both_loaders_give_the_same_streams(files):
    i_path, p_path = files
    ji = JaxDMCI.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY_I,
                             dtype=jnp.float32)
    params, unused = import_state_dict(load_torch_checkpoint(i_path),
                                       ji.params, key_fn=key_fn_dmci)
    assert unused == []
    ji = JaxDMCI(params, cfg=JAX_TINY_I, dtype=jnp.float32)
    jp = JaxLD.init_random(jax.random.PRNGKey(1), cfg=JAX_TINY_LD,
                           dtype=jnp.float32)
    params, unused = import_state_dict(load_torch_checkpoint(p_path),
                                       jp.params, key_fn=key_fn_dmc_ld)
    assert unused == []
    jp = JaxLD(jp.model, params)

    kw = {"dtype": torch.float32, "device": "cpu"}
    ti = DMCICodec(load_reference_into(DMCI(TINY_CONFIG), i_path)
                   .state_dict(), cfg=TINY_CONFIG, **kw)
    tp = DMCLDCodec(load_reference_into(DMCLD(TINY_LD_CONFIG), p_path)
                    .state_dict(), cfg=TINY_LD_CONFIG, **kw)
    frames = _frames(0)
    want = _code(ji, jp, frames)
    got = _code(ti, tp, frames)
    assert all(len(s) > 40 for s in want[1:]), "a P frame codes no y"
    assert got == want


def test_state_dict_file_unwraps_and_strips(files):
    _, p_path = files
    state = load_state_dict_file(p_path)
    assert "y_prior_fusion.conv.3.bias" in state
    assert not any(k.startswith("module.") for k in state)
    assert set(state) - set(DMCLD(TINY_LD_CONFIG).state_dict()) == {
        "bit_estimator_z.quantized_cdf", "bit_estimator_z.cdf_length"}


def test_loader_raises_on_unknown_and_missing_keys(files, tmp_path):
    _, p_path = files
    state = load_state_dict_file(p_path)
    bogus = _save(tmp_path / "bogus.pth.tar",
                  dict(state, **{"decoder.extra.weight": torch.zeros(1)}))
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        load_reference_into(DMCLD(TINY_LD_CONFIG), bogus)
    del state["recon_head.head.bias"]
    short = _save(tmp_path / "short.pth.tar", state)
    with pytest.raises(KeyError, match="recon_head.head.bias"):
        load_reference_into(DMCLD(TINY_LD_CONFIG), short)
