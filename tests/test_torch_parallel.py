"""Port parity, parallelism: dcvc_tpu_torch.parallel against
dcvc_tpu.parallel and __graft_entry__.py, float32 on the CPU at the TINY
configs.

- Data parallelism (parallel/ddp.py, parallel/dryrun.py): 2 gloo ranks,
  spawned through a file:// rendezvous under tmp_path, take the image
  step (TINY DMCI, a global batch of 4) and the 2-chunk cascaded LD step
  that one process takes on the whole batch: loss and grad norm within
  1e-5 (relative), every element of the averaged gradient within 1e-5
  of its global norm and the parameters by the training tests' AdamW rule
  (dryrun.params_close); and what one process computes on each rank's
  rows in turn, its gradients averaged as the all-reduce averages them
  (loss, grad norm, gradient and parameters within 1e-6).  This is
  dryrun_multichip(2), on its smooth pictures and on uniform noise.
- entry(): the DMCI forward at 256x256 in bfloat16 (the CPU runs the
  plain blocks): finite outputs of the right shapes.
- The split DCB chain (run_row_tiles, the halo derived by
  receptive_radius) equals the unsplit chain within 1e-5, and the
  unsplit chain equals flax's (dcvc_tpu's
  test_spatial_sharding_matches_single_device and its tolerance).
- The split TINY DMCI codec (spatial_devices, 2 tiles), dcvc_tpu's
  tests/test_spatial_stream.py contract: its round trip bit-exact at qp
  0 and 5; its streams decode on the unsplit port codec and on JAX's
  spatial_mesh codec (conftest's 8 virtual CPU devices), and theirs on
  it, reconstructions within 1e-4 (tests/test_torch_image_codec.py's
  bound); on the same z its prior0's decisions identical to those of
  JAX's spatial_mesh codec.
- The halo: one pixel changed at a tile's edge moves the split analysis
  as it moves the whole frame's; one changed just past the derived
  receptive radius of a core row (analysis and synthesis) leaves that
  row exactly as it was.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dcvc_tpu.layers.blocks import DepthConvBlock as JaxDCB
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxCodec
from dcvc_tpu_torch.layers.blocks import DepthConvBlock
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.parallel import dryrun, spatial
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax

H, W = 128, 64
X_HAT_ATOL = 1e-4
SPLIT = ["cpu", "cpu"]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    result = dryrun.dryrun_multichip(
        2, "cpu", init_method=f"file://{tmp_path / 'rendezvous'}")
    for name in ("image", "ld"):
        ranks, one = result[name]["ranks"], result[name]["one_process"]
        assert np.isfinite(ranks["loss"]) and ranks["grad_norm"] > 0, name
        assert abs(ranks["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        same = result[name]["gaps"]["ranks vs rows_in_turn"]
        assert max(same.values()) <= 1e-6


def test_two_gloo_ranks_equal_one_process_on_noise(tmp_path):
    """The same on uniform-noise pictures, the TINY LD near overflow (its
    loss ~1e4 here): a batch split moves nothing past float32 rounding."""
    result = dryrun.dryrun_multichip(
        2, "cpu", init_method=f"file://{tmp_path / 'rendezvous'}",
        inputs="noise")
    for name in ("image", "ld"):
        ranks, one = result[name]["ranks"], result[name]["one_process"]
        assert abs(ranks["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        same = result[name]["gaps"]["ranks vs rows_in_turn"]
        assert max(same.values()) <= 1e-6


def test_entry_forward_in_bf16():
    fn, args = dryrun.entry("cpu")
    with torch.no_grad():
        x_hat, bpp, mse = fn(*args)
    assert x_hat.shape == (1, 256, 256, 3) and bpp.shape == mse.shape == (1,)
    assert all(bool(torch.isfinite(t.float()).all()) for t in (x_hat, bpp,
                                                               mse))


def test_split_dcb_chain_matches_unsplit():
    block = JaxDCB(16, 16, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 32, 16)).astype(np.float32)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = block.apply(params, block.apply(params, jnp.asarray(x)))
    tblock = DepthConvBlock(16, 16)
    tblock.load_state_dict(dmci_params_from_jax(params["params"]))
    chain = torch.nn.Sequential(tblock, tblock)
    radius, stride = spatial.receptive_radius(spatial.spatial_ops(chain))
    assert (radius, stride) == (2, 1)
    with torch.no_grad():
        whole = chain(torch.from_numpy(x))
        got = spatial.run_row_tiles(chain, torch.from_numpy(x), 8,
                                    int(radius))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def codecs():
    jbase = JaxCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                 dtype=jnp.float32)
    jsplit = JaxCodec(jbase.params, cfg=JAX_TINY, dtype=jnp.float32,
                      spatial_mesh=Mesh(np.asarray(jax.devices()),
                                        ("data",)))
    params = dmci_params_from_jax(jbase.params)
    kw = {"cfg": TINY_CONFIG, "dtype": torch.float32, "device": "cpu"}
    return DMCICodec(params, **kw), \
        DMCICodec(params, spatial_devices=SPLIT, **kw), jsplit


def image(seed, h=H, w=W):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (1, h, w, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("qp", [0, 5])
def test_split_roundtrip_bit_exact(codecs, qp):
    _, split, _ = codecs
    enc = split.compress(image(11), qp)
    out = split.decompress(enc["bit_stream"], qp, H, W, enc["ec_parallel"])
    assert torch.equal(out["x_hat"], enc["x_hat"])


def cross(enc_codec, dec_codec, qp=3):
    enc = enc_codec.compress(image(12), qp)
    out = dec_codec.decompress(enc["bit_stream"], qp, H, W,
                               enc["ec_parallel"])
    np.testing.assert_allclose(np.asarray(out["x_hat"]),
                               np.asarray(enc["x_hat"]), rtol=0,
                               atol=X_HAT_ATOL)


def test_cross_decode_with_the_unsplit_codec(codecs):
    base, split, _ = codecs
    cross(split, base)
    cross(base, split)


def test_cross_decode_with_jax_spatial_mesh(codecs):
    _, split, jsplit = codecs
    cross(split, jsplit)
    cross(jsplit, split)


def test_decisions_identical_on_the_same_z(codecs):
    """On the z of JAX's spatial_mesh codec, the split codec's prior0 gives
    that codec's decisions: the CDF indexes, positions, count and mask
    identical; the means and the context within 1e-5 of their peak
    (tests/test_torch_dmci.py's stage tolerance: the two frameworks'
    float32 arithmetic differs by ulps)."""
    _, split, jsplit = codecs
    programs = jsplit._get_programs(H, W)
    _, z_j = programs["analysis"](jnp.asarray(image(13)), jnp.int32(2))
    p = split._plan(H, W)
    with torch.no_grad():
        got = split._prior0(p, torch.from_numpy(np.array(z_j)))[:6]
    want = [np.asarray(t) for t in programs["prior0"](z_j)]
    for a, b in zip(got[:2], want[:2]):      # means, ctx
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= \
            1e-5 * float(np.abs(b).max())
    for a, b in zip(got[2:], want[2:]):      # packed_idx, packed_pos,
        np.testing.assert_array_equal(a.numpy(), b)   # count, cond


def test_halo_covers_the_receptive_field(codecs):
    base, split, _ = codecs
    model = base.model
    sp = split.spatial
    x = torch.from_numpy(image(14, 512, W))
    p = base._plan(512, W)
    tiles = spatial.analysis_tiles(512, 2, sp.align, sp.halo)
    edge = sp.align * tiles[0][3]          # the first row of tile 1's core
    moved = x.clone()
    moved[0, edge, 5] += 0.9
    with torch.no_grad():
        y0, z0 = base._analysis(p, x, 1)
        y1, z1 = base._analysis(p, moved, 1)
        ys, zs = split._analysis(p, moved, 1)
    assert not torch.equal(y0, y1)
    np.testing.assert_allclose(ys.numpy(), y1.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(zs, z1)
    # a pixel just past the derived radius of tile 0's last z row
    radius, _ = spatial.receptive_radius(spatial.spatial_ops(model.enc)
                                         + spatial.spatial_ops(
                                             model.hyper_enc))
    far = x.clone()
    far[0, edge + int(radius), 5] += 0.9
    with torch.no_grad():
        y2, z2 = model.analysis(far, 1)
        z_ref = model.analysis(x, 1)[1]
    assert torch.equal(z2[:, :tiles[0][3]], z_ref[:, :tiles[0][3]])
    # the synthesis: a y row just past its radius leaves core rows alone
    halo = sp.syn_halo
    yh = y0.shape[1]
    y = torch.from_numpy(np.random.default_rng(15).standard_normal(
        y0.shape).astype(np.float32))
    bumped = y.clone()
    lo, hi = spatial.split_rows(yh, 2)[0]
    bumped[0, hi + halo, 1] += 3.0
    with torch.no_grad():
        a = model.synthesis(y, 1, 16 * yh, W)
        b = model.synthesis(bumped, 1, 16 * yh, W)
    assert torch.equal(a[:, :16 * hi], b[:, :16 * hi])
    assert not torch.equal(a, b)


def test_split_pipelined_calls_match_serial(codecs):
    """The split codec's compress_many / decompress_many give its own
    serial calls' streams and frames, bit for bit."""
    _, split, _ = codecs
    qps = [0, 5, 3]
    images = [image(20 + i) for i in range(len(qps))]
    many = split.compress_many(images, qps, depth=1)
    serial = [split.compress(x, qp) for x, qp in zip(images, qps)]
    for r, s in zip(many, serial):
        assert r["bit_stream"] == s["bit_stream"]
        assert r["ec_parallel"] == s["ec_parallel"]
        assert torch.equal(r["x_hat"], s["x_hat"])
    outs = split.decompress_many([r["bit_stream"] for r in many], qps, H, W,
                                 [r["ec_parallel"] for r in many], depth=2)
    for o, s in zip(outs, serial):
        assert torch.equal(o["x_hat"], s["x_hat"])
