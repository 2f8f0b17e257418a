"""Port parity, the DMCI codec end to end: dcvc_tpu_torch's DMCICodec
against dcvc_tpu's at TINY_CONFIG, float32 on the CPU, on the same weights
(through the bridge), inputs and qp.

The port's round trip must be bit-exact, its stream byte-identical to the
JAX codec's, and it must decode the JAX codec's stream to the same
reconstruction.  64x64 gives an even 4x4 y grid, 80x112 an odd 5x7 one.
Reconstructions of the two codecs are compared within an absolute 1e-4,
the bound of tests/test_torch_dmci.py for the synthesis stage.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxCodec
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.runtime import symbols
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax

CASES = [(64, 64, 0), (80, 112, 5)]
X_HAT_ATOL = 1e-4


@pytest.fixture(scope="module")
def codecs():
    jcodec = JaxCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                  dtype=jnp.float32)
    tcodec = DMCICodec(dmci_params_from_jax(jcodec.params), cfg=TINY_CONFIG,
                       dtype=torch.float32, device="cpu")
    return jcodec, tcodec


@pytest.fixture(scope="module")
def jax_results(codecs):
    """The JAX codec's compress of each case, shared by the tests."""
    jcodec, _ = codecs
    return {(h, w, qp): (_image(h, w, qp), jcodec.compress(_image(h, w, qp),
                                                           qp))
            for h, w, qp in CASES}


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    from scipy.ndimage import gaussian_filter
    for c in range(3):
        x[0, :, :, c] = gaussian_filter(x[0, :, :, c], 3.0)
    return np.clip(x, 0, 1) - 0.5


@pytest.mark.parametrize("h,w,qp", CASES)
def test_roundtrip_bit_exact(codecs, h, w, qp):
    _, tcodec = codecs
    res = tcodec.compress(_image(h, w, qp), qp)
    out = tcodec.decompress(res["bit_stream"], qp, h, w, res["ec_parallel"])
    assert out["x_hat"].shape == (1, h, w, 3)
    assert torch.equal(res["x_hat"], out["x_hat"])


@pytest.mark.parametrize("h,w,qp", CASES)
def test_stream_byte_identical_to_jax(codecs, jax_results, h, w, qp):
    _, tcodec = codecs
    x, jres = jax_results[(h, w, qp)]
    res = tcodec.compress(x, qp)
    assert res["ec_parallel"] == jres["ec_parallel"]
    assert res["bit_stream"] == jres["bit_stream"]
    np.testing.assert_allclose(res["x_hat"].numpy(),
                               np.asarray(jres["x_hat"]), rtol=0,
                               atol=X_HAT_ATOL)


@pytest.mark.parametrize("h,w,qp", CASES)
def test_decodes_jax_stream(codecs, jax_results, h, w, qp):
    _, tcodec = codecs
    _, jres = jax_results[(h, w, qp)]
    out = tcodec.decompress(jres["bit_stream"], qp, h, w,
                            jres["ec_parallel"])
    np.testing.assert_allclose(out["x_hat"].numpy(),
                               np.asarray(jres["x_hat"]), rtol=0,
                               atol=X_HAT_ATOL)


def test_compaction_order_matches_jax():
    from dcvc_tpu.runtime import symbols as jsymbols
    rng = np.random.default_rng(7)
    n = 1000
    idx = rng.integers(0, 128, n).astype(np.uint8)
    cond = rng.uniform(size=n) < 0.4
    vals = rng.integers(-128, 128, n).astype(np.int16)
    got = symbols.compact_idx(torch.from_numpy(idx), torch.from_numpy(cond))
    want = jsymbols.compact_idx(jnp.asarray(idx), jnp.asarray(cond))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        symbols.compact_vals(torch.from_numpy(vals),
                             torch.from_numpy(cond)).numpy(),
        np.asarray(jsymbols.compact_vals(jnp.asarray(vals),
                                         jnp.asarray(cond))))
    count = int(cond.sum())
    decoded = rng.integers(-128, 128, count + 16).astype(np.int8)
    decoded[count:] = 0
    np.testing.assert_array_equal(
        symbols.expand_from_pos(got[1], torch.from_numpy(decoded), n).numpy(),
        np.asarray(jsymbols.expand_from_pos(want[1], jnp.asarray(decoded),
                                            n)))


def test_quantize_candidate_rounds_half_to_even():
    y = torch.tensor([[[[0.5, 1.5, -0.5, -2.5, 300.0, -300.0, 0.49, 7.0]]]])
    cond = torch.tensor([True] * 7 + [False])
    got = symbols.quantize_candidate(y, torch.zeros_like(y), cond)
    assert got.dtype == torch.int8
    assert got.reshape(-1).tolist() == [0, 2, 0, -2, 127, -128, 0, 0]


# ------------------------------------------------------ the pipelined calls

def test_compress_many_matches_jax_and_serial(codecs, jax_results):
    """The port's compress_many gives the JAX codec's compress_many streams
    byte for byte (both lag their host halves, depth 1 here), and the
    port's serial compress, streams and x_hat bit for bit."""
    jcodec, tcodec = codecs
    cases = CASES + [(64, 64, 3)]
    images = [_image(h, w, qp) for h, w, qp in cases]
    qps = [qp for _, _, qp in cases]
    jres = jcodec.compress_many(images, qps, depth=1)
    many = tcodec.compress_many(images, qps, depth=1)
    for (h, w, qp), x, r, j in zip(cases, images, many, jres):
        serial = tcodec.compress(x, qp)
        assert r["bit_stream"] == j["bit_stream"] == serial["bit_stream"]
        assert r["ec_parallel"] == j["ec_parallel"] == serial["ec_parallel"]
        assert torch.equal(r["x_hat"], serial["x_hat"])
        if (h, w, qp) in jax_results:
            assert r["bit_stream"] == jax_results[(h, w, qp)][1]["bit_stream"]


def test_halves_make_compress(codecs):
    """compress is compress_finish(compress_async(...)): the device half
    returns before any host coding, and several halves may be in flight
    before their host halves run in input order."""
    _, tcodec = codecs
    xs = [_image(64, 64, s) for s in (20, 21)]
    states = [tcodec.compress_async(x, 4) for x in xs]
    assert all(st["x_hat"].shape == (1, 64, 64, 3) for st in states)
    for x, st in zip(xs, states):
        r = tcodec.compress_finish(st)
        assert r["bit_stream"] == tcodec.compress(x, 4)["bit_stream"]


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_decompress_many_bit_exact(codecs, depth):
    """decompress_many gives the serial decodes' x_hat bit for bit, with
    fewer slots than images (depth 1, 3) and more (10)."""
    _, tcodec = codecs
    h, w = 80, 112
    qps = [5, 0, 5, 2]
    enc = [tcodec.compress(_image(h, w, 30 + i), qp)
           for i, qp in enumerate(qps)]
    streams = [r["bit_stream"] for r in enc]
    ecs = [r["ec_parallel"] for r in enc]
    outs = tcodec.decompress_many(streams, qps, h, w, ecs, depth=depth)
    assert len(outs) == len(enc)
    for r, o, bs, qp, ec in zip(enc, outs, streams, qps, ecs):
        serial = tcodec.decompress(bs, qp, h, w, ec)["x_hat"]
        assert torch.equal(o["x_hat"], serial)
        assert torch.equal(o["x_hat"], r["x_hat"])


def test_lagged_runs_host_halves_depth_behind():
    from dcvc_tpu_torch.runtime.image_codec import lagged
    events = []

    def starts():
        for i in range(5):
            events.append(("device", i))
            yield i

    def finish(i):
        events.append(("host", i))
        return -i
    assert lagged(starts(), finish, 2) == [0, -1, -2, -3, -4]
    assert events == [("device", 0), ("device", 1), ("device", 2),
                      ("host", 0), ("device", 3), ("host", 1),
                      ("device", 4), ("host", 2), ("host", 3), ("host", 4)]


@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
def test_sync_free_value_compaction(share):
    """compact_vals_sorted (the encoders' gather at compact_idx_sorted's
    positions) equals compact_vals and the JAX compact_vals on seeded
    masks, with none, some and all candidates coded; pack_symbols and the
    host copy keep the first count entries."""
    from dcvc_tpu.runtime import symbols as jsymbols
    from dcvc_tpu_torch.runtime.host_copy import HostCopy
    rng = np.random.default_rng(int(10 * share) + 3)
    n = 777
    idx = torch.from_numpy(rng.integers(0, 200, n).astype(np.uint8))
    cond = torch.from_numpy(rng.uniform(size=n) < share)
    vals = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int16))
    packed_idx, packed_pos, count = symbols.compact_idx_sorted(idx, cond)
    got = symbols.compact_vals_sorted(vals, packed_pos)
    assert torch.equal(got, symbols.compact_vals(vals, cond))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsymbols.compact_vals(
            jnp.asarray(vals.numpy()), jnp.asarray(cond.numpy()))))
    packed = symbols.pack_symbols(got, packed_idx)
    coded = HostCopy(packed, count).finish()
    assert coded.shape == (int(cond.sum()),)
    np.testing.assert_array_equal(coded >> 8, vals[cond].numpy())
    np.testing.assert_array_equal(coded & 0xFF, idx[cond].numpy())
