"""Port parity, K2 (the device rANS decode): dcvc_tpu_torch's plain version
`rans_decode_reference` (what the wrapper runs on the CPU) against the
host coder's RansDecoder and dcvc_tpu's two device decoders, the Pallas
kernel in interpret mode (`make_decode_fn_pallas`) and the XLA loop
(`make_decode_fn`), on the same host-encoded streams, exactly.

The fixtures are those of tests/test_device_decode.py and
tests/test_pallas_decode.py: 1/2/3/5/8 lanes with bypass escapes, a count
below the lane count and a count of 0, and one state threaded through a z
call and two y calls with zeros past each count.  Also: the copied
split_streams and init_state against the originals, and the sync-free
sort compaction of the device decode against the mask compaction.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.rans import device_decode as jdd
from dcvc_tpu.rans.pallas_decode import make_decode_fn_pallas
from dcvc_tpu.runtime import symbols as jsymbols
from dcvc_tpu_torch.entropy.cdf import pmf_to_quantized_cdf
from dcvc_tpu_torch.kernels.rans_decode import make_bank, rans_decode, \
    rans_decode_reference
from dcvc_tpu_torch.rans import RansDecoder, RansEncoder
from dcvc_tpu_torch.rans.device_decode import init_state, split_streams
from dcvc_tpu_torch.runtime import symbols


def _random_bank(rng, n_cdf, alphabet):
    """Quantized CDF rows like the codec banks (last entry 65536)."""
    per = alphabet + 2
    cdf = np.zeros((n_cdf, per), np.int32)
    lengths = np.full((n_cdf,), per, np.int32)
    for i in range(n_cdf):
        pmf = rng.dirichlet(np.full(alphabet + 1, 0.6))
        cdf[i, :alphabet + 2] = pmf_to_quantized_cdf(pmf)
    return cdf, lengths


def _encode_y(cdf, lengths, symbols_, idx, n_lanes):
    enc = RansEncoder()
    enc.set_cdf(cdf, lengths, 1)
    enc.set_parallel(n_lanes)
    enc.reset()
    enc.encode_y(((symbols_.astype(np.int16) << 8)
                  | idx.astype(np.int16)).astype(np.int16))
    enc.flush()
    return enc.get_encoded_stream()


def _host_decode_y(cdf, lengths, stream, n_lanes, idx):
    dec = RansDecoder()
    dec.set_cdf(cdf, lengths, 1)
    dec.set_parallel(n_lanes)
    dec.set_stream(stream)
    dec.decode_y(idx)
    return dec.get_decoded(idx.size)


def _torch_state(lanes):
    return init_state(torch.from_numpy(lanes))


def _padded(idx, cap):
    out = np.zeros(cap, np.uint8)
    out[:idx.size] = idx
    return out


def _plain(state, idx_pad, count, cdf, lengths):
    return rans_decode(state, torch.from_numpy(idx_pad),
                       torch.tensor(count, dtype=torch.int32),
                       make_bank(cdf, lengths, "cpu"))


def _jax_both(cdf, lengths, lanes, idx_pad, count, n_lanes):
    """The JAX package's Pallas (interpret) and XLA decoders."""
    cap = idx_pad.size
    outs = []
    for fn in (make_decode_fn_pallas(cdf, lengths, n_lanes, cap, chunk=128,
                                     interpret=True),
               jdd.make_decode_fn(cdf, lengths, n_lanes, cap)):
        state, out = jax.jit(fn)(jdd.init_state(lanes), idx_pad, count)
        outs.append((np.asarray(state["st"]).view(np.int32),
                     np.asarray(state["ptr"]), np.asarray(out)))
    return outs


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 8])
def test_decode_y_matches_host_and_jax(n_lanes):
    rng = np.random.default_rng(100 + n_lanes)
    cdf, lengths = _random_bank(rng, 7, 12)
    n = 1000 + n_lanes
    idx = rng.integers(0, 7, n).astype(np.uint8)
    sym = rng.integers(-5, 6, n).astype(np.int8)
    esc = rng.random(n) < 0.02            # escapes into the bypass coder
    sym[esc] = rng.integers(30, 120, esc.sum())
    stream = _encode_y(cdf, lengths, sym, idx, n_lanes)
    want = _host_decode_y(cdf, lengths, stream, n_lanes, idx)
    np.testing.assert_array_equal(want, sym)

    lanes, _ = split_streams(stream, n_lanes)
    cap = n + 16
    idx_pad = _padded(idx, cap)
    state, got = _plain(_torch_state(lanes), idx_pad, n, cdf, lengths)
    np.testing.assert_array_equal(got.numpy()[:n], want)
    assert not got.numpy()[n:].any()
    for st, ptr, out in _jax_both(cdf, lengths, lanes, idx_pad, n, n_lanes):
        np.testing.assert_array_equal(got.numpy(), out)
        np.testing.assert_array_equal(state["st"].numpy(), st)
        np.testing.assert_array_equal(state["ptr"].numpy(), ptr)


@pytest.mark.parametrize("n", [5, 0])
def test_decode_count_below_lanes(n):
    """count < n_lanes: every symbol in the last lane (size0 = 0); a count
    of 0 decodes nothing and leaves the state as it was."""
    rng = np.random.default_rng(5)
    cdf, lengths = _random_bank(rng, 3, 6)
    idx = rng.integers(0, 3, n).astype(np.uint8)
    sym = rng.integers(-2, 3, n).astype(np.int8)
    stream = _encode_y(cdf, lengths, sym, idx, 8)
    lanes, _ = split_streams(stream, 8)
    cap = 256
    idx_pad = _padded(idx, cap)
    state0 = _torch_state(lanes)
    state, got = _plain(state0, idx_pad, n, cdf, lengths)
    np.testing.assert_array_equal(got.numpy()[:n], sym)
    assert not got.numpy()[n:].any()
    if n:
        np.testing.assert_array_equal(
            got.numpy()[:n], _host_decode_y(cdf, lengths, stream, 8, idx))
    else:
        assert torch.equal(state["st"], state0["st"])
        assert torch.equal(state["ptr"], state0["ptr"])
    for st, ptr, out in _jax_both(cdf, lengths, lanes, idx_pad, n, 8):
        np.testing.assert_array_equal(got.numpy(), out)
        np.testing.assert_array_equal(state["st"].numpy(), st)
        np.testing.assert_array_equal(state["ptr"].numpy(), ptr)


def test_decode_threads_state_z_then_y():
    """One state through a z call (rows (i % ch) + qp * ch of the z bank)
    and two y calls, with counts below cap and zeros past them: the ladder
    pattern of the device decode."""
    rng = np.random.default_rng(17)
    n_lanes, ch, qp = 8, 4, 2
    z_cdf, z_len = _random_bank(rng, 12, 16)
    y_cdf, y_len = _random_bank(rng, 9, 10)
    nz = 256
    z = rng.integers(-7, 8, nz).astype(np.int8)
    ny1, ny2 = 700, 500
    i1 = rng.integers(0, 9, ny1).astype(np.uint8)
    i2 = rng.integers(0, 9, ny2).astype(np.uint8)
    s1 = rng.integers(-4, 5, ny1).astype(np.int8)
    s2 = rng.integers(-4, 5, ny2).astype(np.int8)

    enc = RansEncoder()
    enc.set_cdf(z_cdf, z_len, 0)
    enc.set_cdf(y_cdf, y_len, 1)
    enc.set_parallel(n_lanes)
    enc.reset()
    enc.encode_y(((s2.astype(np.int16) << 8) | i2).astype(np.int16))
    enc.encode_y(((s1.astype(np.int16) << 8) | i1).astype(np.int16))
    enc.encode_z(z, qp * ch, ch)
    enc.flush()
    stream = enc.get_encoded_stream()

    dec = RansDecoder()
    dec.set_cdf(z_cdf, z_len, 0)
    dec.set_cdf(y_cdf, y_len, 1)
    dec.set_parallel(n_lanes)
    dec.set_stream(stream)
    dec.decode_z(nz, qp * ch, ch)
    wz = dec.get_decoded(nz)
    dec.decode_y(i1)
    w1 = dec.get_decoded(ny1)
    dec.decode_y(i2)
    w2 = dec.get_decoded(ny2)

    lanes, _ = split_streams(stream, n_lanes)
    zbank = make_bank(z_cdf, z_len, "cpu")
    ybank = make_bank(y_cdf, y_len, "cpu")
    cap = 1024
    zidx = torch.from_numpy((np.arange(nz) % ch).astype(np.uint8))
    zrows = slice(qp * ch, qp * ch + ch)
    state, gz = rans_decode(_torch_state(lanes), zidx, nz,
                            {k: v[zrows] for k, v in zbank.items()})
    state, g1 = rans_decode(state, torch.from_numpy(_padded(i1, cap)),
                            torch.tensor(ny1, dtype=torch.int32), ybank)
    state, g2 = rans_decode(state, torch.from_numpy(_padded(i2, cap)),
                            torch.tensor(ny2, dtype=torch.int32), ybank)
    np.testing.assert_array_equal(gz.numpy(), wz)
    np.testing.assert_array_equal(g1.numpy()[:ny1], w1)
    np.testing.assert_array_equal(g2.numpy()[:ny2], w2)
    assert not g1.numpy()[ny1:].any() and not g2.numpy()[ny2:].any()

    # the JAX decoders through the same three calls
    for make in (lambda c, l, k: make_decode_fn_pallas(
            c, l, n_lanes, k, chunk=128, interpret=True),
                 lambda c, l, k: jdd.make_decode_fn(c, l, n_lanes, k)):
        jstate = jdd.init_state(lanes)
        jstate, jz = jax.jit(make(z_cdf, z_len, nz))(
            jstate, np.arange(nz) % ch + qp * ch, nz)
        dy = jax.jit(make(y_cdf, y_len, cap))
        jstate, j1 = dy(jstate, _padded(i1, cap), ny1)
        jstate, j2 = dy(jstate, _padded(i2, cap), ny2)
        np.testing.assert_array_equal(gz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(j2))
        np.testing.assert_array_equal(
            state["st"].numpy(), np.asarray(jstate["st"]).view(np.int32))
        np.testing.assert_array_equal(state["ptr"].numpy(),
                                      np.asarray(jstate["ptr"]))


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 8])
def test_split_streams_and_init_state_match_jax(n_lanes):
    stream = np.random.default_rng(n_lanes).integers(
        0, 256, 301).astype(np.uint8).tobytes()
    if n_lanes > 2:   # a valid pair-offset header
        n_off = n_lanes // 2 - 1 + n_lanes % 2
        offs = np.linspace(0, 301 - 4 * n_off, n_off + 2)[1:-1].astype(
            np.int32)
        stream = offs.tobytes() + stream[4 * n_off:]
    lanes, lengths = split_streams(stream, n_lanes)
    want_lanes, want_lengths = jdd.split_streams(stream, n_lanes)
    np.testing.assert_array_equal(lanes, want_lanes)
    np.testing.assert_array_equal(lengths, want_lengths)
    state = init_state(torch.from_numpy(lanes))
    want = jdd.init_state(lanes)
    np.testing.assert_array_equal(state["st"].numpy(),
                                  np.asarray(want["st"]).view(np.int32))
    np.testing.assert_array_equal(state["ptr"].numpy(),
                                  np.asarray(want["ptr"]))


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version: same results."""
    rng = np.random.default_rng(2)
    cdf, lengths = _random_bank(rng, 4, 8)
    idx = rng.integers(0, 4, 300).astype(np.uint8)
    sym = rng.integers(-3, 4, 300).astype(np.int8)
    lanes, _ = split_streams(_encode_y(cdf, lengths, sym, idx, 3), 3)
    args = (torch.from_numpy(idx), 300, make_bank(cdf, lengths, "cpu"))
    s1, o1 = rans_decode(_torch_state(lanes), *args)
    s2, o2 = rans_decode_reference(_torch_state(lanes), *args)
    assert torch.equal(o1, o2) and torch.equal(s1["st"], s2["st"])
    np.testing.assert_array_equal(o1.numpy(), sym)


@pytest.mark.parametrize("case", ["mixed", "all", "none"])
def test_sorted_compaction_matches_mask_compaction(case):
    """compact_idx_sorted (device decode, no sync) == compact_idx (host
    paths) == the JAX package's sort compaction."""
    rng = np.random.default_rng(11)
    n = 997
    idx = rng.integers(0, 128, n).astype(np.uint8)
    cond = {"mixed": rng.random(n) < 0.4, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}[case]
    got = symbols.compact_idx_sorted(torch.from_numpy(idx),
                                     torch.from_numpy(cond))
    want = symbols.compact_idx(torch.from_numpy(idx), torch.from_numpy(cond))
    jwant = jsymbols.compact_idx(jnp.asarray(idx), jnp.asarray(cond))
    for g, w, j in zip(got, want, jwant):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # expansion puts the decoded symbols back at their positions
    dec = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int8))
    dec[int(got[2]):] = 0
    dense = symbols.expand_from_pos(got[1], dec, n)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jsymbols.expand_from_pos(
            jnp.asarray(got[1].numpy()), jnp.asarray(dec.numpy()), n)))
