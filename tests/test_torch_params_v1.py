"""The JAX package's native checkpoint format, dcvc_tpu.params.v1, in the
port: its msgpack codec (dcvc_tpu_torch/utils/msgpack.py) against
msgpack-python and flax, and checkpoints moving between the two packages
in both directions (utils/checkpoint.py, utils/jax_bridge.py), on the
CPU in float32.

- msgpack: every scalar, string, bin, map and array size class written
  byte for byte as msgpack-python writes it; a param tree (float32,
  bfloat16, int and uint8 leaves, numpy scalars, an empty array) as
  flax's msgpack_serialize writes it, and the chunked form at a small
  chunk size passed in (flax's MAX_CHUNK_SIZE patched to the same);
  either side reads the other's bytes; an unknown ext type, tag or
  dtype, truncated or trailing bytes raise.
- The bridge's inverse: the port's state_dict -> flax tree has the flax
  model's own paths, shapes and key order (jax.eval_shape of its init,
  both adaptor branches for HT / LD), at TINY and at the published
  configs; the forward bridge gives the state back exactly.
- For DMCI, HTS, HTL and LD at TINY: a file written by the JAX package's
  save_params loads into the port (load_native_into) with the exact
  weights, and the port's codec writes the JAX codec's streams byte for
  byte (a 64x96 frame; the video codecs one unit after the DMCI seed);
  a file written by the port's save_native loads in JAX's load_params
  with every leaf equal in shape, dtype and value, and the JAX codec on
  it writes the same streams; a JAX-written file read into a port model
  and written again is byte-identical.  The weights are the port's
  seeded init (the video kernels damped by 0.5 and the priors' scale
  biases lifted by 2, as in tests/test_torch_eval.py and
  tests/test_torch_dmc_htl.py, so that y is coded), in the flax layout
  through the inverse bridge.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dcvc_tpu.models import dmc_ht as jax_dmc_ht
from dcvc_tpu.models import dmc_ld as jax_dmc_ld
from dcvc_tpu.models import dmci as jax_dmci
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxDMCI
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxHT
from dcvc_tpu.runtime.video_codec import DMCLDCodec as JaxLD
from dcvc_tpu.utils import checkpoint as jax_ckpt
from dcvc_tpu_torch.models import dmc_ht, dmc_ld, dmci
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec, DMCLDCodec
from dcvc_tpu_torch.utils import jax_bridge as jb
from dcvc_tpu_torch.utils import msgpack as mp
from dcvc_tpu_torch.utils.checkpoint import PARAMS_V1, checkpoint_format, \
    config_from_header, load_params, save_reference
from test_torch_full_depth import _flax_shapes, _published, _stand_in

H, W, QP_I, QP_P = 64, 96, 3, 5


# ---------------------------------------------------------------- msgpack

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
        -2 ** 31 - 1, -2 ** 63]
SIZES = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]


def test_msgpack_matches_msgpack_python():
    values = INTS + [None, True, False, 0.5, -0.0, float("inf"), 1e300]
    for n in SIZES:
        values += ["é" * (n // 2) + "x" * (n % 2), b"\x01" * n,
                   list(range(min(n, 300))) + [None] * max(0, n - 300),
                   {str(i): i for i in range(n)}]
    values.append({"a": [1, {"b": b"x", "c": [True, 2.5]}], "": None})
    for v in values:
        want = msgpack.packb(v, use_bin_type=True, strict_types=True)
        assert mp.packb(v) == want, repr(v)[:60]
        assert mp.unpackb(want) == v, repr(v)[:60]


def _tree(rng):
    """A flax-style tree (keys sorted, as jax.tree.map leaves them): JAX
    side (bfloat16 as a jnp array) and port side (torch.bfloat16)."""
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    jax_tree = {
        "a": rng.standard_normal(7).astype(np.float32),
        "bf": jnp.asarray(bf, jnp.bfloat16),
        "big": rng.standard_normal(3000).astype(np.float32),
        "blk": {"empty": np.zeros((0, 3), np.float32),
                "kernel": rng.standard_normal((3, 3, 4, 5)).astype(
                    np.float32)},
        "i32": rng.integers(-9, 9, (2, 3), dtype=np.int32),
        "s": np.float32(3.5),
        "u8": rng.integers(0, 255, 300, dtype=np.uint8),
    }
    port_tree = dict(jax_tree, bf=torch.from_numpy(bf).to(torch.bfloat16))
    return jax_tree, port_tree


def _leaf_equal(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32)) \
        if isinstance(want, jax.Array) else np.asarray(want)
    if isinstance(got, torch.Tensor):
        got = got.float().numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
    assert np.asarray(got).shape == want.shape
    np.testing.assert_array_equal(np.asarray(got, want.dtype), want)


@pytest.mark.parametrize("chunk", [None, 1000])
def test_msgpack_tree_matches_flax(chunk, monkeypatch):
    jax_tree, port_tree = _tree(np.random.default_rng(0))
    if chunk is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    want = flax.serialization.msgpack_serialize(jax_tree)
    got = mp.packb(port_tree) if chunk is None else mp.packb(port_tree,
                                                             chunk)
    assert got == want
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in got
    back = mp.unpackb(want)
    assert list(back) == list(jax_tree) and list(back["blk"]) == \
        list(jax_tree["blk"])
    assert back["bf"].dtype == torch.bfloat16
    assert isinstance(back["s"], np.float32) and back["s"] == 3.5
    assert back["big"].shape == (3000,)
    for k in ("a", "bf", "big", "i32", "u8"):
        _leaf_equal(back[k], jax_tree[k])
    _leaf_equal(back["blk"]["kernel"], jax_tree["blk"]["kernel"])
    assert tuple(back["blk"]["empty"].shape) == (0, 3)
    restored = flax.serialization.msgpack_restore(got)
    for k in ("a", "bf", "big", "i32", "u8"):
        _leaf_equal(restored[k], jax_tree[k])


def test_msgpack_refuses_what_it_does_not_know():
    bad = [msgpack.packb(msgpack.ExtType(2, b"\x00")),   # complex
           msgpack.packb(msgpack.ExtType(7, b"abcd")),
           b"\xc1",                                         # never used
           msgpack.packb([1, 2, 3])[:-1],                   # truncated
           msgpack.packb(1) + b"\x00"]                      # trailing
    arr = msgpack.packb(((2,), "complex64", b"\x00" * 16), use_bin_type=True)
    bad.append(msgpack.packb(msgpack.ExtType(1, arr)))
    for data in bad:
        with pytest.raises(ValueError):
            mp.unpackb(data)
    for obj in ((1, 2), {1.5}, object()):
        with pytest.raises(TypeError):
            mp.packb(obj)


def test_checkpoint_format_tells_the_files_apart(tmp_path):
    model = dmci.DMCI(dmci.TINY_CONFIG)
    save_reference(str(tmp_path / "a.pth.tar"), model)
    jb.save_native(model, str(tmp_path / "a.bin"))
    assert checkpoint_format(str(tmp_path / "a.pth.tar")) == "pth.tar"
    assert checkpoint_format(str(tmp_path / "a.bin")) == PARAMS_V1
    (tmp_path / "short").write_bytes(b"\x05")
    assert checkpoint_format(str(tmp_path / "short")) == "pth.tar"


# ------------------------------------------------------- the inverse bridge

def _paths(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _paths(v, path + (k,))
        else:
            yield path + (k,), v


def _bridge(name):
    """(from_jax, to_jax) of a model name."""
    if name == "dmci":
        return jb.dmci_params_from_jax, jb.dmci_params_to_jax
    if name == "ld":
        return jb.dmc_ld_params_from_jax, jb.dmc_ld_params_to_jax
    hts = name == "hts"
    return (lambda t: jb.dmc_ht_params_from_jax(t, hts),
            lambda s: jb.dmc_ht_params_to_jax(s, hts))


TINY = {"dmci": jax_dmci.TINY_CONFIG, "hts": jax_dmc_ht.TINY_HT_CONFIG,
        "htl": jax_dmc_ht.TINY_HTL_CONFIG, "ld": jax_dmc_ld.TINY_LD_CONFIG}


@pytest.mark.parametrize("size", ["tiny", "published"])
@pytest.mark.parametrize("name", ["dmci", "hts", "htl", "ld"])
def test_inverse_bridge_gives_the_flax_tree(name, size):
    cfg = TINY[name] if size == "tiny" else _published(name)[0]
    # keys sorted, as jax.tree.map (and so save_params) leaves them
    flax_tree = jax.tree.map(lambda s: s, _flax_shapes(name, cfg))
    values = _stand_in(flax_tree)
    from_jax, to_jax = _bridge(name)
    state = from_jax(values)
    back = to_jax(state)
    want = [(p, tuple(v.shape)) for p, v in _paths(flax_tree)]
    got = [(p, tuple(v.shape)) for p, v in _paths(back)]
    assert got == want          # paths, shapes and key order
    assert {k: tuple(v.shape) for k, v in from_jax(back).items()} == \
        {k: tuple(v.shape) for k, v in state.items()}


# ------------------------------------------------------ the four codecs

def _port_model(name):
    """The port's seeded TINY model (video kernels damped by 0.5, the
    priors' scale biases lifted by 2) in float32."""
    if name == "dmci":
        model = dmci.DMCI(dmci.TINY_CONFIG)
        model.reset_parameters(torch.Generator().manual_seed(3))
        return model
    cls, cfg = {"hts": (DMCHTCodec, dmc_ht.TINY_HT_CONFIG),
                "htl": (DMCHTCodec, dmc_ht.TINY_HTL_CONFIG),
                "ld": (DMCLDCodec, dmc_ld.TINY_LD_CONFIG)}[name]
    state = cls.init_random(torch.Generator().manual_seed(4), cfg=cfg,
                            init_scale=0.5, dtype=torch.float32,
                            device="cpu").model.state_dict()
    state["y_prior_fusion.conv.3.bias"][cfg.ch_y:2 * cfg.ch_y] += 2.0
    if name == "htl":   # its spatial prior emits scales too
        state["y_spatial_prior.conv.3.bias"][:cfg.ch_y] += 2.0
    model = cls.MODEL(cfg)
    model.load_state_dict(state)
    return model


def _jax_codec(name, params):
    if name == "dmci":
        return JaxDMCI(params, cfg=TINY[name], dtype=jnp.float32)
    if name == "ld":
        return JaxLD(jax_dmc_ld.DMCLD(cfg=TINY[name], dtype=jnp.float32),
                     params)
    return JaxHT(jax_dmc_ht.DMCHT(cfg=TINY[name], dtype=jnp.float32),
                 params)


def _port_codec(name, model):
    cls = {"dmci": DMCICodec, "hts": DMCHTCodec, "htl": DMCHTCodec,
           "ld": DMCLDCodec}[name]
    return cls(model.state_dict(), cfg=model.cfg, dtype=torch.float32,
               device="cpu")


def _frame(seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (H, W, 3)), 3.0)
    return (base - 0.5)[None].astype(np.float32)


def _streams(name, codec, intra):
    """The stream of one DMCI frame, or of one video unit after the
    intra reconstruction `intra` seeds the DPB."""
    if name == "dmci":
        return [codec.compress(_frame(0), QP_I)["bit_stream"]]
    fd = codec.cfg.frame_delay
    x = np.concatenate([np.roll(_frame(1), i, axis=2) for i in range(fd)],
                       axis=-1)
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.compress(x, QP_P)["bit_stream"]]


@pytest.fixture(scope="module")
def intra():
    """A DMCI reconstruction that seeds every video codec's DPB."""
    codec = _port_codec("dmci", _port_model("dmci"))
    return codec.compress(_frame(2), QP_I)["x_hat"].numpy()


@pytest.fixture(scope="module", params=["dmci", "hts", "htl", "ld"])
def case(request, tmp_path_factory, intra):
    """name, the port model, its flax tree (numpy), the JAX-written file
    and the JAX codec's streams."""
    name = request.param
    model = _port_model(name)
    tree = jax.tree.map(lambda t: t.numpy(),
                        _bridge(name)[1](model.state_dict()))
    path = str(tmp_path_factory.mktemp(name) / "jax.bin")
    jax_ckpt.save_params(path, tree, TINY[name])
    streams = _streams(name, _jax_codec(name, tree), intra)
    assert all(len(s) > 40 for s in streams), "no y symbol coded"
    return name, model, tree, path, streams


def test_jax_file_loads_into_the_port(case, intra):
    name, model, _, path, streams = case
    tree, header = load_params(path)
    cls = type(model.cfg)
    assert config_from_header(cls, header, None) == model.cfg
    got = jb.load_native_into(type(model)(model.cfg), path)
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert _streams(name, _port_codec(name, got), intra) == streams


def test_port_file_loads_in_jax(case, tmp_path, intra):
    name, model, tree, _, streams = case
    path = str(tmp_path / "port.bin")
    jb.save_native(model, path)
    params, header = jax_ckpt.load_params(path)
    assert header == {"format": PARAMS_V1,
                      "config": dataclasses.asdict(TINY[name])}
    got, want = dict(_paths(params)), dict(_paths(tree))
    assert list(got) == list(want)
    for p, leaf in want.items():
        assert got[p].dtype == leaf.dtype and got[p].shape == leaf.shape, p
        np.testing.assert_array_equal(got[p], leaf, err_msg=str(p))
    assert _streams(name, _jax_codec(name, params), intra) == streams


def test_jax_file_rewritten_by_the_port_is_identical(case, tmp_path):
    name, model, _, path, _ = case
    loaded = jb.load_native_into(type(model)(model.cfg), path)
    out = str(tmp_path / "again.bin")
    jb.save_native(loaded, out, jb.native_config(path, type(model.cfg),
                                                 None))
    with open(path, "rb") as f, open(out, "rb") as g:
        assert g.read() == f.read()


def test_bfloat16_model_round_trips(tmp_path):
    """A bfloat16 model writes bfloat16 leaves, read as torch.bfloat16
    by the port and as bfloat16 by JAX, with the same values."""
    model = _port_model("dmci").to(torch.bfloat16)
    path = str(tmp_path / "bf16.bin")
    jb.save_native(model, path)
    params, _ = jax_ckpt.load_params(path)
    kernel = params["enc"]["enc_1"]["dc_in"]["conv"]["kernel"]
    assert kernel.dtype == jnp.bfloat16
    tree, _ = load_params(path)
    assert tree["enc"]["enc_1"]["dc_in"]["conv"]["kernel"].dtype == \
        torch.bfloat16
    back = jb.load_native_into(dmci.DMCI(dmci.TINY_CONFIG), path)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v.float()), k
