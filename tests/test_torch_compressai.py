"""Port parity, the CompressAI intra codecs (cheng2020-anchor,
bmshj2018-hyperprior) and GDN: dcvc_tpu_torch's legacy/gdn.py,
entropy/compressai.py, legacy/compressai_zoo.py and
runtime/compressai_codec.py against dcvc_tpu's, float32 on the CPU, at
TINY_HYPERPRIOR / TINY_CHENG2020.

- The copies of the JAX package's numpy / torch-CPU bank functions and of
  its key maps are pinned to the originals' source; the gaussian bank,
  eb_bank of seeded parameters and build_indexes are equal array for
  array.
- GDN in both directions, the transposed convs (a stride-2 5x5 and a
  stride-1 3x3, the weights carried by the bridge's flip), every stage
  method of ScaleHyperprior and Cheng2020Anchor, cheng2020's masked
  context conv and both forwards within atol = rtol = 2e-5.
- The codecs: both streams byte-identical to the JAX codecs' at 64x64 and
  at the odd 48x80, each decode equal to its encoder's x_hat.  The
  weights are the port's seeded init lifted so that y and z symbols are
  coded (perf_probe.lifted_compressai), carried to flax by
  compressai_params_to_jax; the JAX models are never initialised.
- Weights: the bridge's tree has the shapes of jax.eval_shape of the
  flax init; params.v1 files both ways (the port writes, the JAX codec
  codes the same bytes, and the reverse); a reference .pth.tar
  synthesised through key_fn_hyperprior / key_fn_cheng2020 and the
  EntropyBottleneck's reference names loads through from_reference.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dcvc_tpu.entropy import compressai as jent
from dcvc_tpu.legacy import compressai_zoo as jzoo
from dcvc_tpu.legacy import dcvc_net as jnet
from dcvc_tpu.legacy import gdn as jgdn
from dcvc_tpu.runtime import compressai_codec as jcodec
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.entropy import compressai as ent
from dcvc_tpu_torch.legacy import compressai_zoo as zoo
from dcvc_tpu_torch.legacy.dcvc_net import Deconv
from dcvc_tpu_torch.legacy.gdn import GDN
from dcvc_tpu_torch.perf_probe import compressai_stage_launches, \
    lifted_compressai
from dcvc_tpu_torch.runtime import compressai_codec as codec
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import compressai_params_from_jax, \
    compressai_params_to_jax, load_into, load_native_into, save_native

TOL = 2e-5
# name -> (port model, JAX model class, TINY config, JAX TINY config, key
# map, port codec, JAX codec)
MODELS = {
    "bmshj2018": (zoo.ScaleHyperprior, jzoo.ScaleHyperprior,
                  zoo.TINY_HYPERPRIOR, jzoo.TINY_HYPERPRIOR,
                  keys.key_fn_hyperprior, codec.HyperpriorCodec,
                  jcodec.HyperpriorCodec),
    "cheng2020": (zoo.Cheng2020Anchor, jzoo.Cheng2020Anchor,
                  zoo.TINY_CHENG2020, jzoo.TINY_CHENG2020,
                  keys.key_fn_cheng2020, codec.Cheng2020Codec,
                  jcodec.Cheng2020Codec)}

PUBLISHED = {"bmshj2018": zoo.BMSHJ2018_Q1_5, "cheng2020": zoo.CHENG2020_Q1_3}


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.uniform(0, 1, (1, h, w, 3)), (0, 3, 3, 0))
    return np.clip((x - 0.5) * 3 + 0.5, 0, 1).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def jax_tree(state, key_fn):
    """A port state_dict as the JAX codec's {params, eb_params} (numpy)."""
    return jax.tree.map(lambda t: np.asarray(t.numpy()),
                        compressai_params_to_jax(state, key_fn))


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(name, the port's lifted model, its JAX {params, eb_params})."""
    name = request.param
    m = lifted_compressai(name, MODELS[name][2], 0)
    return name, m, jax_tree(m.state_dict(), MODELS[name][4])


# ------------------------------------------------------------ the copies

@pytest.mark.parametrize("name", [
    "compressai_scale_table", "compressai_gaussian_bank", "build_indexes",
    "eb_init_params", "_eb_logits_torch", "eb_bank"])
def test_entropy_copies_pinned(name):
    assert inspect.getsource(getattr(ent, name)) == \
        inspect.getsource(getattr(jent, name))


@pytest.mark.parametrize("name", [
    "key_fn_hyperprior", "key_fn_cheng2020", "import_entropy_bottleneck",
    "_seq_key", "_compressai_sub", "_CHENG_SUBPEL_SLOTS"])
def test_key_map_copies_pinned(name):
    got, want = getattr(keys, name), getattr(jkeys, name)
    if callable(want):
        assert inspect.getsource(got) == inspect.getsource(want)
    else:
        assert got == want


def test_gaussian_bank_and_indexes_equal():
    table = ent.compressai_scale_table()
    np.testing.assert_array_equal(table, jent.compressai_scale_table())
    for g, w in zip(ent.compressai_gaussian_bank(table),
                    jent.compressai_gaussian_bank(table)):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(1)
    scales = np.concatenate([np.exp(rng.uniform(-4, 6, 5000)), table,
                             np.nextafter(table, 0), [0.0, -1.0, 1e4]])
    got = ent.build_indexes(scales.astype(np.float32), table)
    np.testing.assert_array_equal(
        got, jent.build_indexes(scales.astype(np.float32), table))
    assert got.min() == 0 and got.max() == 63


@pytest.mark.parametrize("channels", [8, 16])
def test_eb_bank_equal(channels):
    rng = np.random.default_rng(channels)
    p = ent.eb_init_params(channels, rng=np.random.default_rng(3))
    p = {k: (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
         if k != "quantiles" else v for k, v in p.items()}
    got, want = ent.eb_bank(p), jent.eb_bank(p)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_flax(inverse):
    rng = np.random.default_rng(int(inverse))
    ch = 12
    g = GDN(ch, inverse=inverse)
    with torch.no_grad():     # away from the init, some below the bounds
        g.beta.copy_(torch.from_numpy(rng.uniform(-0.1, 1.5, ch)
                                      .astype(np.float32)))
        g.gamma.copy_(torch.from_numpy(rng.uniform(-0.05, 0.5, (ch, ch))
                                       .astype(np.float32)))
    x = rng.normal(0, 2, (2, 5, 7, ch)).astype(np.float32)
    want = jgdn.GDN(ch, inverse=inverse).apply(
        {"params": {"beta": g.beta.detach().numpy(),
                    "gamma": g.gamma.detach().numpy()}}, x)
    _close(g(torch.from_numpy(x)), want)
    fresh = jgdn.GDN(ch).init(jax.random.PRNGKey(0), x)["params"]
    _close(GDN(ch).beta, fresh["beta"])
    _close(GDN(ch).gamma, fresh["gamma"])


@pytest.mark.parametrize("k,s", [(5, 2), (3, 1)])
def test_deconv_matches_flax(k, s):
    """flax ConvTranspose (padding (k//2, k//2 + s - 1), no kernel
    transpose) against the port's Deconv on the bridge's flipped weight."""
    rng = np.random.default_rng(k)
    cin, cout = 6, 5
    kernel = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.3, cout).astype(np.float32)
    x = rng.normal(0, 1, (1, 6, 9, cin)).astype(np.float32)
    want = jnet._deconv(cout, k, s).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    tree = {"params": {"g_s_layers_0": {"kernel": kernel, "bias": bias}},
            "eb_params": {}}
    state = compressai_params_from_jax(tree, keys.key_fn_hyperprior)
    d = Deconv(cin, cout, k, s)
    d.load_state_dict({"weight": state["g_s_layers_0.weight"],
                       "bias": state["g_s_layers_0.bias"]})
    got = d(torch.from_numpy(x))
    assert got.shape == (1, 6 * s, 9 * s, cout)
    _close(got, want)
    back = compressai_params_to_jax(state, keys.key_fn_hyperprior)
    np.testing.assert_array_equal(
        back["params"]["g_s_layers_0"]["kernel"].numpy(), kernel)


# ------------------------------------------------------------ the models

def _apply(name, tree, method, *args):
    jm = MODELS[name][1](cfg=MODELS[name][3])
    fn = getattr(MODELS[name][1], method) if method else None
    return jm.apply({"params": tree["params"]}, *args, method=fn)


def test_stages_match_jax(model):
    name, m, tree = model
    x = image(64, 128, 1)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y = m.g_a(xt)
        _close(y, _apply(name, tree, "g_a", x))
        z = m.h_a(y)
        _close(z, _apply(name, tree, "h_a", y.numpy()))
        z_hat = torch.round(z)
        _close(m.h_s(z_hat), _apply(name, tree, "h_s", z_hat.numpy()))
        y_hat = torch.round(y)
        _close(m.g_s(y_hat), _apply(name, tree, "g_s", y_hat.numpy()))
        if name == "cheng2020":
            ctx = m._masked_conv(y_hat)
            _close(ctx, _apply(name, tree, "_masked_conv", y_hat.numpy()))
            v = torch.cat([m.h_s(z_hat), ctx], dim=-1)
            _close(m.entropy_parameters(v),
                   _apply(name, tree, "entropy_parameters", v.numpy()))
        got = m(xt)
    want = _apply(name, tree, None, x)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])


def test_masked_conv_sees_only_decoded_neighbours():
    """A change at one position moves the context only at later raster
    positions (the type-A mask)."""
    m = lifted_compressai("cheng2020", zoo.TINY_CHENG2020, 1)
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.normal(0, 2, (1, 6, 7, 16)).astype(np.float32))
    y2 = y.clone()
    y2[0, 3, 4] += 5.0
    with torch.no_grad():
        d = (m._masked_conv(y2) - m._masked_conv(y)).abs().amax(-1)[0]
    changed = {tuple(p) for p in torch.nonzero(d > 0).tolist()}
    assert changed and all((r, c) > (3, 4) for r, c in changed)


def test_stage_launches_are_zero():
    for cls, cfg in ((zoo.ScaleHyperprior, zoo.BMSHJ2018_Q1_5),
                     (zoo.Cheng2020Anchor, zoo.CHENG2020_Q1_3)):
        launches = compressai_stage_launches(cls, cfg, 1080, 1920)
        assert set(launches) == {"g_a", "h_a", "h_s", "g_s", "forward"}
        assert all(sum(c.values()) == 0 for c in launches.values())


# ------------------------------------------------------------ the codecs

def jax_codec(name, tree):
    """dcvc_tpu's codec on the port's weights (no flax init)."""
    _, jcls, _, jcfg, _, _, jcodec_cls = MODELS[name]
    return jcodec_cls(jcls(cfg=jcfg), tree["params"], tree["eb_params"])


def port_codec(name, m):
    return MODELS[name][5](m.state_dict(), cfg=MODELS[name][2],
                           device="cpu")


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_streams_match_jax(model, h, w):
    name, m, tree = model
    pc, jc = port_codec(name, m), jax_codec(name, tree)
    x = image(h, w, h + w)
    got, want = pc.compress(x), jc.compress(x)
    assert got["z_string"] == want["z_string"]
    assert got["y_string"] == want["y_string"]
    assert len(got["y_string"]) > 60 and len(got["z_string"]) > 8
    assert got["x_hat"].shape == (1, h, w, 3)
    _close(got["x_hat"], want["x_hat"])
    out = pc.decompress(got["y_string"], got["z_string"], h, w)
    assert torch.equal(out["x_hat"], got["x_hat"])


def test_host_ar_matches_jax():
    """Cheng2020Codec's HostAR (the port's copy, its adapter from the
    port's weights) gives the JAX codec's arrays exactly on the same
    numpy inputs."""
    m = lifted_compressai("cheng2020", zoo.TINY_CHENG2020, 2)
    tree = jax_tree(m.state_dict(), keys.key_fn_cheng2020)
    pc, jc = port_codec("cheng2020", m), jax_codec("cheng2020", tree)
    rng = np.random.default_rng(5)
    y = rng.normal(0, 3, (4, 6, 16)).astype(np.float32)
    prior = rng.normal(0, 1, (4, 6, 32)).astype(np.float32)
    for g, w in zip(pc.ar.encode(y, prior), jc.ar.encode(y, prior)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the weights

@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("full", [False, True])
def test_bridge_tree_matches_flax_init(name, full):
    cls, jcls, tiny, jtiny = MODELS[name][:4]
    cfg = PUBLISHED[name] if full else tiny
    jcfg = type(jtiny)(**vars(cfg))
    m = cls(cfg)
    tree = compressai_params_to_jax(m.state_dict(), MODELS[name][4])
    shapes = jax.eval_shape(lambda: jcls(cfg=jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert jax.tree.map(lambda t: tuple(t.shape), tree["params"]) == want
    eb = jent.eb_init_params(cfg.N)
    assert {k: tuple(v.shape) for k, v in tree["eb_params"].items()} == \
        {k: v.shape for k, v in eb.items()}
    back = compressai_params_from_jax(tree, MODELS[name][4])
    assert back.keys() == m.state_dict().keys()
    for k, t in m.state_dict().items():
        assert torch.equal(back[k], t), k


def test_params_v1_both_ways(model, tmp_path):
    """The port's file codes the JAX codec's bytes, and a JAX-written
    file codes the port's."""
    name, m, tree = model
    cls, jcfg = MODELS[name][0], MODELS[name][3]
    x = image(64, 64, 9)
    want = jax_codec(name, tree).compress(x)
    save_native(m, str(tmp_path / "port.bin"))
    jtree, hdr = load_params(str(tmp_path / "port.bin"))
    assert hdr["config"] == vars(MODELS[name][2])
    jtree = jax.tree.map(np.asarray, jtree)
    got = jax_codec(name, jtree).compress(x)
    assert (got["y_string"], got["z_string"]) == \
        (want["y_string"], want["z_string"])
    save_params(str(tmp_path / "jax.bin"), tree, jcfg)
    loaded = load_native_into(cls(MODELS[name][2]), str(tmp_path /
                                                         "jax.bin"))
    got = port_codec(name, loaded).compress(x)
    assert (got["y_string"], got["z_string"]) == \
        (want["y_string"], want["z_string"])


def reference_state(name, m):
    """The reference CompressAI state_dict of the port model m: every
    parameter under key_fn's name (conv / ConvTranspose2d weights as
    they are, cheng2020's context kernel as a conv weight), the
    EntropyBottleneck's tensors under their reference names, and the
    coder tables and reparametrizers a reference file also holds."""
    key_fn = MODELS[name][4]
    state = {}
    for k, t in m.state_dict().items():
        segs = k.split(".")
        if segs[0] == "entropy_bottleneck":
            leaf = segs[1]
            if leaf == "quantiles":
                state["entropy_bottleneck.quantiles"] = t.clone()
            else:
                kind, i = leaf.rsplit("_", 1)
                plural = {"matrix": "_matrices", "bias": "_biases",
                          "factor": "_factors"}[kind]
                state[f"entropy_bottleneck.{plural}.{i}"] = t.clone()
            continue
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        ref = key_fn(path)
        ref = ref[1] if isinstance(ref, tuple) else ref
        if k == "context_prediction_kernel":
            t = t.permute(3, 2, 0, 1)
        state[ref] = t.clone()
    state["entropy_bottleneck._quantized_cdf"] = torch.zeros(4, 8)
    state["entropy_bottleneck._offset"] = torch.zeros(4)
    state["gaussian_conditional.scale_table"] = torch.ones(64)
    state["g_a.1.beta_reparam.pedestal"] = torch.ones(())
    if name == "cheng2020":
        state["context_prediction.mask"] = torch.ones(32, 16, 5, 5)
    return state


def test_reference_checkpoint_loads(model, tmp_path):
    name, m, tree = model
    path = str(tmp_path / f"{name}.pth.tar")
    torch.save({"state_dict": reference_state(name, m)}, path)
    loaded = load_into(MODELS[name][0](MODELS[name][2]), path)
    for k, t in m.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    # the JAX importer reads the same file into the same tree
    want = jkeys.import_entropy_bottleneck(
        {k: v.numpy() for k, v in reference_state(name, m).items()})
    for k, v in want.items():
        np.testing.assert_array_equal(v, tree["eb_params"][k])
    state = reference_state(name, m)
    state["g_a.0.extra.weight"] = torch.zeros(1)
    torch.save({"state_dict": state}, path)
    with pytest.raises(KeyError, match="unused"):
        load_into(MODELS[name][0](MODELS[name][2]), path)


def test_init_random_is_seeded_and_undamped():
    a = codec.Cheng2020Codec.init_random(torch.Generator().manual_seed(4),
                                         cfg=zoo.TINY_CHENG2020,
                                         device="cpu")
    b = codec.Cheng2020Codec.init_random(torch.Generator().manual_seed(4),
                                         cfg=zoo.TINY_CHENG2020,
                                         device="cpu")
    for k, t in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], t)
    w = a.model.g_a_layers_0.conv1.weight
    assert 0.5 < float(w.std() * np.sqrt(27)) < 1.1    # lecun: 1 / fan_in
    for k, v in jent.eb_init_params(16).items():
        np.testing.assert_array_equal(a.eb_params[k], v)
