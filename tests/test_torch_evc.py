"""Port parity, the EVC image codec: dcvc_tpu_torch's EVC and EVCCodec
against dcvc_tpu's at TINY_EVC_CONFIG and TINY_SCALABLE_EVC_CONFIG,
float32 on the CPU, on the same weights (through the bridge: key_fn_evc's
names) and inputs.

- The bridge gives the port's keys at TINY and at the published configs
  (shapes from jax.eval_shape, the port on the meta device), the inverse
  bridge gives the flax tree back exactly, a reference-format .pth.tar
  loads into both packages alike, and params.v1 files move both ways.
- Stages (analysis, prior, spatial, synthesis) and the training forward
  within atol = rtol = 2e-5; z exact.
- The codec: streams byte-identical to the JAX EVCCodec's at 64x64 and
  64x96 (a padded grid that is not square) for q_scale 0.8 and 1.4; the
  port's round trip bit-exact; the port decodes the JAX stream to the
  JAX x_hat within 2e-5.
- The weights: the JAX codec's seeded init at init_scale 0.7, q_basic
  times 0.02 (y 50 times larger; synthesis multiplies it back) and the
  scale parts of the prior outputs' last biases lifted by 2, so that z
  and y symbols spread over many CDF rows (as the codec inits them,
  every symbol is 0 and the stream is ~90 bytes).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import evc as jevc
from dcvc_tpu.runtime import fm_codec as jfm_codec
from dcvc_tpu.runtime.evc_codec import EVCCodec as JaxCodec
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu_torch.legacy import evc
from dcvc_tpu_torch.runtime import fm_codec
from dcvc_tpu_torch.runtime.evc_codec import EVCCodec
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import evc_params_from_jax, \
    evc_params_to_jax

TOL = 2e-5
CONFIGS = {"base": (evc.TINY_EVC_CONFIG, jevc.TINY_EVC_CONFIG),
           "scalable": (evc.TINY_SCALABLE_EVC_CONFIG,
                        jevc.TINY_SCALABLE_EVC_CONFIG)}


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _img(h, w, seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 2.0)
    return np.clip((x - 0.5) * 3 + 0.5, 0, 1)[None].astype(np.float32)


def lifted_params(params, n, fusion_bias, spatial_bias):
    """The codec tests' weights (module docstring): numpy copies of
    `params` with q_basic times 0.02 and the scale channels of the prior
    outputs' last biases lifted by 2."""
    p = jax.tree.map(np.array, params)
    p["q_basic"] *= 0.02
    fusion_bias(p)[n:2 * n] += 2.0
    sp = spatial_bias(p)
    sp[:n // 2] += 2.0
    sp[n:n + n // 2] += 2.0
    return p


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def codecs(request):
    tcfg, jcfg = CONFIGS[request.param]
    init = JaxCodec.init_random(jax.random.PRNGKey(3), cfg=jcfg,
                                init_scale=0.7)
    p = lifted_params(
        init.params, jcfg.n,
        lambda q: q["y_prior_fusion"]["layers_1"]["ffn"]["conv2"]["conv"]
        ["bias"],
        lambda q: q["y_spatial_prior"]["layers_2"]["ffn"]["conv2"]["conv"]
        ["bias"])
    jcodec = JaxCodec(init.model, jax.tree.map(jnp.asarray, p))
    tcodec = EVCCodec(evc_params_from_jax(p), cfg=tcfg, device="cpu")
    return jcodec, tcodec


def _j(jcodec, method, *args):
    return jcodec.model.apply({"params": jcodec.params}, *args,
                              method=getattr(jevc.EVC, method))


def test_configs_match_jax():
    names = [n for n in dir(jevc) if n.endswith("_CONFIG")]
    assert len(names) == 12
    for name in names:
        got, want = getattr(evc, name), getattr(jevc, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.dec_plan == want.dec_plan


@pytest.mark.parametrize("name", ["key_fn_evc", "_evc_dcb_sub"])
def test_key_fn_evc_copy_pinned(name):
    assert inspect.getsource(getattr(keys, name)) == \
        inspect.getsource(getattr(jkeys, name))


@pytest.mark.parametrize("name", ["cand_to_chw", "chw_to_cand"])
def test_fm_codec_copies_pinned(name):
    assert inspect.getsource(getattr(fm_codec, name)) == \
        inspect.getsource(getattr(jfm_codec, name))


def test_keys_and_inverse_bridge(codecs):
    jcodec, tcodec = codecs
    state = evc_params_from_jax(jcodec.params)
    want = {k: tuple(t.shape) for k, t in tcodec.model.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in state.items()} == want
    # the modules are named after the reference's keys
    assert {jkeys.key_fn_evc(tuple(k.key for k in path))
            for path, _ in jax.tree_util.tree_leaves_with_path(
                jcodec.params)
            if not isinstance(jkeys.key_fn_evc(
                tuple(k.key for k in path)), tuple)} <= set(want)
    back = evc_params_to_jax(tcodec.model.state_dict())
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(jcodec.params)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


@pytest.mark.parametrize("name", ["EVC_CONFIG", "SCALABLE_EVC_CONFIG",
                                  "EVC_MS_CONFIG"])
def test_published_keys_and_shapes_match_bridge(name):
    model = jevc.EVC(cfg=getattr(jevc, name))
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": r}, jnp.zeros((1, 64, 64, 3))),
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    state = evc_params_from_jax(params)
    with torch.device("meta"):
        port = evc.EVC(getattr(evc, name))
    want = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in state.items()} == want
    back = evc_params_to_jax({k: torch.zeros(s) for k, s in want.items()})
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)


def _reference_state(model):
    """The port model's weights under the reference's names: the z
    prior's banks split into its Bitparm tensors (Q, C, 1, 1), q_basic in
    the reference's (1, N, 1, 1)."""
    state = {k: t.detach().clone() for k, t in model.state_dict().items()}
    for name in ("h", "b", "a"):
        bank = state.pop(f"bit_estimator_z.{name}")
        for i in range(bank.shape[-1]):
            state[f"bit_estimator_z.f{i + 1}.{name}"] = \
                bank[..., i].reshape(bank.shape[0], -1, 1, 1).clone()
    state["q_basic"] = state["q_basic"].reshape(1, -1, 1, 1)
    return state


def test_reference_checkpoint_loads_like_the_importer(codecs, tmp_path):
    """A reference-format .pth.tar: dcvc_tpu's importer (key_fn_evc) gives
    the flax params back exactly, the port's load_reference_into the
    port's weights."""
    from dcvc_tpu_torch.utils.checkpoint import load_reference_into
    jcodec, tcodec = codecs
    ref = _reference_state(tcodec.model)
    params, unused = jkeys.import_state_dict(
        {k: t.numpy() for k, t in ref.items()}, jcodec.params,
        key_fn=jkeys.key_fn_evc)
    assert unused == []
    want = dict(jax.tree_util.tree_leaves_with_path(jcodec.params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want[path]))
    path = tmp_path / "evc.pth.tar"
    torch.save({"state_dict": ref}, path)
    got = load_reference_into(evc.EVC(tcodec.cfg), str(path))
    for k, t in tcodec.model.state_dict().items():
        assert torch.equal(got.state_dict()[k], t), k
    del ref["bit_estimator_z.f4.h"]
    torch.save({"state_dict": ref}, path)
    with pytest.raises(KeyError):
        load_reference_into(evc.EVC(tcodec.cfg), str(path))


@pytest.mark.parametrize("h,w,qs", [(64, 64, 0.8), (64, 128, 1.4)])
def test_stages_match_flax(codecs, h, w, qs):
    jcodec, tcodec = codecs
    m = tcodec.model
    x = _img(h, w, 5)
    q = jnp.float32(qs)
    y_j, z_j = _j(jcodec, "analysis", jnp.asarray(x), q)
    tq = torch.tensor(qs, dtype=torch.float32)
    with torch.inference_mode():
        y_t, z_t = m.analysis(torch.from_numpy(x), tq)
        _close(y_t, y_j)
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
        assert int(np.abs(np.asarray(z_j)).max()) > 0
        z = torch.from_numpy(np.array(z_j))
        prior_j = _j(jcodec, "prior", z_j)
        prior_t = m.prior(z)
        for g, want in zip(prior_t, prior_j):
            _close(g, want)
        y_hat0 = np.round(np.asarray(y_j)).astype(np.float32)
        args = [np.asarray(a) for a in prior_j]
        sp_j = _j(jcodec, "spatial", jnp.asarray(y_hat0), *prior_j)
        sp_t = m.spatial(torch.from_numpy(y_hat0),
                         *[torch.from_numpy(a.copy()) for a in args])
        for g, want in zip(sp_t, sp_j):
            _close(g, want)
        x_j = _j(jcodec, "synthesis", jnp.asarray(y_hat0), q)
        x_t = m.synthesis(torch.from_numpy(y_hat0), tq)
        _close(x_t, x_j)
        assert 0.01 < float(x_t.std())


def test_training_forward_matches_flax(codecs):
    jcodec, tcodec = codecs
    x = np.concatenate([_img(64, 64, 8), _img(64, 64, 9)])
    for qs in (None, 1.2):
        want = jcodec.model.apply(
            {"params": jcodec.params}, jnp.asarray(x),
            None if qs is None else jnp.float32(qs))
        with torch.no_grad():
            got = tcodec.model(torch.from_numpy(x), None if qs is None
                               else torch.tensor(qs))
        for k in ("x_hat", "bpp", "bpp_y", "bpp_z"):
            _close(got[k], want[k])


@pytest.mark.parametrize("h,w", [(64, 64), (64, 96)])
def test_streams_byte_identical_to_jax(codecs, h, w):
    jcodec, tcodec = codecs
    x = _img(h, w, 11 + w)
    for qs in (0.8, 1.4):
        j = jcodec.compress(jnp.asarray(x), qs, h=h, w=w)
        r = tcodec.compress(x, qs)
        assert len(j["bit_stream"]) > 100
        assert r["bit_stream"] == j["bit_stream"]
        _close(r["x_hat"], j["x_hat"])
        out = tcodec.decompress(j["bit_stream"], qs, h, w)
        assert torch.equal(out["x_hat"], r["x_hat"])
        _close(out["x_hat"], j["x_hat"])
        assert out["x_hat"].shape == (1, h, w, 3)
        assert 0.0 <= float(out["x_hat"].min()) <= \
            float(out["x_hat"].max()) <= 1.0


def test_random_init_is_seeded_and_damped():
    cfg = evc.TINY_EVC_CONFIG
    a = EVCCodec.init_random(torch.Generator().manual_seed(2), cfg=cfg,
                             init_scale=0.4, device="cpu")
    b = evc.EVC(cfg)
    b.reset_parameters(torch.Generator().manual_seed(2))
    for k, t in b.state_dict().items():
        got = a.model.state_dict()[k]
        scale = 0.4 if k.endswith(".weight") else 1.0
        torch.testing.assert_close(got, t * scale, rtol=0, atol=0)
    assert float(b.q_basic.detach().min()) == \
        float(b.q_scale.detach().max()) == 1.0


def test_params_v1_files_both_ways(codecs, tmp_path):
    """A params.v1 file the JAX package writes loads into the port at the
    file's config; the port's save_native rewrites it byte for byte."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    jcodec, tcodec = codecs
    path, again = str(tmp_path / "evc.bin"), str(tmp_path / "again.bin")
    save_params(path, jax.tree.map(np.asarray, jcodec.params), jcodec.cfg)
    cfg = native_config(path, evc.EVCConfig, None)
    assert cfg == tcodec.cfg
    model = load_native_into(evc.EVC(cfg), path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, tcodec.model.state_dict()[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
