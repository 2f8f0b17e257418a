"""Port parity, core and entropy: dcvc_tpu_torch against dcvc_tpu on the
CPU, exact.

Pixel (un)shuffle, padding, the candidate-domain phase split/merge/valid
(whose order is the stream's symbol order), scale_to_index, the z and y
CDF banks, and the pins on the code the port copies from the JAX package.
"""

import ast
import glob
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.core import masks as jmasks
from dcvc_tpu.core import padding as jpadding
from dcvc_tpu.core import shuffle as jshuffle
from dcvc_tpu.entropy import bit_estimator as jbe
from dcvc_tpu.entropy import gaussian as jgauss
from dcvc_tpu.rans import device_decode as jdevice_decode
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu_torch.core import masks, padding, shuffle
from dcvc_tpu_torch.entropy import bit_estimator as tbe
from dcvc_tpu_torch.entropy import gaussian as tgauss
from dcvc_tpu_torch.rans import device_decode
from dcvc_tpu_torch.utils import keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("r,shape", [(2, (1, 6, 10, 5)), (8, (2, 16, 24, 3))])
def test_pixel_shuffle_roundtrip_matches_jax(r, shape):
    x = _rand(shape)
    u = shuffle.pixel_unshuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jshuffle.pixel_unshuffle(jnp.asarray(x), r)))
    s = shuffle.pixel_shuffle(u, r)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jshuffle.pixel_shuffle(jnp.asarray(u.numpy()),
                                                     r)))
    np.testing.assert_array_equal(s.numpy(), x)


@pytest.mark.parametrize("h,w", [(1080, 1920), (720, 1280), (45, 80),
                                 (17, 30), (64, 64)])
def test_padding_matches_jax(h, w):
    for p in (4, 16, 64):
        assert padding.get_padding_size(h, w, p) == \
            jpadding.get_padding_size(h, w, p)
    if h * w <= 64 * 64:
        y = _rand((1, h, w, 4))
        np.testing.assert_array_equal(
            padding.pad_for_y(torch.from_numpy(y)).numpy(),
            np.asarray(jpadding.pad_for_y(jnp.asarray(y))))


@pytest.mark.parametrize("h,w", [(4, 6), (5, 7), (45, 80), (68, 120),
                                 (1, 1)])
def test_phase_split_merge_valid_match_jax(h, w):
    c = 16
    y = _rand((1, h, w, c), seed=h * w)
    terms = masks.phase_terms_4x(c)
    assert terms == jmasks.phase_terms_4x(c)
    for step in range(4):
        t = terms[step]
        assert masks.terms_key(t) == jmasks.terms_key(t)
        split = masks.phase_split(torch.from_numpy(y), t)
        np.testing.assert_array_equal(
            split.numpy(), np.asarray(jmasks.phase_split(jnp.asarray(y), t)))
        np.testing.assert_array_equal(
            masks.phase_valid(h, w, masks.terms_key(t)),
            jmasks.phase_valid(h, w, jmasks.terms_key(t)))
        merged = masks.phase_merge(split, t, c, h, w)
        np.testing.assert_array_equal(
            merged.numpy(),
            np.asarray(jmasks.phase_merge(jnp.asarray(split.numpy()), t, c,
                                          h, w)))
    # the four steps' merges rebuild the grid exactly once
    total = sum(masks.phase_merge(masks.phase_split(torch.from_numpy(y), t),
                                  t, c, h, w) for t in terms)
    np.testing.assert_array_equal(total.numpy(), y)


def _jax_index(s):
    return np.asarray(jgauss.scale_to_index(jnp.asarray(s, jnp.float32)))


def test_index_thresholds_rederived_from_jax_formula():
    """Each threshold is the smallest f32 at which the JAX package's
    f32 clamp-log-floor index reaches k: bisect over f32 bit patterns."""
    lo = np.full(126, np.float32(tgauss.SCALE_MIN).view(np.int32), np.int64)
    hi = np.full(126, np.float32(tgauss.SCALE_MAX).view(np.int32), np.int64)
    k = np.arange(1, 127)
    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        up = _jax_index(mid.astype(np.int32).view(np.float32)) >= k
        hi = np.where(up, mid, hi)
        lo = np.where(up, lo, mid)
    np.testing.assert_array_equal(hi.astype(np.int32).view(np.float32),
                                  tgauss.INDEX_THRESHOLDS)


def test_scale_to_index_exact_on_dense_grid():
    thr = tgauss.INDEX_THRESHOLDS.view(np.int32)
    edges = (thr[:, None] + np.arange(-3, 4)[None, :]).reshape(-1)
    grid = np.concatenate([
        edges.astype(np.int32).view(np.float32),
        np.linspace(0.0, 20.0, 200_001, dtype=np.float32),
        np.float32([-1.0, 0.0, 0.1, 0.11, 15.999, 16.0, 16.001, 1e9])])
    got = tgauss.scale_to_index(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got, _jax_index(grid))
    assert got.dtype == np.int32


def test_z_cdf_bank_byte_equal():
    rng = np.random.default_rng(3)
    params = {k: (0.5 * rng.standard_normal((4, 8, n))).astype(np.float32)
              for k, n in (("h", 4), ("b", 4), ("a", 3))}
    got = tbe.BitEstimator(4, 8).compute_cdf_bank(params, 8)
    want = jbe.BitEstimator(4, 8).compute_cdf_bank(params, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_y_cdf_bank_byte_equal():
    got = tgauss.GaussianConditional(0.15).compute_cdf_bank()
    want = jgauss.GaussianConditional(0.15).compute_cdf_bank()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _file_bytes(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        return f.read()


@pytest.mark.parametrize("copy,original", [
    ("dcvc_tpu_torch/entropy/cdf.py", "dcvc_tpu/entropy/cdf.py"),
    ("dcvc_tpu_torch/rans/__init__.py", "dcvc_tpu/rans/__init__.py"),
    ("dcvc_tpu_torch/rans/rans.cc", "dcvc_tpu/rans/rans.cc"),
])
def test_copied_files_byte_equal(copy, original):
    assert _file_bytes(copy) == _file_bytes(original)


@pytest.mark.parametrize("copy,original", [
    (tbe.BitEstimator.compute_cdf_bank, jbe.BitEstimator.compute_cdf_bank),
    (tgauss.GaussianConditional, jgauss.GaussianConditional),
    (tgauss.get_scale_table, jgauss.get_scale_table),
    (masks.phase_terms_4x, jmasks.phase_terms_4x),
    (masks.phase_valid.__wrapped__, jmasks.phase_valid.__wrapped__),
    (masks.terms_key, jmasks.terms_key),
    (device_decode.split_streams, jdevice_decode.split_streams),
    (keys._translate, jkeys._translate),
    (keys._map_dmci, jkeys._map_dmci),
    (keys._map_dmc_ht, jkeys._map_dmc_ht),
    (keys._stacked_leaf, jkeys._stacked_leaf),
    (keys._recon_keys_ht, jkeys._recon_keys_ht),
    (keys.key_fn_dmci, jkeys.key_fn_dmci),
    (keys.key_fn_dmc_ht, jkeys.key_fn_dmc_ht),
])
def test_copied_functions_source_equal(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)


@pytest.mark.parametrize("name", ["_DCB_MAP", "_STACKED_SUB"])
def test_copied_key_tables_equal(name):
    assert getattr(keys, name) == getattr(jkeys, name)


_FORBIDDEN = ("jax", "jaxlib", "flax", "dcvc_tpu")


def _imported_roots(path):
    """Top-level package of every import in a source file, at any depth
    (inside functions and classes too); relative imports are skipped."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_sources_import_no_jax():
    """No file of the port and not chip_smoke.py imports jax, jaxlib, flax
    or dcvc_tpu, anywhere in the file (a function-local import counts)."""
    files = sorted(glob.glob(os.path.join(REPO, "dcvc_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = [f"{os.path.relpath(f, REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in _FORBIDDEN]
    assert not bad, bad


def test_import_scan_sees_function_local_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from dcvc_tpu.utils import x"
                   "\n    import jax.numpy\n    __import__('flax')\n")
    assert [r for _, r in _imported_roots(str(src))] == \
        ["os", "dcvc_tpu", "jax", "flax"]


def test_port_imports_no_jax():
    code = ("import sys, dcvc_tpu_torch, dcvc_tpu_torch.runtime.image_codec, "
            "dcvc_tpu_torch.runtime.video_codec, dcvc_tpu_torch.models.dmc_ht, "
            "dcvc_tpu_torch.kernels.fused_dcb, "
            "dcvc_tpu_torch.kernels.rans_decode, "
            "dcvc_tpu_torch.rans.device_decode, "
            "dcvc_tpu_torch.utils.jax_bridge, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dcvc_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
