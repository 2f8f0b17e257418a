"""The port's checkpoint downloader, dcvc_tpu_torch/utils/
download_checkpoints.py, against the JAX repo's scripts/
download_checkpoints.py, on the CPU with no network: urlretrieve is
patched in every test.

- REGISTRY (and its URL template) is the JAX script's.
- A download that fails gives rc 1 (FAILED), a share folder rc 2
  (MANUAL), a file in place `have`, with the JAX script's lines and exit
  code on the same tree.
- A file in place, synthesised as a reference .pth.tar through the key
  maps (TINY DMCI under the registry's DCVC-UF image name), converted
  with --import_native: the bytes utils/import_cli.import_checkpoint
  writes for it.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import os
import sys

import pytest
import torch

from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.utils import download_checkpoints as dl
from dcvc_tpu_torch.utils import import_cli
from dcvc_tpu_torch.utils.checkpoint import save_reference
from dcvc_tpu_torch.utils.jax_bridge import load_native_into

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_dl():
    spec = importlib.util.spec_from_file_location(
        "jax_download_checkpoints",
        os.path.join(REPO, "scripts", "download_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _offline(*args):
    raise OSError("no network in this test")


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    import urllib.request
    monkeypatch.setattr(urllib.request, "urlretrieve", _offline)
    monkeypatch.setattr(dl, "urlretrieve", _offline)


def test_registry_is_the_scripts(jax_dl):
    assert dl.REGISTRY == jax_dl.REGISTRY
    assert dl.ONE == jax_dl.ONE
    assert list(dl.REGISTRY) == list(jax_dl.REGISTRY)
    for fam in dl.REGISTRY:
        assert list(dl.REGISTRY[fam]) == list(jax_dl.REGISTRY[fam])


def test_failed_download_gives_rc_1(tmp_path, capsys):
    assert dl.main(["fm", "--root", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert err.count("FAILED") == len(dl.REGISTRY["fm"])
    assert not os.listdir(tmp_path / "fm")


@pytest.mark.parametrize("families", [["fm", "tcm"], ["tcm", "fm"],
                                      ["dc"]])
def test_lines_and_rc_are_the_scripts(jax_dl, tmp_path, monkeypatch, capsys,
                                      families):
    for root in ("jax", "port"):
        os.makedirs(tmp_path / root / "fm")
        (tmp_path / root / "fm" / "cvpr2024_image.pth.tar").write_bytes(b"x")
    monkeypatch.setattr(sys, "argv", ["download_checkpoints.py", *families,
                                      "--root", str(tmp_path / "jax")])
    want_rc = jax_dl.main()
    want = capsys.readouterr()
    got_rc = dl.main([*families, "--root", str(tmp_path / "port")])
    got = capsys.readouterr()
    assert got_rc == want_rc
    assert got.out.replace("port", "jax") == want.out
    assert got.err.replace("port", "jax") == want.err


def test_import_native_writes_the_converters_bytes(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setitem(import_cli.REGISTRY, "dmci",
                        (import_cli.REGISTRY["dmci"][0], TINY_CONFIG))
    model = DMCI(TINY_CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(7))
    os.makedirs(tmp_path / "uf")
    src = str(tmp_path / "uf" / "cvpr2026_image.pth.tar")
    save_reference(src, model)
    # the other DCVC-UF files are share folders only: MANUAL, rc 2
    assert dl.main(["uf", "--root", str(tmp_path), "--import_native"]) == 2
    out = capsys.readouterr().out
    assert f"have {src}" in out and out.count("MANUAL") == 3
    native = str(tmp_path / "uf" / "cvpr2026_image.native.bin")
    assert f"imported -> {native}" in out
    ref = str(tmp_path / "ref.bin")
    import_cli.import_checkpoint(src, ref, kind="dmci")
    with open(native, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    back = load_native_into(DMCI(TINY_CONFIG), native).state_dict()
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_unknown_name_is_skipped(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(dl.REGISTRY, "x", {"mystery.pth.tar": "folder:y"})
    os.makedirs(tmp_path / "x")
    (tmp_path / "x" / "mystery.pth.tar").write_bytes(b"")
    assert dl.main(["x", "--root", str(tmp_path), "--import_native"]) == 0
    assert "skip import of mystery.pth.tar" in capsys.readouterr().err
