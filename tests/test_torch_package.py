"""Package rules of the port: it imports neither JAX nor the JAX package,
and it never falls back to the CPU when no card was asked for."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vp8oclenc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "vp8oclenc_tpu"
             or m.startswith("vp8oclenc_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module was imported, the decoder, spec and metrics copies too
    assert int(proc.stdout.split()[0]) >= 48


def _assert_imports_port_only(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert any(m.startswith("vp8oclenc_tpu_torch") for m in mods)
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "vp8oclenc_tpu"), m


def test_chip_smoke_imports_no_jax():
    _assert_imports_port_only("chip_smoke.py")


def test_quality_tool_imports_no_jax():
    """tools/quality_cuda.py, which chip_smoke.py runs, is held to the same
    rule."""
    _assert_imports_port_only(os.path.join("tools", "quality_cuda.py"))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory and without CUDA, it exits non-zero and prints
    no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_encoder_without_device_needs_cuda(monkeypatch):
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderConfig(gop_size=1), 64, 48)
    enc = Encoder(EncoderConfig(gop_size=1), 64, 48, device="cpu")
    assert enc.backend.device.type == "cpu"


def test_wrappers_refuse_other_devices():
    from vp8oclenc_tpu_torch.ops import intra
    y = torch.zeros((32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        intra.luma_wavefront(y, 4, 4)
