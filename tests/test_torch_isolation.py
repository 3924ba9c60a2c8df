"""The port never reaches JAX or the reference package.

In a fresh interpreter where ``import jax`` and ``import repro`` fail, every
module of ``repro_torch`` and the root ``chip_smoke.py`` must import.
"""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

PROBE = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None  # any import of these now raises
    sys.path.insert(0, {src!r})
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")
              and sys.modules[m] is not None]
    assert not leaked, leaked
    print(" ".join(names))
""")


def test_port_imports_without_jax_or_reference():
    src = os.path.abspath(os.path.join(ROOT, "src"))
    smoke = os.path.abspath(os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=src, smoke=smoke)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split()
    assert len(walked) >= 20  # every module was walked
    for name in ("layers.ssm", "layers.recurrent", "models.mamba",
                 "models.recurrentgemma", "models.whisper"):
        assert f"repro_torch.{name}" in walked, name


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """Without CUDA it exits non-zero and prints no result line; copied
    alone into an empty directory it cannot find the port either."""
    import torch

    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    scripts = [str(lone)]
    if not torch.cuda.is_available():  # on a card it would run for real
        scripts.append(os.path.join(ROOT, "chip_smoke.py"))
    for script in scripts:
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, env=env, cwd=str(tmp_path),
                             timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
