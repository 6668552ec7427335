"""The port stands alone: importing every module of `flowmap_tpu_torch` loads
no JAX, Flax, Optax or `flowmap_tpu` module, and its entry points refuse a
missing card unless the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import flowmap_tpu_torch
for mod in pkgutil.walk_packages(flowmap_tpu_torch.__path__, "flowmap_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "flowmap_tpu")
)
print("LOADED", len([m for m in sys.modules if m.startswith("flowmap_tpu_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    assert "BAD []" in out, out
    loaded = int(out.split("LOADED ")[1].split()[0])
    assert loaded >= 25, out


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from flowmap_tpu_torch.utils.device import resolve_device
    from flowmap_tpu_torch.utils.synthetic import SyntheticSceneCfg, make_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scene(SyntheticSceneCfg(num_frames=2, image_shape=(8, 8)))
    assert resolve_device("cpu") == torch.device("cpu")
