"""The port stands alone: it imports neither JAX, ``repro`` nor JAX's
``ml_dtypes``, and off the GPU it raises instead of falling back."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M
)


def _run(code: str, **env_over) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(env_over)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(REPO), timeout=300)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_statement(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_every_module_imports_without_jax_or_repro():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {str(REPO)!r})
import chip_smoke
assert not any(k in ("jax", "ml_dtypes") or k.startswith(("jax.", "repro.", "ml_dtypes."))
               for k in sys.modules if sys.modules[k] is not None)
print(len(names))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 40


def test_without_cuda_the_entry_points_raise():
    code = """
import os, tempfile
import numpy as np, torch
from repro_torch import pipelines as TP
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm
from repro_torch.raster import (ArraySource, TiledSource, demo_catalog, demo_time_series,
                                make_spot6_pair)
from repro_torch.serve import ServeEngine, TileRequest, TileServer
assert not torch.cuda.is_available()
cfg = reduced(get_config("olmo-1b"))
cpu_model = lm.init_params(cfg, device="cpu")
rtic = os.path.join(tempfile.mkdtemp(), "x.rtic")
TP.run_pipeline("IO", np.ones((4, 4, 1), np.uint16), sink=rtic, device="cpu")
for call in (lambda: TP.run_pipeline("IO", np.zeros((4, 4, 1), np.uint16)),
             lambda: ArraySource(np.zeros((4, 4, 1), np.uint16)),
             lambda: make_spot6_pair(8, 8),
             lambda: TiledSource(rtic),
             lambda: TP.run_pipeline("IO", rtic),
             lambda: TP.p8_mosaic(),
             lambda: TP.p9_ndvi_composite(),
             lambda: demo_catalog(),
             lambda: demo_time_series(),
             lambda: lm.init_params(cfg),
             lambda: ServeEngine(cfg, cpu_model),
             lambda: TP.build_tile_server(),
             lambda: TP.build_tile_server(server=TileServer())):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("ran without CUDA")
_, m = TP.run_pipeline("IO", np.ones((4, 4, 1), np.uint16), device="cpu")
assert m.result.sum() == 16
_, m = TP.run_pipeline("IO", rtic, device="cpu")
assert m.result.sum() == 16
_, m = TP.run_pipeline("P8", device="cpu")
assert m.result.shape == (48, 32, 4)
assert ServeEngine(cfg, cpu_model, max_seq=8, device="cpu").generate([[1, 2]], 2).shape == (1, 4)
tiles = TP.build_tile_server(pipelines=("P5",), zooms=(0,), device="cpu")
assert tiles.entries() == [("P5", 0)] and tiles.serve_one(TileRequest("P5", 0, 1, 1)).shape == (16, 16, 4)
print("ok")
"""
    proc = _run(code, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_build_without_nvcc_raises(tmp_path):
    code = f"""
import pathlib
from repro_torch.kernels import _build
_build.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
for fn in (_build.find_nvcc, _build.library):
    try:
        fn()
    except RuntimeError as e:
        assert "nvcc not found" in str(e), e
    else:
        raise SystemExit(f"{{fn.__name__}} did not raise")
print("ok")
"""
    proc = _run(code, PATH="", CUDA_HOME=str(tmp_path / "no-cuda"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
