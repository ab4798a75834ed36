"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``repro``, so they run on a GPU host that has
neither."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)", re.MULTILINE)


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    modules = _port_modules()
    for name in ("repro_torch.sim.engine", "repro_torch.sim.learn",
                 "repro_torch.core.merge", "repro_torch.models.tiny",
                 "repro_torch.optim.optimizers",
                 "repro_torch.kernels.gossip_merge",
                 "repro_torch.configs.fg_learn", "repro_torch.sim.cells",
                 "repro_torch.kernels.contacts", "repro_torch.sim.state",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.archs", "repro_torch.models.layers",
                 "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.kernels.ops",
                 "repro_torch.core.gossip", "repro_torch.tree",
                 "repro_torch.kernels.flash_attention", "repro_torch.serve",
                 "repro_torch.serve.engine", "repro_torch.models.mamba",
                 "repro_torch.kernels.ssd_scan", "repro_torch.core.mobility",
                 "repro_torch.core.meanfield", "repro_torch.core.dde",
                 "repro_torch.core.capacity", "repro_torch.core.staleness",
                 "repro_torch.configs.fg_paper", "repro_torch.sim.sweep",
                 "repro_torch.sim.dispatch", "repro_torch.checkpoint.ckpt"):
        assert name in modules, name
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        "sys.modules['repro'] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('isolated', len(sys.modules))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_sources_name_no_jax_or_repro_import():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    found = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
             for p in sources for m in FORBIDDEN.finditer(p.read_text())]
    assert not found, found
