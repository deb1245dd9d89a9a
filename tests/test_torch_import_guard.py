"""The torch port stands alone: it imports neither JAX nor anything of
the reference package ``repro``, and neither do ``chip_smoke.py`` and
the torch examples (``examples/torch_*.py``)."""
import os
import re
import subprocess
import sys
from pathlib import Path
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)(\.|\s|$|,)|"
                       r"from\s+(jax|repro)(\.|\s))", re.M)


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "need = {'repro_torch.models.' + m for m in\n"
        "        ('gla', 'moe', 'mamba2', 'xlstm')}\n"
        "import repro_torch.configs as c\n"
        "need |= set(c._ARCH_MODULES.values())\n"
        "need |= {'repro_torch.launch.' + m for m in\n"
        "         ('mesh', 'analysis', 'dryrun')}\n"
        "assert need <= set(names), need - set(names)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 43      # every module was imported


def test_no_source_imports_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 30 and len(examples) == 4
    bad = [str(f.relative_to(ROOT)) for f in files
           if FORBIDDEN.search(f.read_text())]
    assert bad == []
    assert FORBIDDEN.search("from repro.core import x\n")
    assert FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not FORBIDDEN.search("from repro_torch.core import x\n")


def test_chip_smoke_refuses_to_run_without_a_card():
    """No CUDA here: the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_torch_examples_import_with_jax_and_repro_blocked():
    code = (
        "import sys, runpy, glob\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "for f in sorted(glob.glob('examples/torch_*.py')):\n"
        "    runpy.run_path(f, run_name='not_main')\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
