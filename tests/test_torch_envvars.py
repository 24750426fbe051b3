"""The port's ``SFT_*`` registry (``spatialflink_tpu_torch/envvars.py``)
against the sources that read the vars and the JAX package's registry.

- The registry is exactly the set of ``SFT_*`` names that
  ``spatialflink_tpu_torch/`` and ``chip_smoke.py`` mention, checked by
  a scan of their sources in both directions (a var read but not
  registered fails, and so does a registered var nothing reads).
- Each owner is a module of the port that names its var.
- A var the JAX package registers too keeps the JAX hazard class.
- ``gate_scrub_vars`` holds every armed var and only those, and the
  module loads by file path with nothing imported (the stdlib-only
  contract a gate relies on).
"""

import ast
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

from spatialflink_tpu import envvars as jenv

from spatialflink_tpu_torch import envvars as tenv

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "spatialflink_tpu_torch"
_NAME = re.compile(r"\bSFT_[A-Z0-9_]+\b")


def _sources():
    files = [p for p in PORT.rglob("*.py") if p.name != "envvars.py"]
    return files + [REPO / "chip_smoke.py"]


def _mentions():
    found = {}
    for path in _sources():
        for name in _NAME.findall(path.read_text()):
            found.setdefault(name, set()).add(path)
    return found


def test_registry_is_the_set_the_sources_read():
    mentions = _mentions()
    assert set(mentions) == set(tenv.ENV_VARS), (
        sorted(set(mentions) ^ set(tenv.ENV_VARS)))


@pytest.mark.parametrize("name", sorted(tenv.ENV_VARS))
def test_each_var_has_a_reading_owner_and_the_jax_class(name):
    meta = tenv.ENV_VARS[name]
    assert set(meta) == {"owner", "hazard", "doc"} and meta["doc"]
    owner = REPO / meta["owner"]
    assert owner.is_file() and owner.parent.is_relative_to(PORT)
    assert name in owner.read_text()
    assert meta["hazard"] in tenv.HAZARD_CLASSES
    if name in jenv.ENV_VARS:
        assert meta["hazard"] == jenv.ENV_VARS[name]["hazard"]


def test_every_registered_var_is_one_the_jax_package_knows():
    # The port reads no var of its own yet: each one is the JAX
    # package's, with the JAX meaning.
    assert set(tenv.ENV_VARS) <= set(jenv.ENV_VARS)
    assert tenv.HAZARD_CLASSES == jenv.HAZARD_CLASSES


def test_gate_scrub_vars_holds_the_armed_ones():
    armed = tenv.gate_scrub_vars()
    assert armed == sorted(armed)
    assert set(armed) == {n for n, m in tenv.ENV_VARS.items()
                          if m["hazard"] == "armed"}
    assert {"SFT_FAULT_PLAN", "SFT_OVERLOAD_POLICY", "SFT_PIPELINE",
            "SFT_QSERVE", "SFT_ABLATE"} == set(armed)
    assert set(armed) <= set(jenv.gate_scrub_vars())


def test_selfcheck_rejects_an_unknown_class(monkeypatch):
    monkeypatch.setitem(tenv.ENV_VARS, "SFT_BOGUS",
                        {"owner": "x", "hazard": "spicy", "doc": "d"})
    with pytest.raises(ValueError, match="unknown hazard class"):
        tenv._selfcheck()


def test_module_is_stdlib_only_and_import_free():
    tree = ast.parse((PORT / "envvars.py").read_text())
    imports = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert all(isinstance(n, ast.ImportFrom) and n.module == "__future__"
               for n in imports)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ev', {str(PORT / 'envvars.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "assert 'torch' not in sys.modules and 'spatialflink_tpu_torch' "
        "not in sys.modules\n"
        "print(','.join(m.gate_scrub_vars()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split(",") == tenv.gate_scrub_vars()
    assert importlib.util.find_spec("spatialflink_tpu_torch.envvars")
