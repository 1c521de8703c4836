"""Drop-in alias: reference-style ``mdproptools.*`` imports must resolve
to this package after compat.install() (reference import surface:
``mdproptools/__init__.py:1`` exports dynamical, structural)."""

import subprocess
import sys


def test_compat_install_aliases_reference_imports():
    # a clean interpreter so sys.modules state is controlled
    code = """
import mdproptools_tpu.compat as compat
compat.install()

from mdproptools.structural.rdf_cn import calc_atomic_rdf
from mdproptools.structural.cluster_analysis import get_clusters
from mdproptools.dynamical.diffusion import Diffusion
from mdproptools.dynamical.conductivity import Conductivity
from mdproptools.dynamical.viscosity import Viscosity
from mdproptools.dynamical.residence_time import ResidenceTime
from mdproptools.common.com_mols import calc_com
from mdproptools.utilities.plots import set_axis
import mdproptools

assert mdproptools.structural is not None
assert mdproptools.dynamical is not None
assert callable(calc_atomic_rdf) and callable(calc_com)
assert callable(set_axis)
assert all(callable(c) for c in
           (get_clusters, Diffusion, Conductivity, Viscosity,
            ResidenceTime))

compat.uninstall()
import sys
assert "mdproptools" not in sys.modules
print("COMPAT_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "COMPAT_OK" in out.stdout


def test_compat_alias_shares_module_instances():
    """A module imported FIRST through the alias name must be the same
    instance as the canonical import (shared caches/test hooks), not a
    second execution of the module file."""
    code = """
import sys
import mdproptools_tpu.compat as compat
compat.install()

# force the finder path: drop the module under both names so the next
# alias import cannot be satisfied from sys.modules
sys.modules.pop("mdproptools_tpu.structural.rdf_cn", None)
sys.modules.pop("mdproptools.structural.rdf_cn", None)
import mdproptools.structural.rdf_cn as aliased
import mdproptools_tpu.structural.rdf_cn as canonical
assert aliased is canonical, "alias produced a second module instance"
assert canonical.__name__ == "mdproptools_tpu.structural.rdf_cn"
assert canonical.__spec__.name == "mdproptools_tpu.structural.rdf_cn"

# state set through one name is visible through the other
canonical._COMPAT_PROBE = "compat-probe"
assert aliased._COMPAT_PROBE == "compat-probe"
canonical._COMPAT_PROBE = None
print("SHARED_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "SHARED_OK" in out.stdout


def test_compat_refuses_foreign_module():
    code = """
import sys, types
sys.modules["mdproptools"] = types.ModuleType("mdproptools")
import mdproptools_tpu.compat as compat
try:
    compat.install()
except RuntimeError:
    print("REFUSED")
compat.install(force=True)
import mdproptools
assert mdproptools.__name__ == "mdproptools_tpu"
print("FORCED_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "REFUSED" in out.stdout and "FORCED_OK" in out.stdout
