"""Every name that a subpackage of the JAX package exports from its
`__init__.py` resolves in the port's counterpart. The JAX files are read
with `ast`, so nothing of the JAX package is imported; the port renames two
names (its K3 search is `nearest_code`, the plain one `nearest_code_plain`)."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RENAMES = {"nearest_code_pallas": "nearest_code", "nearest_code_xla": "nearest_code_plain"}


def _exported(subpackage: str):
    tree = ast.parse((ROOT / "muse_maskgit_pytorch_tpu" / subpackage / "__init__.py").read_text())
    return [alias.asname or alias.name for node in tree.body if isinstance(node, ast.ImportFrom) for alias in node.names]


@pytest.mark.parametrize("subpackage", ["ops", "models", "training", "parallel", "utils"])
def test_jax_subpackage_names_resolve_in_the_port(subpackage):
    port = importlib.import_module(f"muse_maskgit_pytorch_tpu_torch.{subpackage}")
    missing = [name for name in _exported(subpackage) if not hasattr(port, RENAMES.get(name, name))]
    assert not missing, f"muse_maskgit_pytorch_tpu_torch.{subpackage} lacks {missing}"
