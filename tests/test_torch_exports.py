"""The port's packages export the reference's public names.

Each reference ``__init__.py`` is read by its syntax tree (nothing of jax
is imported for it): every name it imports, lists in ``__all__`` or hands
out from a module ``__getattr__`` must resolve on the port's package of the
same path, but for the flax-only training names. The two properties the
reference's dataclasses carry, ``SamplePlan.tier_a_cap`` and
``Block.num_edge_cap``, equal the reference's on the same plan and
block."""
import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", "parallel", "cache", "models", "ops", "train", "data"]
# flax-only: the port trains with torch modules and an optimizer
LEFT_OUT = {"TrainState", "create_train_state", "make_train_step"}


def reference_names(sub):
    """The public names of ``fgnn_tpu/<sub>/__init__.py``: imported, in
    ``__all__``, or compared against in ``__getattr__``."""
    path = os.path.join(REPO, "fgnn_tpu", sub, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.value for n in ast.walk(node)
                      if isinstance(n, ast.Compare)
                      for c in n.comparators if isinstance(c, ast.Constant)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", PACKAGES, ids=[s or "top" for s in PACKAGES])
def test_every_reference_name_resolves_on_the_port(sub):
    names = reference_names(sub)
    assert names, sub
    pkg = importlib.import_module(
        "fgnn_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names - LEFT_OUT if not hasattr(pkg, n))
    assert not missing, (sub, missing)


def test_top_level_all_is_the_reference_all():
    import fgnn_tpu_torch

    path = os.path.join(REPO, "fgnn_tpu", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    ref_all = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "__all__")
    assert fgnn_tpu_torch.__all__ == ref_all
    from fgnn_tpu_torch import RunConfig, SampleType  # noqa: F401


def test_parallel_engines_load_on_first_use():
    """``import fgnn_tpu_torch.parallel`` loads no engine; each engine name
    loads its module when first read, and an unknown name raises."""
    code = (
        "import sys\n"
        "import fgnn_tpu_torch.parallel as p\n"
        "eng = ('factored', 'switcher', 'async_dp', 'factored_multihost')\n"
        "loaded = lambda: [m for m in eng\n"
        "                  if f'fgnn_tpu_torch.parallel.{m}' in sys.modules]\n"
        "assert not loaded(), loaded()\n"
        "assert p.FactoredEngine.__name__ == 'FactoredEngine'\n"
        "assert loaded() == ['factored'], loaded()\n"
        "for n in ('SGNNEngine', 'SwitcherEngine', 'AsyncFactoredEngine',\n"
        "          'MultihostFactoredEngine'):\n"
        "    assert getattr(p, n).__name__ == n\n"
        "assert sorted(loaded()) == sorted(eng), loaded()\n"
        "try:\n"
        "    p.NoSuchEngine\n"
        "except AttributeError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok"]


def test_tier_a_cap_equals_the_reference():
    from fgnn_tpu.data import make_synthetic_dataset
    from fgnn_tpu.ops.padding import make_plan as jmake_plan
    from fgnn_tpu.ops.reference_impl import calibrate_caps
    from fgnn_tpu_torch.ops import make_plan as tmake_plan

    ds = make_synthetic_dataset(num_node=5000, avg_degree=12, feat_dim=16,
                                num_class=4, seed=11)
    caps, tier_stats = calibrate_caps(
        np.asarray(ds.indptr), np.asarray(ds.indices),
        np.asarray(ds.train_set), 256, [10, 25], seed=0,
        tier_candidates=(4, 6, 8, 10, 12, 16))
    for stats in (tier_stats, None):
        j = jmake_plan(256, (25, 10), ds.num_node, unique_caps=caps,
                       tier_stats=stats)
        t = tmake_plan(256, (25, 10), ds.num_node, unique_caps=caps,
                       tier_stats=stats)
        assert t.tier_layout == j.tier_layout
        assert t.tier_a_cap == j.tier_a_cap
    assert j.tier_a_cap is None
    assert tmake_plan(256, (25, 10), ds.num_node, unique_caps=caps,
                      tier_stats=tier_stats).tier_a_cap is not None


@pytest.mark.parametrize("edges", [0, 37, 4096])
def test_block_num_edge_cap_equals_the_reference(edges):
    import jax.numpy as jnp
    from fgnn_tpu.ops.sampling import Block as JBlock

    from torch_parity import block_to_torch

    j = JBlock(src_local=jnp.full((edges,), -1, jnp.int32),
               dst_local=jnp.full((edges,), -1, jnp.int32),
               mask=jnp.zeros((edges,), bool), num_src=jnp.int32(0),
               num_dst=jnp.int32(0))
    t = block_to_torch(j)
    assert t.num_edge_cap == j.num_edge_cap == edges
