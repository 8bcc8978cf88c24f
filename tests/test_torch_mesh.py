"""The port's device mesh and weight-sharding policy
(``sparkdl_tpu_torch/parallel/mesh.py``) held EQUAL to the JAX package's
``sparkdl_tpu.parallel.mesh`` on the conftest's 8 virtual CPU devices.

The policy functions read only ``mesh.shape`` and ``mesh.axis_names``, so
the port's (1, 1), (2, 4) and (1, 8) meshes are built over eight
``cpu`` entries in this one process; JAX's over its eight devices.  Rule
matching, the default rules' divisibility fallback, explicit-spec
resolution, ``spec_to_json``, ``partition_digest`` and
``param_sharding_stats`` must agree exactly on one nested-dict tree, and
the stats of the zoo Xception module must equal JAX's on its variables.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.parallel import mesh as jmesh
from sparkdl_tpu_torch.parallel import mesh

SHAPES = [(1, 1), (2, 4), (1, 8)]


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _tree():
    """A nested-dict/list params tree with kernels that divide 4 and 8,
    ones that do not, biases, BatchNorm-style leaves, an embedding and a
    scalar."""
    rng = np.random.default_rng(3)

    def a(*shape, dtype=np.float32):
        return rng.normal(size=shape).astype(dtype)

    return {
        "conv": {"kernel": a(3, 3, 4, 8), "bias": a(8)},
        "dense": {"kernel": a(8, 6), "bias": a(6)},
        "head": {"kernel": a(6, 16), "bias": a(16)},
        "bn": {"scale": a(8), "bias": a(8), "mean": a(8), "var": a(8)},
        "emb": {"embedding": a(10, 8, dtype=np.float16)},
        "layers": [{"kernel": a(16, 4)}, {"kernel": a(4, 4), "step": a()}],
        "temperature": a(1),
    }


def _meshes(shape):
    data, model = shape
    n = data * model
    return (mesh.get_mesh(devices=["cpu"] * n, model_parallel=model),
            jmesh.get_mesh(num_devices=n, model_parallel=model))


def _flat_specs(tree, is_jax):
    if is_jax:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, JP))
        return [(jmesh.param_path_str(p), tuple(s)) for p, s in flat]
    return [(mesh.param_path_str(p), tuple(s))
            for p, s in mesh.tree_flatten_with_path(tree, mesh._is_spec)]


def test_get_mesh_shapes_and_refusals():
    m = mesh.get_mesh()
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices.flat[0] == torch.device("cpu")
    two = mesh.get_mesh(devices=["cpu"] * 8, model_parallel=4)
    assert two.shape == {"data": 2, "model": 4} and two.size == 8
    with pytest.raises(ValueError, match="Requested 2 devices; only 1"):
        mesh.get_mesh(num_devices=2)
    with pytest.raises(ValueError, match="does not divide 3 devices"):
        mesh.get_mesh(devices=["cpu"] * 3, model_parallel=2)
    assert mesh.batch_sharding(m, 3).spec == mesh.P("data", None, None)
    assert tuple(mesh.replicated_sharding(m).spec) == ()


def test_match_partition_rules_equal_jax():
    """Regex search, the first match wins, scalars replicate whatever the
    rule, callables see the leaf, and a leaf no rule matches raises
    naming it."""
    tree = _tree()
    rules_p = [(r"head/kernel$", mesh.P(None, "model")),
               (r"(^|/)kernel$", lambda leaf: mesh.P(
                   *([None] * (leaf.ndim - 1)), "data")),
               (r"emb", mesh.P("model", None)),
               (r".*", mesh.P())]
    rules_j = [(r"head/kernel$", JP(None, "model")),
               (r"(^|/)kernel$", lambda leaf: JP(
                   *([None] * (leaf.ndim - 1)), "data")),
               (r"emb", JP("model", None)),
               (r".*", JP())]
    got = _flat_specs(mesh.match_partition_rules(rules_p, tree), False)
    want = _flat_specs(jmesh.match_partition_rules(rules_j, tree), True)
    assert got == want
    assert dict(got)["layers/1/step"] == ()
    with pytest.raises(ValueError) as pe:
        mesh.match_partition_rules([(r"kernel", mesh.P())], tree)
    with pytest.raises(ValueError) as je:
        jmesh.match_partition_rules([(r"kernel", JP())], tree)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("shape", SHAPES)
def test_default_rules_and_stats_equal_jax(shape):
    """The default rules' divisibility fallback, the resolved specs,
    ``spec_to_json``, the digest's hex and ``param_sharding_stats``."""
    tree = _tree()
    pm, jm = _meshes(shape)
    _, pspecs = mesh.resolve_param_shardings(tree, pm)
    _, jspecs = jmesh.resolve_param_shardings(tree, jm)
    assert _flat_specs(pspecs, False) == _flat_specs(jspecs, True)
    assert [mesh.spec_to_json(s) for _, s in _flat_specs(pspecs, False)] \
        == [jmesh.spec_to_json(JP(*s)) for _, s in _flat_specs(jspecs, True)]
    assert mesh.partition_digest(pspecs) == jmesh.partition_digest(jspecs)
    assert mesh.specs_all_replicated(pspecs) == \
        jmesh.specs_all_replicated(jspecs)
    assert mesh.param_sharding_stats(pm, tree, pspecs) == \
        jmesh.param_sharding_stats(jm, tree, jspecs)
    assert mesh.param_sharding_stats(pm, tree) == \
        jmesh.param_sharding_stats(jm, tree)
    if shape[1] == 1:
        assert mesh.partition_digest(pspecs) == "replicated"
    else:
        # head/kernel (6, 16) splits; dense/kernel (8, 6) does not divide 4
        assert dict(_flat_specs(pspecs, False))["dense/kernel"] == ()
        assert dict(_flat_specs(pspecs, False))["head/kernel"] == \
            (None, "model")


@pytest.mark.parametrize("shape", SHAPES)
def test_explicit_specs_resolution_equal_jax(shape):
    """Explicit specs (PartitionSpec or NamedSharding leaves) win over the
    rules, an indivisible spec falls back to replicated per leaf, and a
    tree of another structure raises."""
    tree = _tree()
    pm, jm = _meshes(shape)

    def specs(P, named):
        wrap = (lambda s: named(s)) if named else (lambda s: s)
        return {
            "conv": {"kernel": wrap(P(None, None, None, "model")),
                     "bias": wrap(P("model"))},
            "dense": {"kernel": wrap(P("data", "model")),
                      "bias": wrap(P())},
            "head": {"kernel": wrap(P(None, ("data", "model"))),
                     "bias": wrap(P(None))},
            "bn": {k: wrap(P()) for k in ("scale", "bias", "mean", "var")},
            "emb": {"embedding": wrap(P("model", None))},
            "layers": [{"kernel": wrap(P("model", None))},
                       {"kernel": wrap(P(None, None)), "step": wrap(P())}],
            "temperature": wrap(P()),
        }

    for named in (False, True):
        pnamed = (lambda s: mesh.NamedSharding(pm, s)) if named else None
        jnamed = ((lambda s: jax.sharding.NamedSharding(jm, s))
                  if named else None)
        _, pspecs = mesh.resolve_param_shardings(
            tree, pm, specs=specs(mesh.P, pnamed))
        _, jspecs = jmesh.resolve_param_shardings(
            tree, jm, specs=specs(JP, jnamed))
        assert _flat_specs(pspecs, False) == _flat_specs(jspecs, True)
        assert mesh.partition_digest(pspecs) == jmesh.partition_digest(jspecs)
        assert mesh.param_sharding_stats(pm, tree, pspecs) == \
            jmesh.param_sharding_stats(jm, tree, jspecs)
    flat = {"conv/kernel": mesh.P()}
    with pytest.raises(ValueError, match="must mirror the params pytree"):
        mesh.resolve_param_shardings(tree, pm, specs=flat)
    with pytest.raises(ValueError, match="must mirror the params pytree"):
        jmesh.resolve_param_shardings(tree, jm, specs=flat)


def test_replicated_spellings_digest_alike():
    tree = {"a": np.zeros((4, 4), np.float32), "b": np.zeros(4, np.float32)}
    for spelled in ({"a": mesh.P(), "b": mesh.P()},
                    {"a": mesh.P(None, None), "b": mesh.P(None)}):
        assert mesh.partition_digest(spelled) == "replicated"
        assert mesh.specs_all_replicated(spelled)
    assert mesh.partition_digest(None) == jmesh.partition_digest(None)
    assert mesh.spec_to_json(mesh.P(None, ("data", "model"), "model")) == \
        jmesh.spec_to_json(JP(None, ("data", "model"), "model"))


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_xception_module_stats_equal_jax_variables(shape):
    """The zoo Xception module (state_dict without num_batches_tracked,
    the port's tree spelling) under the default rules: the same bytes,
    per-device bytes, largest replicated leaf, sharded and total leaves
    as JAX's variables (shapes from ``eval_shape``)."""
    from sparkdl_tpu_torch.models.xception import Xception

    spec = dataclasses.replace(jax_spec("Xception"), input_size=(71, 71))
    module = spec.build()
    variables = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            np.zeros((1, 71, 71, 3), np.float32),
                            train=False))
    port = Xception()
    pm, jm = _meshes(shape)
    _, pspecs = mesh.resolve_param_shardings(
        port, pm, mesh.default_partition_rules)
    _, jspecs = jmesh.resolve_param_shardings(
        variables, jm, jmesh.default_partition_rules)
    got = mesh.param_sharding_stats(pm, port, pspecs)
    want = jmesh.param_sharding_stats(jm, variables, jspecs)
    assert got == want
    assert got["total_leaves"] == len(
        [k for k in port.state_dict() if not k.endswith("num_batches_tracked")])
    if shape[1] > 1:
        assert got["sharded_leaves"] > 0
    paths = [mesh.param_path_str(p)
             for p, _ in mesh.tree_flatten_with_path(port)]
    assert all("." not in p for p in paths)
