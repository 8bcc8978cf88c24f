"""The port's DeepImageFeaturizer / DeepImagePredictor held against the JAX
package's, end to end on the CPU, over the conftest's real JPEG fixtures
(three images and one undecodable file).

Both packages' zoo caches are filled through ``monkeypatch`` with the same
variables (the JAX module's init tree, the tree ``init_variables`` makes,
converted for the port by ``state_dict_from_jax``).  To keep the CPU work small, both registries'
Xception spec is narrowed to a 96x96 input for the test (widths stay
full); the model and every stage around it run as they are.
"""

import dataclasses

import numpy as np
import pytest

import jax

import sparkdl_tpu_torch
import sparkdl_tpu.transformers.named_image as jax_ni
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu.image.io import readImages as jax_readImages
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu_torch.image.io import readImages
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.convert import state_dict_from_jax
from sparkdl_tpu_torch.models.xception import Xception

SIZE = 96
# Both sides run the unfused f32 route on the CPU (no kernel on either):
# only the summation order of ~40 conv layers differs.
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def variables():
    spec = jax_spec("Xception")
    module = spec.build()
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r, a: module.init(r, a, train=False))(
            jax.random.PRNGKey(3), x))


@pytest.fixture
def zoo(monkeypatch, variables):
    """Both zoos serve the same Xception weights at a 96x96 input."""
    narrow_jax = dataclasses.replace(jax_spec("Xception"),
                                     input_size=(SIZE, SIZE))
    narrow_port = dataclasses.replace(port_spec("Xception"),
                                      input_size=(SIZE, SIZE))
    monkeypatch.setattr(jax_ni, "get_model_spec", lambda name: narrow_jax)
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow_port)
    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("Xception", ""),
                        (narrow_jax.build(), variables))
    model = Xception()
    model.load_state_dict(state_dict_from_jax("Xception", variables))
    monkeypatch.setitem(port_ni._MODEL_CACHE, ("Xception", ""),
                        model.eval())
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _features(df, col):
    return [None if v is None else np.asarray(v, np.float32)
            for v in df.table.column(col).to_pylist()]


def test_featurizer_matches_jax(zoo, fixture_images):
    kw = dict(inputCol="image", outputCol="features", modelName="Xception",
              batchSize=2)
    want = _features(jax_ni.DeepImageFeaturizer(**kw).transform(
        jax_readImages(fixture_images["dir"])), "features")
    df = readImages(fixture_images["dir"])
    got = _features(port_ni.DeepImageFeaturizer(**kw).transform(df),
                    "features")
    assert len(got) == len(want) == 4
    assert [g is None for g in got] == [w is None for w in want] == [
        False, False, False, True]  # the undecodable file stays null
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (2048,)
        np.testing.assert_allclose(g, w, **TOL)


def test_predictor_topk_matches_jax(zoo, fixture_images):
    kw = dict(inputCol="image", outputCol="preds", modelName="Xception",
              decodePredictions=True, topK=5, batchSize=4)
    want = jax_ni.DeepImagePredictor(**kw).transform(
        jax_readImages(fixture_images["dir"])).table.column(
        "preds").to_pylist()
    got = port_ni.DeepImagePredictor(**kw).transform(
        readImages(fixture_images["dir"])).table.column("preds").to_pylist()
    assert got[3] is None and want[3] is None
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == 5
        assert [p["class"] for p in g] == [p["class"] for p in w]
        # probabilities near 1/1000: hold them by relative error
        np.testing.assert_allclose([p["probability"] for p in g],
                                   [p["probability"] for p in w],
                                   rtol=1e-3, atol=1e-7)
        probs = [p["probability"] for p in g]
        assert probs == sorted(probs, reverse=True)


@pytest.mark.parametrize("num_rows,valid_idx", [
    (7, [0, 1, 3, 4, 6]), (5, []), (4, [3, 0, 2]), (3, [0, 1, 2])])
def test_float_list_column_matches_row_by_row_build(num_rows, valid_idx):
    """The output column built from the matrix in one piece is the column
    the row-by-row Python build gives: the same float32 values, nulls at
    the rows that did not decode, rows in table order."""
    import pyarrow as pa

    from sparkdl_tpu_torch.transformers.named_image import _float_list_array

    mat = np.random.default_rng(num_rows).normal(
        size=(len(valid_idx), 6)).astype(np.float32)
    want = [None] * num_rows
    for row, i in zip(mat, valid_idx):
        want[i] = [float(v) for v in row]
    want = pa.array(want, type=pa.list_(pa.float32()))
    got = _float_list_array(mat, valid_idx, num_rows)
    assert got.type == want.type and got.null_count == want.null_count
    assert got.equals(want)
