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


@pytest.fixture(scope="module")
def topk_images(tmp_path_factory):
    """The conftest's ``fixture_images``, drawn from a generator of their
    own seeded 0.  The conftest's generator is session-wide, so the images
    it gives depend on which tests drew from it before in the same process
    (under ``pytest -n``, on the files the worker ran first); these are
    the ones it gives a test run alone."""
    from PIL import Image

    rng = np.random.default_rng(seed=0)
    d = tmp_path_factory.mktemp("topk_images")
    for i, size in enumerate([(32, 48), (64, 64), (50, 40)]):
        arr = (rng.random((size[1], size[0], 3)) * 255).astype("uint8")
        Image.fromarray(arr).save(d / f"img_{i}.jpg", quality=95)
    (d / "not_an_image.jpg").write_bytes(b"this is not a jpeg")
    return str(d)


def _near_tie(probs, i, j, rtol):
    """Positions i..j of a sorted top-k list hold probabilities that are
    pairwise within ``rtol`` of their neighbours (j may be k: past the
    list's end, for a class the other package ranks outside its top k)."""
    lo, hi = min(i, j), min(max(i, j), len(probs) - 1)
    return all(probs[a] - probs[a + 1] <= rtol * probs[a]
               for a in range(lo, hi))


def test_predictor_topk_matches_jax(zoo, topk_images):
    """The two packages' top 5 a row: probabilities position by position
    within ``rtol`` and sorted, and the same classes in the same order,
    except where both packages put two neighbouring classes within that
    ``rtol`` of each other: such a near tie may come in either order.  On
    these random weights the top probabilities sit near 1/1000, 1e-7 to
    4e-6 apart, which the two packages' f32 sums (1e-7 apart) can swap."""
    rtol = 1e-3
    kw = dict(inputCol="image", outputCol="preds", modelName="Xception",
              decodePredictions=True, topK=5, batchSize=4)
    want = jax_ni.DeepImagePredictor(**kw).transform(
        jax_readImages(topk_images)).table.column("preds").to_pylist()
    got = port_ni.DeepImagePredictor(**kw).transform(
        readImages(topk_images)).table.column("preds").to_pylist()
    assert got[3] is None and want[3] is None
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == len(w) == 5
        gp = [p["probability"] for p in g]
        wp = [p["probability"] for p in w]
        # probabilities near 1/1000: hold them by relative error
        np.testing.assert_allclose(gp, wp, rtol=rtol, atol=1e-7)
        assert gp == sorted(gp, reverse=True)
        for a, b, ap, bp in ((g, w, gp, wp), (w, g, wp, gp)):
            where = {p["class"]: k for k, p in enumerate(b)}
            for i, p in enumerate(a):
                j = where.get(p["class"], len(b))
                assert j == i or (_near_tie(ap, i, j, rtol)
                                  and _near_tie(bp, i, j, rtol)), (
                    [q["class"] for q in g], [q["class"] for q in w])
                if j < len(b):
                    np.testing.assert_allclose(ap[i], bp[j], rtol=rtol)


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
