"""Write ``sparkdl_tpu_torch/models/data/keras_layers.json``: each zoo
model's weighted Keras layers in ``model.layers`` order, as
``[name, class_name, [var shapes]]``.

    KERAS_BACKEND=tensorflow python3 tools/gen_keras_layers.py

Needs Keras (any backend, on the CPU); builds each
``keras.applications.<Model>(weights=None)``, which downloads nothing.  A
Keras 3 ``.weights.h5`` keys each layer by its class and its rank among
that class's layers, not by name; the port's reader
(``models/keras_import.py read_weights_h5``) takes the names from this
table.  Keras auto-names some layers with a per-process counter
(``conv2d_94`` if 94 were made before); the table stores each auto name
renumbered from 0 in creation order (``conv2d``, ``conv2d_1``, ...), as a
fresh process would name them, so the importer's creation-order pairing
holds for the table's names and the table does not depend on what the
process built before.
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TABLE = os.path.join(ROOT, "sparkdl_tpu_torch", "models", "data",
                     "keras_layers.json")


def model_layers(keras_app):
    """``[name, class_name, [var shapes]]`` of the weighted layers of
    ``keras.applications.<keras_app>(weights=None)``, auto names
    renumbered in creation order."""
    import keras

    from sparkdl_tpu_torch.models.keras_import import SNAKE, WEIGHTED

    model = getattr(keras.applications, keras_app)(weights=None)
    rows, auto = [], {}
    for layer in model.layers:
        cls = type(layer).__name__
        if cls not in WEIGHTED or not layer.weights:
            continue
        m = re.fullmatch(rf"{SNAKE[cls]}(?:_(\d+))?", layer.name)
        if m:
            auto.setdefault(cls, []).append(
                (int(m.group(1) or 0), len(rows)))
        rows.append([layer.name, cls,
                     [list(v.shape) for v in layer.weights]])
    for cls, entries in auto.items():
        for rank, (_, i) in enumerate(sorted(entries)):
            rows[i][0] = SNAKE[cls] + (f"_{rank}" if rank else "")
    return rows


def table():
    """The table of every zoo model."""
    from sparkdl_tpu_torch.models import SUPPORTED_MODELS, get_model_spec

    return {n: model_layers(get_model_spec(n).keras_app)
            for n in SUPPORTED_MODELS}


def dump(t) -> str:
    """One layer per line, so a diff of the file shows the layers."""
    lines = []
    for name, rows in t.items():
        body = ",\n".join("  " + json.dumps(r) for r in rows)
        lines.append(f"{json.dumps(name)}: [\n{body}\n]")
    return "{\n" + ",\n".join(lines) + "\n}\n"


def main():
    with open(TABLE, "w") as f:
        f.write(dump(table()))
    print(f"wrote {TABLE}")


if __name__ == "__main__":
    main()
