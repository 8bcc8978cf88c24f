"""Write ``sparkdl_tpu_torch/graph/data/keras_inception_v3.json``: the model
config of ``keras.applications.InceptionV3(weights=None)`` at 299x299, in
Keras 3's ``config.json`` form, as the port's Keras converter reads it
(``graph/keras_convert.py``).

    KERAS_BACKEND=tensorflow python3 tools/gen_keras_configs.py

Needs Keras (any backend, on the CPU); builds the model, which downloads
nothing.  The config is trimmed of what the converter never reads
(initializers, regularizers, constraints, dtype policies, the shape and
dtype of each recorded tensor, build and compile configs), and every
auto-named layer (``conv2d_94`` if 94 were made before) is renumbered from
0 in creation order per class, as ``tools/gen_keras_layers.py`` renumbers
the weighted ones: so the config's weighted layers are the rows of
``models/data/keras_layers.json``'s InceptionV3 table, and the file does
not depend on what the process built before.  It is the model a user of
the reference's README brings to configs 3 and 4
(``KerasImageFileTransformer``, ``registerKerasImageUDF``); the machine
with the card has no Keras, so ``chip_smoke.py`` builds it from this file
and seeded Keras-layout arrays.
"""

import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "sparkdl_tpu_torch", "graph", "data",
                   "keras_inception_v3.json")
_DROP = ("dtype", "trainable", "module", "registered_name", "build_config",
         "compile_config", "quantization_config", "sparse", "ragged",
         "optional")
_DROP_SUFFIX = ("_initializer", "_regularizer", "_constraint")


def snake(cls: str) -> str:
    """Keras' snake case of a class name (the prefix of its auto names)."""
    name = re.sub(r"\W+", "", cls)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def auto_renames(layers) -> dict:
    """Old name -> new name of every auto-named layer: per class, renumbered
    from 0 in the order of Keras' per-process counter."""
    auto = {}
    for entry in layers:
        prefix = snake(entry["class_name"])
        m = re.fullmatch(rf"{re.escape(prefix)}(?:_(\d+))?", entry["name"])
        if m:
            auto.setdefault(prefix, []).append(
                (int(m.group(1) or 0), entry["name"]))
    renames = {}
    for prefix, names in auto.items():
        for rank, (_, old) in enumerate(sorted(names)):
            renames[old] = prefix + (f"_{rank}" if rank else "")
    return renames


def _trim_layer_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items()
            if k not in _DROP and not k.endswith(_DROP_SUFFIX)}


def _trim_args(obj, rename):
    """A node's arguments with each recorded tensor cut to its
    ``keras_history``, the layer renamed."""
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            layer, node, tensor = obj["config"]["keras_history"]
            return {"class_name": "__keras_tensor__", "config": {
                "keras_history": [rename.get(layer, layer), node, tensor]}}
        return {k: _trim_args(v, rename) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_trim_args(v, rename) for v in obj]
    return obj


def trim(config: dict) -> dict:
    """The converter's view of a Keras 3 functional model config
    (``json.loads(model.to_json())``): trimmed, auto names renumbered."""
    body = config["config"]
    rename = auto_renames(body["layers"])

    def ref(r):
        return [rename.get(r[0], r[0])] + list(r[1:])

    def refs(v):
        return ref(v) if isinstance(v[0], str) else [ref(r) for r in v]

    layers = []
    for entry in body["layers"]:
        name = rename.get(entry["name"], entry["name"])
        cfg = _trim_layer_config(entry["config"])
        cfg["name"] = name
        layers.append({"class_name": entry["class_name"], "name": name,
                       "config": cfg,
                       "inbound_nodes": _trim_args(entry["inbound_nodes"],
                                                   rename)})
    return {"class_name": config["class_name"], "config": {
        "name": body["name"], "layers": layers,
        "input_layers": refs(body["input_layers"]),
        "output_layers": refs(body["output_layers"])}}


def dump(config: dict) -> str:
    """One layer per line, so a diff of the file shows the layers."""
    body = config["config"]
    rows = ",\n".join("  " + json.dumps(l, sort_keys=True)
                      for l in body["layers"])
    head = {k: v for k, v in body.items() if k != "layers"}
    return (f'{{"class_name": {json.dumps(config["class_name"])}, "config": '
            f'{json.dumps(head, sort_keys=True)[:-1]}, "layers": [\n{rows}\n'
            f']}}}}\n')


def inception_v3_config() -> dict:
    import keras

    return trim(json.loads(
        keras.applications.InceptionV3(weights=None).to_json()))


def main():
    text = dump(inception_v3_config())
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
