"""What the weight-only subexpressions of a frozen graph cost a forward on
the card: the frozen Keras InceptionV3 of ``chip_smoke.py`` [tfgraph]
(each BatchNorm's var + eps, rsqrt, mean * inv and beta - ...: steps that
read only constants) as ``TFInputGraph`` imports it, against a copy whose
weight-only steps are evaluated once on the host and kept as buffers.
Prints the two graphs' kernel nodes and pools, how far apart their outputs
are, and device ms per forward (CUDA events around the engine's dispatch
of a pinned batch of 32 at 299x299) in f32 and TF32, the two engines in
turns (plain, folded, folded, plain, ...).

    python3 tools/tfgraph_fold_probe.py

Needs one CUDA card; ~20 s of command.  The importer itself does not fold
(ROADMAP.md, queue A follow-ups).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from sparkdl_tpu_torch.graph import proto, tf_import  # noqa: E402
from sparkdl_tpu_torch.graph.function import ModelFunction  # noqa: E402
from sparkdl_tpu_torch.graph.input import TFInputGraph  # noqa: E402
from sparkdl_tpu_torch.parallel.engine import InferenceEngine  # noqa: E402

BATCH = 32
ORDER = ("plain", "folded", "folded", "plain") * 2


def fold(module):
    """A copy of a ``TFGraphModule`` whose steps that read only constants
    are run once here, their outputs kept as buffers."""
    m = copy.deepcopy(module)
    vals = {s: getattr(m, f"c{i}") for i, s in enumerate(m.const_slots)}
    keep = []
    for op, name, ins, params, out, _ in m.steps:
        if all(i in vals for i in ins):
            with torch.no_grad():
                vals[out] = tf_import._OPS[op](params, *[vals[i] for i in ins])
        else:
            keep.append((op, name, ins, params, out))
    used = {i for step in keep for i in step[2]} | set(m.fetch_slots)
    for slot, value in vals.items():
        if slot in used and slot not in m.const_slots:
            m.register_buffer(f"c{len(m.const_slots)}",
                              value.contiguous().clone())
            m.const_names.append(f"folded:{slot}")
            m.const_slots.append(slot)
    # each kept step's value dropped after its last use, as imported
    m.steps = tf_import.with_frees(keep, m.fetch_slots)
    return m


def main():
    if not torch.cuda.is_available():
        sys.exit("tfgraph_fold_probe: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = cs._gen_tf_graphs()
    with open(gen.INCEPTION_JSON) as f:
        meta = json.load(f)
    with open(gen.INCEPTION_PB, "rb") as f:
        gd = gen.fill_skeleton(proto.GraphDef.parse(f.read()),
                               gen.skeleton_arrays(meta))
    mf = TFInputGraph.fromGraphDef(
        gd, [meta["feed"]],
        [meta["pooled"], meta["probabilities"]]).model_function()
    folded = ModelFunction(fn=mf.fn, module=fold(mf.module),
                           input_names=mf.input_names,
                           output_names=mf.output_names)
    print(f"steps {len(mf.module.steps)} -> {len(folded.module.steps)}",
          flush=True)
    pre = ModelFunction.from_callable(cs.tf_inception_preprocess)
    x8 = np.random.default_rng(0).integers(0, 256, (BATCH, 299, 299, 3),
                                           dtype=np.uint8)
    engs, outs = {}, {}
    for name, m in (("plain", mf), ("folded", folded)):
        full = pre.compose(m)
        eng = InferenceEngine(full.fn, full.module, device="cuda",
                              device_batch_size=BATCH)
        outs[name] = eng(x8)
        engs[name] = (eng, eng._pad(x8))
    print("folded vs plain ||a-b||/||b||",
          {k: cs._rel(outs["folded"][k], outs["plain"][k])
           for k in outs["plain"]}, flush=True)
    for name, (eng, _) in engs.items():
        g = next(iter(eng._graphs.values()))
        print(f"{name}: kernel nodes {cs.graph_kernel_nodes(g.graph)[0]}, "
              f"pool {eng.graph_pool_bytes / 2**20:.1f} MiB", flush=True)
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = {"plain": [], "folded": []}
        for name in ORDER:
            eng, staged = engs[name]
            eng(x8)  # a capture under these flags
            ms[name].append(cs.cuda_ms(lambda: eng.run_padded(staged),
                                       reps=10))
        print("TF32" if tf32 else "f32", "device ms per forward",
              {k: [round(v, 3) for v in vs] for k, vs in ms.items()},
              flush=True)


if __name__ == "__main__":
    main()
