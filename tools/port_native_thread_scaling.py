"""Thread scaling of the PyTorch port's native decode core
(``sparkdl_tpu_torch.native``), on the host.

    python3 tools/port_native_thread_scaling.py [--images N]

Prints one JSON line per thread count: fused JPEG decode + resize
throughput (500x375 JPEG -> 299x299 RGB, the flowers-like shape of the
JAX package's ``tools/native_thread_scaling.py``, whose corpus this is)
through ``native.decode_resize_batch(num_threads=...)``, after the serial
PIL reference and the host's CPU count.  Where the core did not build (a
machine without libjpeg or libpng headers, such as the one with the
card), the native line is ``{"backend": "native", "error":
"unavailable"}``.  Host work only: no device is used.
"""

import argparse
import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corpus(n=64, height=375, width=500):
    from PIL import Image

    rng = np.random.default_rng(7)
    base = (rng.random((height, width, 3)) * 255).astype(np.uint8)
    blobs = []
    for i in range(n):
        arr = base.copy()
        arr[:8, :8, 0] = i % 251
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    return blobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=64,
                    help="JPEGs in the corpus (default 64)")
    args = ap.parse_args(argv)
    import sparkdl_tpu_torch.native as native
    from sparkdl_tpu_torch.image.io import PIL_decode, resizeImage

    blobs = corpus(args.images)
    n = len(blobs)
    print(json.dumps({"host_cpus": os.cpu_count()}), flush=True)

    # serial PIL reference (what the fallback path does per core)
    def pil_once():
        for b in blobs:
            arr = PIL_decode(b)
            resizeImage(arr, 299, 299)

    pil_once()  # warm
    t0 = time.perf_counter()
    pil_once()
    pil_ips = n / (time.perf_counter() - t0)
    print(json.dumps({"backend": "pil", "threads": 1,
                      "img_per_s": round(pil_ips, 1)}), flush=True)

    if not native.native_available():
        print(json.dumps({"backend": "native", "error": "unavailable"}))
        return
    for threads in (1, 2, 4, 8):
        native.decode_resize_batch(blobs, 299, 299,
                                   num_threads=threads)  # warm
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            out, ok = native.decode_resize_batch(blobs, 299, 299,
                                                 num_threads=threads)
            dt = time.perf_counter() - t0
            best = max(best, n / dt)
        if not ok.all():
            raise RuntimeError(f"{int((~ok).sum())} of {n} JPEGs did not "
                               f"decode at {threads} threads")
        print(json.dumps({"backend": "native", "threads": threads,
                          "img_per_s": round(best, 1)}), flush=True)


if __name__ == "__main__":
    main()
