"""Time the checkpoint reader's crc32c (``sparkdl_tpu_torch/graph/
bundle.py``) on the host: the vectorised form over a full-size
InceptionV3's worth of bytes (96 MB) against the byte-at-a-time table loop
over 4 MB (scaled to 96 MB), both checked equal on the 4 MB.

    python3 tools/crc32c_timing.py

Host only (numpy, one core); ~25 s.  Prints the host's CPU model beside
the times, and the card's name and power limit where ``nvidia-smi`` is
present: they are host times, not device metrics.
"""

import platform
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])

from sparkdl_tpu_torch.graph import bundle  # noqa: E402

FULL = 96_000_000
SMALL = 4_000_000


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no card"


def main():
    print(_card(), flush=True)
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, SMALL, dtype=np.uint8).tobytes()
    full = rng.integers(0, 256, FULL, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    want = bundle._crc_loop(0xFFFFFFFF, small) ^ 0xFFFFFFFF
    loop_s = time.perf_counter() - t0
    assert bundle.crc32c(small) == want
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        bundle.crc32c(full)
        times.append(time.perf_counter() - t0)
    print(f"host {_cpu_model()}: crc32c vectorised over {FULL / 1e6:.0f} MB "
          f"{min(times):.2f} s (best of 3: "
          f"{', '.join(f'{t:.2f}' for t in times)}); byte loop "
          f"{loop_s:.2f} s over {SMALL / 1e6:.0f} MB, "
          f"{loop_s * FULL / SMALL:.1f} s scaled to {FULL / 1e6:.0f} MB")


if __name__ == "__main__":
    main()
