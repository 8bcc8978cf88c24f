"""The kernels' launch counts under concurrency, on the CPU.

Every wrapper counts a launch through ``ops.sepconv.count_launch``: the
process-wide count (the wrapper's ``launches`` attribute, which runs set
to 0 and read) under one lock, and the launching thread's own count.  A
CUDA-graph capture takes back the capturing thread's count
(``thread_launch_counts``), so another engine's launches and replay
credits (``credit_launches``, process-wide only) on other threads never
land in a capture's record.  The capture itself runs only on the card
(``tests/test_torch_cuda.py``); here H1's wrapper runs with its C launch
stubbed out, and the counting functions are driven directly.
"""

import sys
import threading

import torch

from sparkdl_tpu_torch.ops import head as hops
from sparkdl_tpu_torch.ops import sepconv as ops

N = 3000


def _run(threads):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_counts_and_credits_lose_no_update(monkeypatch):
    """Six threads count B1 launches while three credit replays: the
    process-wide count is the exact sum, each counting thread's own count
    is its launches, and a crediting thread's own count stays 0."""
    monkeypatch.setattr(ops.fused_sepconv, "launches", 0)
    monkeypatch.setattr(ops.fused_mbconv, "launches", 0)
    own = {}

    def launcher(k):
        for _ in range(N):
            ops.count_launch(ops.fused_sepconv)
        own[k] = ops.thread_launch_counts()

    def creditor(k):
        for _ in range(N):
            ops.credit_launches((1, 0, 2))
        own[k] = ops.thread_launch_counts()

    _run([threading.Thread(target=launcher, args=(f"l{i}",))
          for i in range(6)]
         + [threading.Thread(target=creditor, args=(f"c{i}",))
            for i in range(3)])
    assert ops.launch_counts() == (6 * N + 3 * N, 0, 6 * N)
    assert all(own[f"l{i}"] == (N, 0, 0) for i in range(6))
    assert all(own[f"c{i}"] == (0, 0, 0) for i in range(3))


def test_a_thread_count_excludes_other_threads(monkeypatch):
    """What a capture reads: the difference of this thread's counts across
    its work is its own launches, whatever other threads launch and credit
    meanwhile."""
    monkeypatch.setattr(ops.fused_sepconv, "launches", 0)
    monkeypatch.setattr(ops.fused_sepconv, "tiled_launches", 0)
    monkeypatch.setattr(ops.fused_mbconv, "launches", 0)
    go, stop = threading.Event(), threading.Event()

    def other():
        go.set()
        while not stop.is_set():
            ops.count_launch(ops.fused_sepconv)
            ops.credit_launches((30, 0, 0))

    t = threading.Thread(target=other)
    t.start()
    try:
        go.wait(5)
        before = ops.thread_launch_counts()
        for _ in range(200):
            ops.count_launch(ops.fused_sepconv)
        for _ in range(4):
            ops.count_launch(ops.fused_sepconv, "tiled_launches")
        ops.count_launch(ops.fused_mbconv)
        after = ops.thread_launch_counts()
    finally:
        stop.set()
        t.join(timeout=10)
    assert tuple(a - b for a, b in zip(after, before)) == (200, 4, 1)
    assert ops.launch_counts()[0] > 200  # the other thread's were counted


def test_head_wrapper_counts_per_thread_and_process_wide(monkeypatch):
    """H1's wrapper, its C launch stubbed, called from eight threads at
    once: ``head_pass.launches`` counts every call and each thread's own
    count its calls."""
    monkeypatch.setattr(hops.head_pass, "launches", 0)
    monkeypatch.setattr(ops, "_launch", lambda *a, **k: None)
    feats = torch.zeros((2, 16))
    idx = torch.zeros(2, dtype=torch.int32)
    kernel, bias = torch.zeros((1, 16, 3)), torch.zeros((1, 3))
    own = {}

    def caller(k):
        for _ in range(500):
            hops._head_pass_cuda(feats, idx, kernel, bias)
        own[k] = ops.thread_launches(hops.head_pass)

    _run([threading.Thread(target=caller, args=(k,)) for k in range(8)])
    assert hops.head_pass.launches == 8 * 500
    assert own == {k: 500 for k in range(8)}
    assert ops.thread_launches(hops.head_pass) == 0  # this thread's own
