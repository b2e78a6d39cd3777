"""Timing helpers shared by `chip_smoke.py` and the tools (run on a CUDA card).

`device_ms` and `device_split` time the port's own kernels: every call into
the kernel library (`_cuda.lib()`) that a function makes is captured, right
there, `reps` times over into one CUDA graph while the call's operands are
still alive, and CUDA events around a replay of that graph give the
launches' device time with no host work between them. Every entry of the
library writes its outputs from its inputs (no entry reads what it wrote in
an earlier call), so the extra launches leave the function's result as it
was. Torch's own kernels (glue) are not counted.

No torch.profiler window is used for these times: over wrapper calls one
read some kernels low on the H100 machine (PERF.md, PR 5).
"""

from __future__ import annotations

import collections
import statistics
import subprocess

import torch


def card(index: int = 0) -> str:
    """Card `index`'s name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median span of one call on the card's clock (CUDA events), gaps between
    its launches and the host's work between them included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(entry, args, reps: int, replays: int = 3) -> float:
    """Device ms of one call of a library entry: the call `reps` times over
    in one CUDA graph (its stream argument, the last, replaced by the
    capture stream), median over `replays` timed replays."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            err = entry(*args[:-1], stream)
            if err:
                raise RuntimeError(f"replayed kernel entry failed: cudaError_t {err}")
    graph.replay()  # the first replay uploads the graph
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_split(fn, reps: int = 20, cuda=None) -> tuple[object, dict]:
    """Call `fn` once with each kernel-library entry it calls timed as
    `_graph_ms` does; returns fn's result and {entry: [device ms, calls]}
    summed over the call. `cuda` is the `_cuda` module of the checkout whose
    kernels run (default: this package's)."""
    if cuda is None:
        from .. import _cuda as cuda
    lib = cuda.lib()
    names = [n for n in cuda._ENTRIES if not n.endswith("_set_constants")]
    split = collections.defaultdict(lambda: [0.0, 0])

    def timed(name, entry):
        def call(*args):
            err = entry(*args)
            if err == 0:
                torch.cuda.synchronize()
                split[name][0] += _graph_ms(entry, args, reps)
                split[name][1] += 1
            return err

        return call

    saved = {n: getattr(lib, n) for n in names}
    try:
        for n, entry in saved.items():
            setattr(lib, n, timed(n, entry))
        out = fn()
    finally:
        for n, entry in saved.items():
            setattr(lib, n, entry)
    return out, dict(split)


def device_ms(fn, reps: int = 20, cuda=None):
    """Device time of one call of `fn`: the sum over the kernel-library calls
    it makes (`device_split`); None if it makes none."""
    fn()  # warm: builds, cached tables
    torch.cuda.synchronize()
    _, split = device_split(fn, reps, cuda)
    return sum(ms for ms, _ in split.values()) if split else None


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Device ms of one call of `fn`, a function of PyTorch's own kernels (a
    library call timed beside a port kernel): the call `reps` times over in
    one CUDA graph, median over `replays` timed replays, as `_graph_ms`
    times a kernel-library entry."""
    fn()  # warm: the caching allocator, lazy inits
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()  # the first replay uploads the graph
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)
