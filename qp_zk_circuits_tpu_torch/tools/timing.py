"""Timing helpers shared by `chip_smoke.py` and the tools (run on a CUDA card)."""

from __future__ import annotations

import statistics
import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def device_ms(fn, runs: int = 5):
    """Device-only time of one call: every device event torch.profiler
    records over `runs` calls, divided by `runs`; None if it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / runs
