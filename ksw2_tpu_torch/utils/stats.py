"""Runtime observability: the ``km_stat`` analogue.

Port of ``ksw2_tpu/utils/stats.py``.  The reference's arena allocator
reports its capacity and free blocks so a caller can see how memory
reused over millions of alignment calls is doing (``kalloc.c:191-214``).
The JAX package's arena is its compile cache, so its report counts the
compiled variants of each engine.  The port compiles nothing per shape:
its kernels are one library, built once from ``csrc/``, and its device
memory is PyTorch's CUDA caching allocator.  So its report gives

* the built library's path, whether it exists and whether this process
  has loaded it;
* the kernel launches by name since the process started
  (``_build.LAUNCHES``);
* the card's allocator counters (``torch.cuda.memory_stats()``) and its
  free and total memory (``torch.cuda.mem_get_info()``), once this
  process has initialised CUDA; without a card, or before, the device
  part is empty.

It is a report: it changes nothing that runs.  ``engine_stats()`` returns
the numbers, ``format_stats()`` renders them like ``km_stat``'s stderr
lines and ``print_stats()`` prints them.
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from .. import _build

# torch.cuda.memory_stats() counters in the report
MEMORY_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
               "reserved_bytes.all.current", "reserved_bytes.all.peak",
               "num_alloc_retries", "num_ooms")


def engine_stats() -> Dict[str, dict]:
    """``{"library": {path, built, loaded}, "launches": {kernel: count},
    "device": {...}}``; the device part is empty unless CUDA is
    initialised in this process."""
    path = _build.library_path()
    lib = {"path": str(path), "built": path.exists(),
           "loaded": _build._lib is not None}
    dev: Dict[str, object] = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        k = torch.cuda.current_device()
        ms = torch.cuda.memory_stats(k)
        dev["name"] = torch.cuda.get_device_name(k)
        dev["index"] = k
        for key in MEMORY_KEYS:
            dev[key] = int(ms.get(key, 0))
        free, total = torch.cuda.mem_get_info(k)
        dev["free_bytes"], dev["total_bytes"] = int(free), int(total)
    return {"library": lib, "launches": dict(sorted(_build.LAUNCHES.items())),
            "device": dev}


def format_stats() -> str:
    """Human-readable report in the spirit of ``km_stat``'s stderr lines."""
    st = engine_stats()
    lib, launches = st["library"], st["launches"]
    state = ("loaded" if lib["loaded"] else "built, not loaded"
             if lib["built"] else "not built")
    lines = [f"[ksw2_tpu_torch] kernel library: {lib['path']} ({state})",
             f"[ksw2_tpu_torch] kernel launches: {sum(launches.values())} "
             f"({len(launches)} kernels)"]
    lines += [f"  {name}: {n}" for name, n in launches.items()]
    dev = st["device"]
    if dev:
        extra = ", ".join(f"{k}={v}" for k, v in dev.items())
        lines.append(f"  device: {extra}")
    return "\n".join(lines)


def print_stats(file=None) -> None:
    print(format_stats(), file=file or sys.stderr)


__all__ = ["MEMORY_KEYS", "engine_stats", "format_stats", "print_stats"]
