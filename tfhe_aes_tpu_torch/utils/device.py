"""Where the port's entry points run: the card unless the caller asks for
the CPU; and the constant tensors made once a device."""

from __future__ import annotations

import threading

import torch

_constants: dict[tuple, object] = {}
_constants_lock = threading.Lock()


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the card.  Raises when the
    card is wanted and there is none (pass device="cpu" to run on the
    CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the CPU")
    return dev


def record(device: torch.device):
    """What the numbers ran on: the card's name and count, or "cpu"."""
    if device.type == "cuda":
        return {"name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return "cpu"


def canonical(device) -> torch.device:
    """`device` with its index: "cuda" and "cuda:0" name one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def constant(key: tuple, device, make):
    """make(device), made once per (key, device) in this process: tensors
    that depend only on `key` (a plan, a parameter set, a table), shared
    by every later call on that device and never written.  A card's are
    complete before they are published (the maker's stream synchronised),
    so a reader on another stream needs no wait, and a call that finds
    them copies nothing to the device: a captured CUDA graph reads them by
    address (ops/graphs.py).  Made once also under threads (the warm-up's
    and keygen's)."""
    dev = canonical(device)
    key = key + (dev,)
    with _constants_lock:
        made = _constants.get(key)
        if made is None:
            made = make(dev)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            _constants[key] = made
    return made
