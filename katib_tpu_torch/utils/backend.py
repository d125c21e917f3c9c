"""Bounded CUDA backend probe — the port's counterpart of
``katib_tpu/utils/backend.py``.

The first CUDA call of a process initialises the CUDA runtime; on a broken
install it can hang. The probe runs that first call on a daemon thread with
a timeout, caches the verdict for the process, and hands out
``torch.device("cuda:i")`` slots. With no usable CUDA device it raises
``BackendUnavailable``: the port never carries on on the CPU unless the
caller asks for the CPU explicitly.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

import torch

log = logging.getLogger("katib_tpu_torch.backend")

_state_lock = threading.Lock()
_VERDICT: Optional[bool] = None  # None = not yet probed in this process
_COUNT = 0
_REASON = ""


class BackendUnavailable(RuntimeError):
    """No CUDA device could be probed, and the CPU was not asked for."""


def reset_probe_state() -> None:
    """Forget the cached verdict (tests)."""
    global _VERDICT, _COUNT, _REASON
    with _state_lock:
        _VERDICT, _COUNT, _REASON = None, 0, ""


def _probe(timeout_seconds: float) -> None:
    global _VERDICT, _COUNT, _REASON
    box: dict = {}

    def run():
        try:
            if not torch.cuda.is_available():
                box["error"] = "torch.cuda.is_available() is False"
                return
            n = torch.cuda.device_count()
            for i in range(n):
                torch.cuda.get_device_properties(i)
            box["count"] = n
        except BaseException as e:  # noqa: BLE001 — surfaced as the reason
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=run, daemon=True, name="cuda-probe")
    t.start()
    t.join(timeout_seconds)
    with _state_lock:
        if t.is_alive():
            _VERDICT, _REASON = False, f"CUDA probe hung past {timeout_seconds:.0f}s"
        elif "error" in box:
            _VERDICT, _REASON = False, box["error"]
        else:
            _VERDICT, _COUNT = box["count"] > 0, box["count"]
            _REASON = "" if _COUNT else "no CUDA devices"
    if not _VERDICT:
        log.warning("CUDA backend unavailable: %s", _REASON)


def bounded_cuda_devices(timeout_seconds: float = 15.0) -> Optional[List[torch.device]]:
    """The process's CUDA devices, or None when the bounded probe failed."""
    with _state_lock:
        verdict = _VERDICT
    if verdict is None:
        _probe(timeout_seconds)
    with _state_lock:
        return [torch.device("cuda", i) for i in range(_COUNT)] if _VERDICT else None


def require_devices(timeout_seconds: float = 15.0) -> List[torch.device]:
    """:func:`bounded_cuda_devices` that raises ``BackendUnavailable``
    instead of returning None."""
    devices = bounded_cuda_devices(timeout_seconds)
    if not devices:
        raise BackendUnavailable(
            f"no usable CUDA device ({_REASON}); pass device='cpu' or "
            "devices=[torch.device('cpu')] to run on the CPU"
        )
    return devices


def trial_device(ctx) -> torch.device:
    """The first device the controller gave the trial, else the first CUDA
    device (:func:`require_devices`, which raises without one)."""
    devices = ctx.torch_devices() if ctx is not None else []
    return devices[0] if devices else require_devices()[0]


def probe_verdict() -> Optional[bool]:
    """True (devices found), False (probe failed), None (not yet probed)."""
    with _state_lock:
        return _VERDICT


def device_name(index: int = 0) -> str:
    """The CUDA device's name, e.g. "NVIDIA H100 80GB HBM3"."""
    require_devices()
    return torch.cuda.get_device_name(index)
