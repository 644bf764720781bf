"""Device-hang watchdog: deadline-guarded blocking waits (port of
kjarni_tpu/core/watchdog.py; cf. the reference's gpu_ops/timeout.rs:12
`GpuTimeoutConfig` and :73 `poll_with_timeout`).

A blocking wait runs in a daemon thread joined with a deadline, and the
caller gets a typed error instead of a hang. On timeout the thread keeps
waiting in the background (a CUDA sync cannot be interrupted), but the
request can fail, as the reference's poll loop cannot cancel GPU work either.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional, TypeVar

from .errors import DeviceTimeoutError

T = TypeVar("T")

# Default deadline for serve-path requests; None/0 disables.
DEFAULT_TIMEOUT_S = float(os.environ.get("KJARNI_DEVICE_TIMEOUT_S", "0")) or None


def _synchronize(tree: T) -> T:
    """Wait until the card has finished the work queued so far (all of
    `tree`'s producers among it); on a machine without a card there is
    nothing to wait for."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def block_with_timeout(tree: T, timeout_s: Optional[float],
                       what: str = "device sync") -> T:
    """torch.cuda.synchronize() with a deadline, then `tree`.

    Returns the tree on success; raises DeviceTimeoutError if the card has
    not finished within `timeout_s` seconds.
    """
    if not timeout_s or timeout_s <= 0:
        return _synchronize(tree)
    return call_with_timeout(lambda: _synchronize(tree), timeout_s, what)


def call_with_timeout(fn: Callable[[], T], timeout_s: Optional[float],
                      what: str = "device call") -> T:
    """Run fn() in a watchdog thread; raise DeviceTimeoutError on deadline.

    serve.py bounds whole request bodies (generate / chat / embed) with it,
    as the reference bounds every GPU poll (timeout.rs:73).
    """
    if not timeout_s or timeout_s <= 0:
        return fn()
    result: list[Any] = []
    error: list[BaseException] = []
    done = threading.Event()

    def _run():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 — reraised in caller
            error.append(e)
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True, name="kjarni-watchdog")
    t.start()
    if not done.wait(timeout_s):
        raise DeviceTimeoutError(
            f"{what} exceeded {timeout_s:.1f}s deadline — device may be "
            f"wedged (cf. gpu_ops/timeout.rs poll_with_timeout)")
    if error:
        raise error[0]
    return result[0]
