"""In-process pub/sub bus — the IPublish analog (jsdr.java:118-147).

Synchronous fan-out with last-value retention, used as the observability
plane between pipeline stages and taps (PSD lines, tuning markers,
counters) exactly like the reference's topics (`fft-psd`,
`FUNcube<n>-bpsk-centre`, ...).

A copy of :mod:`jsdr_tpu.runtime.pubsub` (it imports no jax), numbers and behaviour
unchanged; tests/test_torch_host_copies.py holds it equal to the
reference.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

Listener = Callable[[str, Any], None]


class PubSub:
    def __init__(self):
        self._values: dict[str, Any] = {}
        self._listeners: list[Listener] = []
        self._lock = threading.RLock()

    def publish(self, topic: str, value: Any) -> None:
        with self._lock:
            self._values[topic] = value
            listeners = list(self._listeners)
        for fn in listeners:
            fn(topic, value)

    def get(self, topic: str, default: Any = None) -> Any:
        with self._lock:
            return self._values.get(topic, default)

    def listen(self, fn: Listener) -> None:
        with self._lock:
            self._listeners.append(fn)

    def unlisten(self, fn: Listener) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)
