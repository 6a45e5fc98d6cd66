"""Typed Python channels over the native runtime.

Counterpart of ``mvil_fusion_tpu/pipeline/channels.py``, over the port's
own runtime (``mvil_fusion_torch/runtime``).

Large payloads (numpy arrays, pytrees) stay in a Python-side registry; the
C channel carries only small pickled headers + payload tokens, giving the
native layer's blocking/backpressure/drop semantics without copying clouds
through ctypes buffers.
"""

from __future__ import annotations

import itertools
import pickle
import threading
from enum import IntEnum

import ctypes

from mvil_fusion_torch import runtime


class Policy(IntEnum):
    BLOCK = 0
    DROP_OLDEST = 1


class Closed(Exception):
    pass


class Channel:
    """Bounded channel with BLOCK or DROP_OLDEST semantics (the reference's
    ROS queue depths + deliberate drops, SURVEY.md §2.6)."""

    _tokens = itertools.count()

    def __init__(self, capacity: int = 16,
                 policy: Policy = Policy.BLOCK, slot_size: int = 4096):
        self._lib = runtime.load_library()
        self._h = self._lib.ch_create(capacity, slot_size, int(policy))
        self._slot = slot_size
        self._payloads: dict[int, object] = {}
        self._plock = threading.Lock()
        self._policy = policy

    def put(self, obj) -> None:
        token = next(self._tokens)
        with self._plock:
            self._payloads[token] = obj
        blob = pickle.dumps(token)
        buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        rc = self._lib.ch_push(self._h, buf, len(blob))
        if rc == -1:
            with self._plock:
                self._payloads.pop(token, None)
            raise Closed
        if rc == -2:
            raise ValueError("header too large for slot")
        if self._policy == Policy.DROP_OLDEST:
            self._gc()

    def get(self, timeout: float | None = None):
        out = (ctypes.c_uint8 * self._slot)()
        t_us = -1 if timeout is None else int(timeout * 1e6)
        rc = self._lib.ch_pop(self._h, out, self._slot, t_us)
        if rc == -1:
            raise Closed
        if rc == -3:
            raise TimeoutError
        token = pickle.loads(bytes(out[:rc]))
        with self._plock:
            return self._payloads.pop(token)

    def _gc(self):
        """Reap payloads of dropped headers (DROP_OLDEST only)."""
        live = self._lib.ch_size(self._h)
        with self._plock:
            if len(self._payloads) > live + 8:
                extra = sorted(self._payloads)[: len(self._payloads) - live]
                for t in extra:
                    self._payloads.pop(t, None)

    def close(self):
        self._lib.ch_close(self._h)

    def __len__(self):
        return int(self._lib.ch_size(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.ch_dropped(self._h))

    @property
    def pushed(self) -> int:
        return int(self._lib.ch_pushed(self._h))

    def __del__(self):
        try:
            self._lib.ch_destroy(self._h)
        except Exception:
            pass
