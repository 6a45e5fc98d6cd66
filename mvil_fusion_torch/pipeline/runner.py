"""Asynchronous pipeline runner over native channels.

Counterpart of ``mvil_fusion_tpu/pipeline/runner.py``.  The reference runs
six processes with internal worker threads and mutexes (reference:
estimator_node.cpp:20-36 m_buf/m_state/l_buf mutexes + process/
process_lidar threads).  Here each stage is one Python thread draining a
bounded native channel and pushing to the next — ctypes blocking pops
release the GIL, so host preprocessing, device dispatch, and IO genuinely
overlap.  A `deterministic` mode drains stages round-robin on one thread
for reproducible tests.

On the card each stage may own a CUDA stream: its thread makes it the
current stream once (the current stream is per thread), and the
deterministic drain switches to it around each call, so a readback of one
stage waits for that stage's own work only.  The stage streams wait for
the caller's stream when the stages start (`start`, each `drain`), and
the caller's stream waits for them when they are done (`stop`, the end of
each `drain`), so that work the caller queues before and after is ordered
with theirs.  Two differences from the
reference: `stop` raises where a stage thread is still alive after its
join (the reference returned silently), and `quiesce` counts the items
each stage has finished against those pushed into its inbox, so an item
between its pop and its processing is never taken for idleness.
"""

from __future__ import annotations

import contextlib
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from mvil_fusion_torch.pipeline.channels import Channel, Closed, Policy


class MultiOut(list):
    """A stage may return MultiOut([...]) to emit several downstream items
    from one input (e.g. draining a buffer)."""


@dataclass
class Stage:
    name: str
    fn: Callable                  # item -> result | None (None = filtered)
    inbox: Channel
    outbox: Optional[Channel] = None
    thread: Optional[threading.Thread] = None
    stream: Optional[torch.cuda.Stream] = None   # the stage's CUDA stream
    processed: int = 0
    finished: int = 0             # items taken and done with, errors too
    errors: list = field(default_factory=list)


def _on_stream(stream):
    """The stage's stream as the current one, or nothing off the card."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class Pipeline:
    def __init__(self, deterministic: bool = False):
        self.stages: list[Stage] = []
        self.deterministic = deterministic
        self._running = False

    def add_stage(self, name: str, fn, capacity: int = 16,
                  policy: Policy = Policy.BLOCK,
                  stream: Optional[torch.cuda.Stream] = None) -> Channel:
        """Append a stage; returns its inbox channel (feed it upstream).
        The stage's output flows into the next stage's inbox.  `fn` runs
        with `stream` (if given) as the current CUDA stream."""
        inbox = Channel(capacity=capacity, policy=policy)
        st = Stage(name=name, fn=fn, inbox=inbox, stream=stream)
        if self.stages:
            self.stages[-1].outbox = inbox
        self.stages.append(st)
        return inbox

    def _run(self, st: Stage, item) -> None:
        """One item through one stage: its outputs pushed downstream, an
        exception recorded on the stage."""
        try:
            res = st.fn(item)
            st.processed += 1
            if res is not None and st.outbox is not None:
                for r in (res if isinstance(res, MultiOut) else [res]):
                    st.outbox.put(r)
        except Exception:  # stage errors must not kill the pipeline
            st.errors.append(traceback.format_exc())
        finally:
            st.finished += 1

    def _streams_after_caller(self):
        for st in self.stages:
            if st.stream is not None:
                st.stream.wait_stream(torch.cuda.current_stream(
                    st.stream.device))

    def _caller_after_streams(self):
        for st in self.stages:
            if st.stream is not None:
                torch.cuda.current_stream(st.stream.device).wait_stream(
                    st.stream)

    # ------------------------------------------------------------ threaded

    def _worker(self, st: Stage):
        if st.stream is not None:
            torch.cuda.set_stream(st.stream)
        while True:
            try:
                item = st.inbox.get()
            except Closed:
                if st.outbox is not None:
                    st.outbox.close()
                return
            self._run(st, item)

    def start(self):
        if self.deterministic:
            raise RuntimeError("a deterministic pipeline has no threads; "
                               "feed() drains it")
        self._running = True
        self._streams_after_caller()
        for st in self.stages:
            st.thread = threading.Thread(target=self._worker, args=(st,),
                                         daemon=True, name=st.name)
            st.thread.start()

    def stop(self, timeout: float = 30.0):
        """Close the first inbox and join every stage thread (each drains
        its inbox, then closes the next).  Raises RuntimeError naming the
        stages whose thread is still alive after `timeout` seconds."""
        if self.stages:
            self.stages[0].inbox.close()
        alive = []
        for st in self.stages:
            if st.thread is not None:
                st.thread.join(timeout)
                if st.thread.is_alive():
                    alive.append(st.name)
        self._running = False
        self._caller_after_streams()
        if alive:
            raise RuntimeError(f"pipeline stages still running after "
                               f"stop({timeout}): {', '.join(alive)}")

    def quiesce(self, timeout: float = 120.0, settle: float = 0.05):
        """Block until every item pushed into a stage's inbox has been
        dropped or finished, polling every `settle` seconds (threaded mode;
        used to separate a warmup segment from a timed segment without
        tearing threads down).  Returns True if quiescent, False on
        timeout."""
        deadline = time.monotonic() + timeout
        while True:
            # upstream first: a stage counts an item finished only after
            # pushing its outputs into the next inbox
            if all(st.inbox.pushed - st.inbox.dropped == st.finished
                   for st in self.stages):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(settle)

    # -------------------------------------------------------- deterministic

    def drain(self):
        """Deterministic single-thread drain: run every queued item through
        the remaining stages in order."""
        self._streams_after_caller()
        for st in self.stages:
            while len(st.inbox) > 0:
                try:
                    item = st.inbox.get(timeout=0.0)
                except (Closed, TimeoutError):
                    break
                with _on_stream(st.stream):
                    self._run(st, item)
        self._caller_after_streams()

    def feed(self, item):
        self.stages[0].inbox.put(item)
        if self.deterministic:
            self.drain()
