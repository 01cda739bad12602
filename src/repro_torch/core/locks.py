"""Global-lock and read-write-lock baselines (the paper's Fig. 1/2 rivals).

``LockDS`` serializes every operation through one mutex.  ``RWLockDS`` takes
the lock in read mode for read-only methods and in write mode otherwise —
the conventional alternative the paper compares against in §3.3.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Set


class LockDS:
    def __init__(self, ds):
        self._ds = ds
        self._lock = threading.Lock()

    def execute(self, method: str, input: Any = None) -> Any:
        with self._lock:
            return self._ds.apply(method, input)


class RWLock:
    """A writer-preference readers-writer lock built on a condition var."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting > 0:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers > 0:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class RWLockDS:
    def __init__(self, ds, read_only: Set[str]):
        self._ds = ds
        self._rw = RWLock()
        self._read_only = read_only

    def execute(self, method: str, input: Any = None) -> Any:
        if method in self._read_only:
            self._rw.acquire_read()
            try:
                return self._ds.apply(method, input)
            finally:
                self._rw.release_read()
        else:
            self._rw.acquire_write()
            try:
                return self._ds.apply(method, input)
            finally:
                self._rw.release_write()
