"""Progress reporting with an ETA, and bnslib's small container and counter
surface (counterpart of ``gwkit/utils/progress.py``, copied: the same
names, output strings and thread and process semantics).

:class:`ProgressTracker` and :class:`Counter` are thread-safe;
:class:`MPCounter` and :class:`MPProgressTracker` share their count through
a ``multiprocessing.Value`` with worker processes that inherit it (fork, or
a Pool initializer's arguments), as bnslib's data preparation did.
"""
from __future__ import annotations

import multiprocessing as mp
import sys
import threading
import time


class ProgressTracker:
    def __init__(self, total: int, name: str = "Progress", steps: int = 25, out=sys.stderr):
        self.total = max(total, 1)
        self.name = name
        self.steps = steps
        self.out = out
        self.count = 0
        self.start = time.time()
        self._lock = threading.Lock()
        self._last_len = 0

    def iterate(self, n: int = 1, print_update: bool = True) -> None:
        with self._lock:
            self.count += n
            if print_update:
                self._print()

    def _print(self) -> None:
        frac = self.count / self.total
        filled = int(frac * self.steps)
        bar = "=" * filled + ">" + "." * (self.steps - filled - 1) if filled < self.steps else "=" * self.steps
        elapsed = time.time() - self.start
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        msg = f"\r{self.name}: [{bar}] {100*frac:5.1f}% | ETA {eta:6.0f}s"
        self.out.write(msg + " " * max(0, self._last_len - len(msg)))
        self._last_len = len(msg)
        if self.count >= self.total:
            self.out.write(f"\n{self.name}: done in {elapsed:.1f}s\n")
        self.out.flush()


class DictList:
    """Append-oriented dict-of-lists (the full bnslib.py:1750-1937 surface:
    append/extend/join/add/contains/pop/get/count/copy). Non-list values
    wrap into one-element lists on construction, like the reference; unlike
    the reference, ``join`` returns self so ``a + b`` works (the reference's
    ``__add__`` returns ``join``'s None — a latent bug not replicated)."""

    def __init__(self, dic=None):
        if dic is not None and not isinstance(dic, dict):
            raise TypeError("the input has to be a dict")
        self._dic = {
            k: (list(v) if isinstance(v, list) else [v])
            for k, v in (dic or {}).items()
        }

    def append(self, key, value=None) -> None:
        if isinstance(key, dict) and value is None:
            for k, v in key.items():
                self._dic.setdefault(k, []).append(v)
        else:
            self._dic.setdefault(key, []).append(value)

    def extend(self, other, value=None) -> None:
        if isinstance(other, (dict, DictList)):
            dic = other._dic if isinstance(other, DictList) else other
            for k, v in dic.items():
                self._dic.setdefault(k, []).extend(v)
        elif value is not None:
            self._dic.setdefault(other, []).extend(value)

    def join(self, other) -> "DictList":
        if isinstance(other, dict):
            other = DictList(other)
        if not isinstance(other, DictList):
            raise TypeError(
                f"can only join a dict or DictList, got {type(other)}")
        self.extend(other)
        return self

    def __add__(self, other) -> "DictList":
        return self.copy().join(other)

    def __radd__(self, other) -> "DictList":
        if isinstance(other, dict):
            other = DictList(other)
        if not isinstance(other, DictList):
            raise TypeError(
                f"can only add a dict or DictList, got {type(other)}")
        return other.copy().join(self)

    def copy(self) -> "DictList":
        out = DictList()
        out._dic = {k: list(v) for k, v in self._dic.items()}
        return out

    def count(self, item, keys=None):
        """Occurrences of ``item``: total over all keys (keys=None), or a
        per-key dict for keys='all' / an iterable of keys."""
        if keys is None:
            return sum(v.count(item) for v in self._dic.values())
        if isinstance(keys, str) and keys.lower() == "all":
            keys = list(self._dic)
        return {k: self._dic[k].count(item) if k in self._dic else 0 for k in keys}

    def as_dict(self):
        return dict(self._dic)

    def get(self, key, default=None):
        return self._dic.get(key, default)

    def pop(self, key, *default):
        return self._dic.pop(key, *default)

    def __getitem__(self, key):
        return self._dic[key]

    def __contains__(self, key):
        return key in self._dic

    def keys(self):
        return self._dic.keys()

    def values(self):
        return self._dic.values()

    def items(self):
        return self._dic.items()

    def __len__(self):
        return len(self._dic)


class Counter:
    """Thread-safe counter (bnslib MPCounter surface, bnslib.py:1939-1977)."""

    def __init__(self, val: int = 0):
        self._val = val
        self._lock = threading.Lock()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self._val += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._val


class MPCounter:
    """Process-safe counter on a shared ``mp.Value`` (bnslib.py:1939-1977):
    workers in an mp.Pool increment it, the parent reads ``.value``."""

    def __init__(self, val: int = 0):
        if not isinstance(val, int):
            raise TypeError("initial value has to be an integer")
        self._val = mp.Value("i", val)

    def increment(self, n: int = 1) -> None:
        with self._val.get_lock():
            self._val.value += n

    @property
    def value(self) -> int:
        return self._val.value

    def __add__(self, other):
        if isinstance(other, MPCounter):
            return MPCounter(self.value + other.value)
        if isinstance(other, int):
            return MPCounter(self.value + other)
        raise TypeError("can only add an int or MPCounter")

    def __iadd__(self, other):
        self.increment(other.value if isinstance(other, MPCounter) else int(other))
        return self

    def __eq__(self, other):
        if isinstance(other, MPCounter):
            return self.value == other.value
        if isinstance(other, int):
            return self.value == other
        raise TypeError("can only compare to int or MPCounter")


class MPProgressTracker(ProgressTracker):
    """Multiprocessing-safe progress tracker (bnslib.py:991-1103 surface):
    fork-inherited worker processes call ``iterate()`` on the shared
    counter; the owning process calls ``print_update()`` to render.
    Printing stays in one process — the shared state is just the count
    (mp.Value semantics: share through fork inheritance / Pool initializer
    args, not pickling)."""

    def __init__(self, total: int, name: str = "Progress", steps: int = 25, out=sys.stderr):
        super().__init__(total, name=name, steps=steps, out=out)
        self._shared = mp.Value("i", 0)

    def iterate(self, n: int = 1, print_update: bool = False) -> None:
        with self._shared.get_lock():
            self._shared.value += n
        if print_update:
            self.print_update()

    def print_update(self) -> None:
        with self._lock:
            self.count = self._shared.value
            self._print()

    @property
    def shared_count(self) -> int:
        return self._shared.value
