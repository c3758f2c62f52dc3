"""NameManager (parity: python/mxnet/name.py): automatic unique names for
gluon blocks, the same counters as ``mxnet_tpu/name.py``."""
from __future__ import annotations

from typing import Dict, Optional

from .base import _ThreadLocalStack


class NameManager:
    _stack = _ThreadLocalStack()

    def __init__(self):
        self._counter: Dict[str, int] = {}

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    @staticmethod
    def current() -> "NameManager":
        top = NameManager._stack.top()
        if top is None:
            return _DEFAULT
        return top

    def __enter__(self):
        NameManager._stack.push(self)
        return self

    def __exit__(self, *exc):
        NameManager._stack.pop()


class Prefix(NameManager):
    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


_DEFAULT = NameManager()
