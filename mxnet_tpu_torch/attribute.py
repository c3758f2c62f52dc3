"""AttrScope (parity: python/mxnet/attribute.py:24, the same code as
``mxnet_tpu/attribute.py``): a with-scope that stamps attributes onto the
Symbol nodes created inside it."""
from __future__ import annotations

from typing import Dict, Optional

from .base import MXNetError, _ThreadLocalStack


class AttrScope:
    _stack = _ThreadLocalStack()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise MXNetError("AttrScope values must be strings")
        self._attr = kwargs

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        return current_attrs(attr)

    @staticmethod
    def current() -> "AttrScope":
        """The innermost scope entered, else an empty default one."""
        return AttrScope._stack.top() or _DEFAULT

    def __enter__(self):
        AttrScope._stack.push(self)
        return self

    def __exit__(self, *exc):
        AttrScope._stack.pop()


_DEFAULT = AttrScope()


def current_attrs(attr=None) -> Dict[str, str]:
    merged = {}
    for scope in AttrScope._stack.stack:
        merged.update(scope._attr)
    if attr:
        merged.update(attr)
    return merged
