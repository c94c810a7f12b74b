"""Fixed-capacity ring buffer (reference: pkg/utils/ringbuffer/ringbuffer.go)."""

from __future__ import annotations

from typing import Generic, TypeVar

T = TypeVar("T")


class RingBuffer(Generic[T]):
    def __init__(self, capacity: int):
        self._capacity = capacity
        self._items: list[T] = []
        self._head = 0  # insert position once full

    def insert(self, item: T) -> None:
        if len(self._items) < self._capacity:
            self._items.append(item)
            return
        self._items[self._head] = item
        self._head = (self._head + 1) % self._capacity

    def items(self) -> list[T]:
        """Chronological order, oldest first (once full, _head is the oldest)."""
        if len(self._items) < self._capacity:
            return list(self._items)
        return self._items[self._head :] + self._items[: self._head]

    def __len__(self) -> int:
        return len(self._items)

    def reset(self) -> None:
        self._items.clear()
        self._head = 0
