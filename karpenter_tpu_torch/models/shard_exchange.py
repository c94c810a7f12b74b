"""The plain multi-shard arm of the slot-sharded pack scan (the plain
version of kernel K2's sharded form, `kernels/pack_scan.pack_scan_sharded`).

SPMD in one process: S threads each run `_pack_body` over their shard's
slots `[s * N_loc, (s + 1) * N_loc)` through a `ThreadExchange`. At each of
the reference's three exchange points (`gprefix`, `gsum`, `gany_slots`) a
shard gives its part and waits until every shard has given its own, then
reduces the parts in shard order. A shard that raises breaks the exchange
for every shard, and its error is raised again in the caller.
"""

from __future__ import annotations

import threading

import torch

from .scheduler_model_grouped import ItemTensors, SlotExchange, _i32, _pack_body
from .scheduler_model import SchedulerTensors

# a shard that waits this long at an exchange breaks it for every shard
EXCHANGE_TIMEOUT_S = 600.0


class ExchangeMismatch(RuntimeError):
    """The shards met at different exchanges: their control flow diverged."""


class BrokenExchange(RuntimeError):
    """Another shard raised, or an exchange waited past its time limit."""


class _Hub:
    """What the shards' threads share: two buffers of parts (a shard writes
    exchange e + 2's part only after every shard has read exchange e's) and
    the turn, passed from shard to shard in order. One shard's thread runs
    at a time: free-running threads would hand the interpreter lock back
    and forth on every small torch call (measured ~40x slower at eight
    shards on the CPU), so a shard hands the turn on when it reaches an
    exchange."""

    def __init__(self, n: int):
        self.n = n
        self.turn = [threading.Event() for _ in range(n)]
        self.parts = [[None] * n, [None] * n]
        self.broken = False
        self.turn[0].set()

    def pass_on(self, index: int) -> None:
        self.turn[(index + 1) % self.n].set()

    def wait_turn(self, index: int) -> None:
        ev = self.turn[index]
        if not ev.wait(EXCHANGE_TIMEOUT_S):
            self.abort()
            raise BrokenExchange(f"shard {index} waited {EXCHANGE_TIMEOUT_S} s at an exchange")
        ev.clear()
        if self.broken:
            raise BrokenExchange(f"shard {index}: another shard raised")

    def abort(self) -> None:
        self.broken = True
        for ev in self.turn:
            ev.set()


class ThreadExchange(SlotExchange):
    """One shard's exchange in the plain multi-shard arm: each reduction
    writes the shard's part and waits until every shard has given its part
    (the turn comes back to it after the last shard's), then reduces the
    parts in shard order (int64 partial sums, wrapped to int32 as the
    reference's int32 sums wrap). `seq` counts the exchanges so far."""

    def __init__(self, hub: _Hub, index: int, count: int):
        self.hub = hub
        self.index = index
        self.count = count
        self.seq = 0

    def _exchange(self, kind: str, part) -> list:
        seq = self.seq
        buf = self.hub.parts[seq & 1]
        buf[self.index] = (kind, seq, part)
        self.seq += 1
        self.hub.pass_on(self.index)
        self.hub.wait_turn(self.index)
        if any(p is None or p[0] != kind or p[1] != seq for p in buf):
            raise ExchangeMismatch(f"shard {self.index} at {kind} #{seq}, the shards at "
                                   f"{[p[:2] if p else None for p in buf]}")
        return [p[2] for p in buf]

    def gprefix(self, v):
        local = torch.cumsum(v, 0, dtype=torch.int64)
        total = local[-1] if local.numel() else torch.zeros((), dtype=torch.int64, device=v.device)
        totals = self._exchange("gprefix", total)
        offset = sum((x.to(v.device) for x in totals[: self.index]), torch.zeros((), dtype=torch.int64, device=v.device))
        return _i32(local - v + offset)

    def gsum(self, v):
        parts = self._exchange("gsum", v.sum(dtype=torch.int64))
        return _i32(sum(x.to(v.device) for x in parts))

    def gany_slots(self, m):
        parts = self._exchange("gany_slots", m.any(dim=0))
        return torch.stack([x.to(m.device) for x in parts]).any(dim=0)

    def finish(self) -> None:
        """The last exchange: every shard ended its scan at the same point."""
        self._exchange("done", None)
        self.hub.pass_on(self.index)


def run_shards(fn, n: int) -> list:
    """Run fn(exchange) in n threads, one per shard, through one hub;
    returns their results in shard order. A shard that raises breaks the
    exchange, so every other shard raises too; the first shard's own error
    is raised again here."""
    hub = _Hub(n)
    results: list = [None] * n
    errors: list = [None] * n

    def body(s: int) -> None:
        ex = ThreadExchange(hub, s, n)
        try:
            hub.wait_turn(s)
            results[s] = fn(ex)
            ex.finish()
        except BaseException as e:  # noqa: BLE001  # solverlint: ok(swallowed-exception): kept in errors[s] and raised again by run_shards in the caller's thread
            errors[s] = e
            hub.abort()

    threads = [threading.Thread(target=body, args=(s,), name=f"shard-{s}", daemon=True) for s in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    raised = [e for e in errors if e is not None]
    if raised:
        raise next((e for e in raised if not isinstance(e, BrokenExchange)), raised[0])
    return results


def pack_scan_sharded_plain(t: SchedulerTensors, items: ItemTensors, compat, key, *, n_slots: int, n_shards: int):
    """The slot-sharded scan from the initial carry: n_shards threads each
    run `_pack_body` over their slots through a `ThreadExchange`. Returns
    (takes [W, N], leftovers [W], the shards' carries, barrier): `barrier`
    (0-d int32) counts the shards' arrivals at exchanges, S per exchange,
    as the kernel's barrier counter does (this arm exchanges at every
    reduction; the kernel skips a take total its closed form gives)."""
    if n_slots % n_shards:
        raise ValueError(f"pack_scan_sharded: {n_slots} slots do not split into {n_shards} shards")

    def shard(ex):
        out = _pack_body(t, items, n_slots=n_slots, precomputed=(compat, key), exchange=ex)
        return out, ex.seq

    outs = run_shards(shard, n_shards)
    takes = torch.cat([o[0] for o, _seq in outs], dim=1)
    barrier = torch.tensor(sum(seq for _o, seq in outs), dtype=torch.int32)
    return takes, outs[0][0][1], tuple(o[2] for o, _seq in outs), barrier
