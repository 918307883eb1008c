"""Shared asyncio batching primitives for the serving tier.

The port's copy of gubernator_tpu/serve/aio.py with its imports
rewritten; the file references below are the reference package's.

Both micro-batchers — the device batcher (serve/batcher.py) and the peer
forwarding client (serve/peers.py) — coalesce queued work the same way:
the first item blocks, everything already enqueued drains immediately,
then an optional fixed window (the reference's BatchWait semantics,
peers.go:143-172) collects stragglers. The collect loop and its
cancellation-race handling live here so a fix lands in one place.
"""

from __future__ import annotations

import asyncio


async def pop_with_deadline(queue: "asyncio.Queue", timeout: float):
    """queue.get bounded by `timeout`; None on expiry. Race-safe where
    bare `wait_for(queue.get(), ...)` is not: when the window closes (or
    the caller is cancelled) just as an item arrives, the item is
    returned / handed back instead of silently dropped — a dropped
    item's caller would await its future forever. No await happens in the
    exception paths: while the getter is still PENDING, Queue.get keeps
    the item in the queue (it only pops at get_nowait after its waiter
    fires), so cancelling a pending getter loses nothing; only a DONE
    getter holds an item, and that is recovered synchronously.

    CAVEAT: the cancel-path hand-back uses put_nowait, which appends at
    the TAIL — the raced item loses its FIFO position behind later
    arrivals. Both current callers only cancel during teardown, where
    every queued item is failed regardless of order; a future caller
    that cancels mid-stream and cares about ordering must not reuse
    this helper as-is."""
    getter = asyncio.ensure_future(queue.get())
    try:
        return await asyncio.wait_for(asyncio.shield(getter), timeout)
    except asyncio.TimeoutError:
        if getter.done() and not getter.cancelled():
            return getter.result()  # raced: completed as the window shut
        getter.cancel()
        return None
    except asyncio.CancelledError:
        if getter.done() and not getter.cancelled():
            # hand the raced item back for the owner's cancel-drain loop
            queue.put_nowait(getter.result())
        else:
            getter.cancel()
        raise


#: poll period of collect_batch's hold_while phase — how long after the
#: hold condition clears a deep batch may still sit unflushed. Device
#: batch periods in deep mode are milliseconds, so 0.2ms of flush slack
#: is noise there while keeping the idle-transition latency tight.
HOLD_POLL_S = 0.0002


async def collect_batch(
    queue: "asyncio.Queue",
    limit: int,
    wait: float,
    into: list,
    weight=None,
    carry: list = None,
    hold_while=None,
) -> list:
    """Collect one coalesced batch INTO the caller's list (so a cancel
    mid-collect leaves the partial batch visible to the caller's drain
    handler — a local list would be lost with the exception). Blocks for
    the first item, drains everything already enqueued, then waits out
    the optional `wait` window for stragglers.

    `weight` (item -> int) makes `limit` count underlying units instead
    of queue items — the device batcher enqueues whole request GROUPS
    (one per RPC) and its limit is in requests. Groups are never split;
    a group that would push the batch PAST the limit is parked in
    `carry` (a persistent caller-owned list, drained first next round)
    so batches never exceed the limit — except a single group bigger
    than the limit, which ships alone (progress over strictness; the
    engine's ladder covers MAX_BATCH_SIZE, the per-RPC cap). Callers
    passing `weight` must pass `carry` and must drain it on teardown.

    `hold_while` (-> bool) is the deep-accumulation hook: after the
    drain and straggler phases, keep collecting toward `limit` for as
    long as the predicate holds. The device batcher passes "the submit
    gate is saturated" — while every pipeline slot is occupied a flush
    could not submit anyway, so accumulating costs zero latency and
    builds the deep batches that amortize per-batch fixed costs (the
    big-store writeback pass). The predicate is re-polled every
    HOLD_POLL_S; when it clears (a slot freed — the device is about to
    go idle) the batch flushes immediately, preserving the submit/wait
    overlap of host marshalling with device execution. With the
    predicate never true (default None), behavior is exactly the
    historical drain + wait semantics."""
    if weight is None:
        weight = lambda _i: 1  # noqa: E731
    total = 0
    if carry:
        item = carry.pop()
        into.append(item)
        total = weight(item)
    if not into:
        into.append(await queue.get())
        total = weight(into[-1])

    def take(item) -> bool:
        nonlocal total
        w = weight(item)
        if into and total + w > limit:
            carry.append(item)
            return False
        into.append(item)
        total += w
        return True

    def drain_ready() -> bool:
        """True while the batch can keep growing from queued items."""
        while total < limit:
            try:
                item = queue.get_nowait()
            except asyncio.QueueEmpty:
                return True
            if not take(item):
                return False
        return False

    if not drain_ready():
        return into
    if wait > 0:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait
        while total < limit:
            timeout = deadline - loop.time()
            if timeout <= 0:
                break
            item = await pop_with_deadline(queue, timeout)
            if item is None:
                break
            if not take(item):
                return into
    while (
        total < limit and hold_while is not None and hold_while()
    ):
        item = await pop_with_deadline(queue, HOLD_POLL_S)
        if item is not None and not take(item):
            return into
    return into
