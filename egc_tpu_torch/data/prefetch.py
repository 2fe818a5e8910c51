"""Bounded thread-pool prefetch for host-side batch builders (counterpart
of ``egc_tpu.data.prefetch``).

Yields ``builder(*args)`` results in order with up to ``workers`` builds
in flight, so host work (padding, kernel plans) overlaps the device's
steps. Builders stay on the host: the consumer moves each item to the
device (``GraphLoader`` does, with pinned memory and non-blocking copies).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


def prefetched(builder: Callable, args_iter: Iterable[tuple],
               workers: int) -> Iterator:
    if not workers:
        for args in args_iter:
            yield builder(*args)
        return
    with ThreadPoolExecutor(workers) as ex:
        futs = deque()
        it = iter(args_iter)
        for args in it:
            futs.append(ex.submit(builder, *args))
            if len(futs) >= workers:
                break
        while futs:
            item = futs.popleft().result()
            try:
                futs.append(ex.submit(builder, *next(it)))
            except StopIteration:
                pass
            yield item
