"""ROADMAP C.17: one device's ``Bufalloc`` arena under several threads.

The port's host runtime calls a device's allocator from several threads
at once: lazy buffers allocate on first use on a queue's workers, the
co-executor releases a launch's throwaway buffers on a worker while the
next launch allocates, and each serving replica's engine takes KV pages
from the device's pool while its dispatch queue's two workers run.
``Bufalloc`` itself holds no lock (``runtime/bufalloc.py`` is a byte copy
of the reference's), so the device serializes every call into its arena.

Here threads hammer one CPU device's ``create_buffer``/``release`` (the
arena directly) and one ``BufferPool`` over the same arena (its misses
and overflowing frees reach the arena) with ``sys.setswitchinterval(1e-6)``,
which makes the interpreter switch threads between almost every
bytecode.  Every thread must finish without an error, and the arena must
end empty and consistent.  Without the device's lock the unlocked arena
raises "double free" or corrupts its chunk list.
"""

import random
import sys
import threading
import time

import pytest

from repro_torch.runtime import BufferPool, Platform, create_buffer

THREADS = 12                # half on the arena, half through the pool
OPS = 8000                  # per thread
TIME_LIMIT_S = 20.0         # the whole test, threads joined


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _buffers(dev, seed, errors, deadline):
    rnd = random.Random(seed)
    live = []
    try:
        for _ in range(OPS):
            if time.monotonic() > deadline:
                break
            if live and (len(live) > 8 or rnd.random() < 0.5):
                live.pop(rnd.randrange(len(live))).release()
            else:
                live.append(create_buffer(dev, rnd.randint(1, 64),
                                          "float32"))
        for b in live:
            b.release()
    except BaseException as e:           # reported by the test body
        errors.append(e)


def _pool(pool, seed, errors, deadline):
    rnd = random.Random(seed)
    live = []
    try:
        for _ in range(OPS):
            if time.monotonic() > deadline:
                break
            if live and (len(live) > 8 or rnd.random() < 0.5):
                pool.free(live.pop(rnd.randrange(len(live))))
            else:
                live.append(pool.alloc(rnd.randint(1, 4096)))
        for c in live:
            pool.free(c)
    except BaseException as e:
        errors.append(e)


def test_one_device_arena_under_threads(fast_switching):
    dev = Platform(torch_device="cpu").get_devices("vector")[0]
    # no free list: every pool alloc and free reaches the arena
    pool = BufferPool(dev.allocator, min_class=64, max_free_per_class=0)
    errors = []
    t0 = time.monotonic()
    deadline = t0 + TIME_LIMIT_S - 2.0
    threads = [threading.Thread(target=_buffers if i % 2 else _pool,
                                args=(dev if i % 2 else pool, i, errors,
                                      deadline))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.1, t0 + TIME_LIMIT_S - time.monotonic()))
    assert not any(t.is_alive() for t in threads), \
        f"threads still running after {TIME_LIMIT_S} s"
    assert not errors, errors[:3]
    pool.trim()
    arena = dev.allocator
    assert arena.allocated_bytes() == 0
    arena.check_invariants()
    assert arena.n_allocs == arena.n_frees > 0
