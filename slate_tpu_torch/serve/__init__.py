"""slate_tpu_torch.serve — the serving front door over the batched
drivers (:mod:`slate_tpu_torch.linalg.batched`): a request-batching
queue with (op, dtype, shape-bucket) buckets under a max-wait/max-batch
policy, one executable per (bucket, padded batch), futures back to the
caller, and a warm start from explicit specs.  See
:mod:`slate_tpu_torch.serve.queue` for the design.

Quick start (on the card; pass ``ServeConfig(device="cpu")`` to
:func:`get_server` on a host without one)::

    from slate_tpu_torch import serve

    serve.warm_start(specs=[{"op": "posv", "batch": 16, "dims": (256,)}])
    x = serve.submit("posv", spd, rhs).result()   # one (n, n) + (n,) problem
    serve.shutdown()

Importing this package starts no thread; the dispatcher thread starts on
the first submit and is a daemon.
"""

from .queue import (  # noqa: F401
    Backpressure, BatchQueue, ServeConfig, SUPPORTED_OPS, get_server,
    shutdown, submit, warm_start,
)
