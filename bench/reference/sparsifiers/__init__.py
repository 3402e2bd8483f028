"""The reference's sparsifiers, one module each, found by the traffic's
``sparsifier.kind``: ``HONOURS`` (each sparsifier key it follows, with
the values it follows or None for any), ``Worker(j, sparsifier, omega,
device)`` with ``compress(g)`` -> a payload and ``observe(aggregate)``,
and ``combine(payloads, j, device)`` -> the aggregate."""
