"""The reference's optimizers, one module each, found by the traffic's
``optimizer.kind``: ``HONOURS`` (as a sparsifier's) and ``Optimizer(
params, optimizer)`` with ``step(aggregate)``, which moves ``params`` in
place."""
