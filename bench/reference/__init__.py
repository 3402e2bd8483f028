"""The benchmark's plain PyTorch reference of a training cell: a model
family and its loss (``models/<family>.py``), a sparsifier's exchange
(``sparsifiers/<kind>.py``), an optimizer (``optimizers/<kind>.py``),
the linear layers' precision (``linear``), and the first steps of a
cell followed on one card (``follow``). The harness finds each module
by the name in the cell's files. It imports nothing of the program
under test, of ``jax`` or of the JAX package."""
