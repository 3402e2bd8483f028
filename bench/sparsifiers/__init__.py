"""What the harness reads off the program's compressor state, one module
a sparsifier kind, found by the traffic's ``sparsifier.kind``:
``first_dense_gradient(ef)``, this rank's first dense gradient worked
out from its state after one step, or None where the state keeps none.
The reference's side of a kind is ``bench/reference/sparsifiers/``."""
